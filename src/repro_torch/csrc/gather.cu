// gather_rows: masked, position-addressed row gather from the value plane.
//
// Replaces the TPU kernel gather_rows (src/repro/kernels/gather.py:34):
// out[i] = mask[i] ? values[rows[i], :width] : 0, rows clipped into the
// plane (as the reference's wrapper clips them).  It is the evicted-value
// hand-off of insert_and_evict, the post-op readback of find_or_insert
// (lookup_train's rows: width = dim, so the V = 33 training plane gives
// 128-byte rows without its accumulator column), and the value stage of
// find/find_rows at a caller's locate.
//
// Bound on this card: bytes.  Per masked lane `width` columns are read and
// written; a masked-off lane reads nothing and writes a zero row; the
// indices and the mask are read once.  There is no arithmetic.  A warp a
// row would make three dependent trips to device memory (mask, then the
// row index, then the row) to move one row, with three quarters of its
// lanes idle on a 128-byte row.  So, as in scatter.cu, one warp owns a
// group of 32 output rows:
//   - it loads the group's mask and row indices with one coalesced load
//     each, and a ballot gives the rows to read;
//   - the group's output rows are contiguous in `out`, so the warp writes
//     them as one flat coalesced stream: the lanes take the group's
//     elements in turn, each finds its row j and column c, and gets row
//     j's index with a shuffle.  Eight elements a lane are loaded before
//     any is stored, so a group costs one round trip for the indices and
//     about one for its rows, with every lane busy whatever the width;
//   - elements are copy units of 16 bytes where the plane's row stride,
//     the output row and both pointers allow it, else 4 or 2 bytes (the
//     wrapper decides).  The copy never looks at the element type, so
//     float32, bfloat16 and float16 planes are copied bit for bit.
// Offsets are 64-bit: at the paper's config B, row * V passes 2^31.
#include "hkv_common.cuh"

namespace {

constexpr int kUnroll = 8;   // elements a lane has in flight

// U is the copy unit; vu is the plane's row stride and w the output row
// width, both in U.
template <typename U>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
gather_rows_kernel(const U* __restrict__ values, const int64_t* __restrict__ rows,
                   const bool* __restrict__ mask, U* __restrict__ out, int64_t n,
                   int64_t num_rows, int64_t vu, int w) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kWarp;
  if (i0 >= n) return;  // whole warps leave together
  const int cnt = static_cast<int>(n - i0 < hkv::kWarp ? n - i0 : hkv::kWarp);
  int64_t r = 0;
  bool ok = false;
  if (lane < cnt) {
    ok = mask[i0 + lane];
    r = rows[i0 + lane];
    r = r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
  }
  const unsigned okbits = __ballot_sync(hkv::kFullMask, ok);
  const int64_t src_row = r * vu;              // this lane's row offset, in U
  U* __restrict__ dst = out + i0 * w;
  const int total = cnt * w;                   // the group's elements
  // element e = base + t*32 + lane lies in row j, column c; each step of
  // 32 elements moves (j, c) by (dj, dc)
  int j = lane / w, c = lane % w;
  const int dj = hkv::kWarp / w, dc = hkv::kWarp % w;
  for (int base = 0; base < total; base += hkv::kWarp * kUnroll) {
    U x[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int e = base + t * hkv::kWarp + lane;
      const int jj = j & (hkv::kWarp - 1);     // j passes 31 only where e >= total
      const int64_t off = __shfl_sync(hkv::kFullMask, src_row, jj) + c;
      x[t] = U{};
      if (e < total && ((okbits >> jj) & 1u)) x[t] = values[off];
      c += dc;
      j += dj;
      if (c >= w) {
        c -= w;
        ++j;
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int e = base + t * hkv::kWarp + lane;
      if (e < total) dst[e] = x[t];
    }
  }
}

}  // namespace

extern "C" int hkv_gather_rows(const void* values, const void* rows, const void* mask,
                               void* out, int64_t n, int64_t num_rows, int64_t row_bytes,
                               int64_t width_bytes, int unit, void* stream) {
  // a group's elements are counted in int: 32 rows of width_bytes / unit
  if (unit <= 0 || row_bytes % unit != 0 || width_bytes % unit != 0 || width_bytes <= 0 ||
      width_bytes > row_bytes || width_bytes / unit > (int64_t{1} << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = hkv::blocks_for_warps((n + hkv::kWarp - 1) / hkv::kWarp);
  const unsigned threads = hkv::kWarp * hkv::kWarpsPerBlock;
  const bool ok = hkv::with_unit(unit, [&](auto u) {
    using U = decltype(u);
    gather_rows_kernel<U><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const U*>(values), static_cast<const int64_t*>(rows),
        static_cast<const bool*>(mask), static_cast<U*>(out), n, num_rows, row_bytes / unit,
        static_cast<int>(width_bytes / unit));
  });
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}
