// scatter_rows: masked row scatter (or scatter-add) into the value plane, in place.
//
// Replaces the TPU kernel scatter_rows (src/repro/kernels/scatter.py:37),
// both add=False and add=True: values[rows[i]] (+)= updates[i] where
// mask[i].  Rows outside [0, R) are dropped, as the reference's
// mode="drop" scatter drops them.
//
// Bound: bytes: per masked lane, one update row read and one value row
// written (and read too for add).  A warp a lane would make three
// dependent trips to device memory (mask, then the row index, then the
// update row) to move one row, ~124 waves of them at 2^20 lanes: bound by
// the latency of its index loads, not by bytes.  So one warp owns a group
// of 32 lanes:
//   - it loads the group's mask and row indices with one coalesced load
//     each, unconditionally, and a ballot gives the rows to write;
//   - the group's update rows are contiguous in `updates`, so the warp
//     reads them as one flat coalesced stream: the lanes take the group's
//     elements in turn, each finds its row j and column c, and gets row
//     j's index with a shuffle.  Eight elements a lane are loaded (and,
//     for add, the destination read) before any is stored, so a group
//     costs one round trip for the indices and about one for its rows,
//     with every lane busy whatever the width;
//   - elements are copy units of 16 bytes where the row's bytes are a
//     multiple of 16 and both the plane and the updates are 16-byte
//     aligned, else 4 bytes, or 2 for a bfloat16 row of odd width (the
//     wrapper decides).  V = 33, the training path's rowwise_adagrad plane,
//     takes 4-byte units with no idle lane.  Its 132-byte rows end inside
//     32-byte sectors, and the partial sectors' stores cost more than the
//     rest of the kernel (on an H100, index_fill_ of the same rows, which
//     reads nothing, takes most of the time at V = 33 and a small part at
//     V = 32).
// Masked-out lanes and rows outside the plane write nothing and read no
// update, so the TPU kernel's masked-out-first sort (which kept its no-op
// rewrites from clobbering real writes) is not needed.  Masked rows are
// unique by precondition, so there are no atomics.  Without add a unit is
// copied as it is, bit for bit.  The add takes each element of a unit
// apart: float32 adds with __fadd_rn, a plain rounded float32 add as in
// the reference; bfloat16 adds in float32 and rounds once to bfloat16
// (__float2bfloat16_rn), which is the correctly rounded bfloat16 sum (a
// float32 sum of two bfloat16 values rounded again to bfloat16 suffers no
// double-rounding error, as 24 >= 2 * 8 + 2), so it equals index_add_ on
// unique rows.  Offsets are 64-bit: config B's plane passes 2^31 floats.
#include "hkv_common.cuh"

namespace {

constexpr int kUnroll = 8;   // elements a lane has in flight

// The elementwise rounded sum of two units of E elements each.
template <typename E, typename U>
__device__ __forceinline__ U add_rn(U a, U b) {
  constexpr int k = sizeof(U) / sizeof(E);
  const E* x = reinterpret_cast<const E*>(&a);
  const E* y = reinterpret_cast<const E*>(&b);
  U s;
  E* z = reinterpret_cast<E*>(&s);
#pragma unroll
  for (int i = 0; i < k; ++i)
    z[i] = hkv::from_float<E>(__fadd_rn(hkv::to_float(x[i]), hkv::to_float(y[i])));
  return s;
}

// T is the copy unit (uint4, uint32_t or uint16_t) and E the element
// (float or bf16); w is the row width in T.
template <typename T, typename E>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
scatter_rows_kernel(T* __restrict__ values, const int64_t* __restrict__ rows,
                    const T* __restrict__ updates, const bool* __restrict__ mask,
                    int64_t n, int64_t num_rows, int w, int add) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kWarp;
  if (i0 >= n) return;
  const int cnt = static_cast<int>(n - i0 < hkv::kWarp ? n - i0 : hkv::kWarp);
  int64_t r = 0;
  bool ok = false;
  if (lane < cnt) {
    const bool m = mask[i0 + lane];
    r = rows[i0 + lane];
    ok = m && r >= 0 && r < num_rows;
  }
  const unsigned okbits = __ballot_sync(hkv::kFullMask, ok);
  if (okbits == 0) return;
  const int64_t dst_row = r * w;               // this lane's row offset, in T
  const T* __restrict__ src = updates + i0 * w;
  const int total = cnt * w;                   // the group's elements
  // element e = base + t*32 + lane lies in row j, column c; each step of
  // 32 elements moves (j, c) by (dj, dc)
  int j = lane / w, c = lane % w;
  const int dj = hkv::kWarp / w, dc = hkv::kWarp % w;
  for (int base = 0; base < total; base += hkv::kWarp * kUnroll) {
    T u[kUnroll], d[kUnroll];
    int64_t off[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int e = base + t * hkv::kWarp + lane;
      const int jj = j & (hkv::kWarp - 1);     // j passes 31 only where e >= total
      off[t] = __shfl_sync(hkv::kFullMask, dst_row, jj) + c;
      live[t] = e < total && ((okbits >> jj) & 1u);
      if (live[t]) {
        u[t] = src[e];
        if (add) d[t] = values[off[t]];
      }
      c += dc;
      j += dj;
      if (c >= w) {
        c -= w;
        ++j;
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t)
      if (live[t]) values[off[t]] = add ? add_rn<E>(d[t], u[t]) : u[t];
  }
}

}  // namespace

extern "C" int hkv_scatter_rows(void* values, const void* rows, const void* updates,
                                const void* mask, int64_t n, int64_t num_rows, int64_t row_bytes,
                                int add, int elem_bytes, int unit, void* stream) {
  if (unit <= 0 || row_bytes % unit != 0 || unit < elem_bytes ||
      (elem_bytes != 4 && elem_bytes != 2) || row_bytes / unit > (int64_t{1} << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = hkv::blocks_for_warps((n + hkv::kWarp - 1) / hkv::kWarp);
  const int threads = hkv::kWarp * hkv::kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = hkv::with_unit(unit, [&](auto u) {
    using T = decltype(u);
    auto launch = [&](auto kernel) {
      kernel<<<blocks, threads, 0, s>>>(
          static_cast<T*>(values), static_cast<const int64_t*>(rows),
          static_cast<const T*>(updates), static_cast<const bool*>(mask), n, num_rows,
          static_cast<int>(row_bytes / unit), add);
    };
    if constexpr (sizeof(T) >= sizeof(float)) {
      if (elem_bytes == 4) {
        launch(scatter_rows_kernel<T, float>);
        return;
      }
    }
    launch(scatter_rows_kernel<T, hkv::bf16>);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}
