// gather_rows: masked, position-addressed row gather from the value plane.
//
// Replaces the TPU kernel gather_rows (src/repro/kernels/gather.py:34):
// out[i] = mask[i] ? values[rows[i]] : 0.  It is the evicted-value
// hand-off of insert_and_evict, the post-op readback of find_or_insert,
// and the value stage of find/find_rows at a caller's locate.  The wrapper
// clips rows into the plane, as the reference's wrapper does.
//
// Bound on this card: bytes.  Per masked lane one value row is read and
// one written; a masked-off lane reads nothing and writes a zero row; the
// indices and the mask are read once.  There is no arithmetic.  One warp
// per output row, the same shape as scatter.cu: consecutive lanes move
// consecutive 16-byte words (float4) when the row width is a multiple of
// four floats and both planes are 16-byte aligned, so at V=32 a row is one
// 128-byte transaction each way.  Row offsets are 64-bit: at the paper's
// config B, row * V passes 2^31.  The rows are independent random reads,
// so latency is hidden only by the warps in flight.
#include "hkv_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
gather_rows_kernel(const T* __restrict__ values, const int64_t* __restrict__ rows,
                   const bool* __restrict__ mask, T* __restrict__ out, int64_t n,
                   int64_t width) {  // width: row length in units of T
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (i >= n) return;
  T* dst = out + i * width;
  if (mask[i]) {
    const T* src = values + rows[i] * width;
    for (int64_t c = lane; c < width; c += hkv::kWarp) dst[c] = src[c];
  } else {
    const T zero{};
    for (int64_t c = lane; c < width; c += hkv::kWarp) dst[c] = zero;
  }
}

}  // namespace

extern "C" int hkv_gather_rows(const void* values, const void* rows, const void* mask,
                               void* out, int64_t n, int64_t v, int vec4, void* stream) {
  const unsigned blocks = hkv::blocks_for_warps(n);
  const unsigned threads = hkv::kWarp * hkv::kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_rows_kernel<float4><<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(values), static_cast<const int64_t*>(rows),
        static_cast<const bool*>(mask), static_cast<float4*>(out), n, v / 4);
  } else {
    gather_rows_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(values), static_cast<const int64_t*>(rows),
        static_cast<const bool*>(mask), static_cast<float*>(out), n, v);
  }
  return static_cast<int>(cudaGetLastError());
}
