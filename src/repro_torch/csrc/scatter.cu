// scatter_rows: masked row scatter (or scatter-add) into the value plane, in place.
//
// Replaces the TPU kernel scatter_rows (src/repro/kernels/scatter.py:37),
// both add=False and add=True: values[rows[i]] (+)= updates[i] where
// mask[i].  Rows outside [0, R) are dropped, as the reference's
// mode="drop" scatter drops them.
//
// Bound: bytes: per masked lane, one update row read and one value row
// written (and read too for add).  One warp per lane copies the row with
// consecutive lanes on consecutive floats, one coalesced 128-byte
// transaction at V=32.  Masked-out lanes do not write at all, so the TPU
// kernel's masked-out-first sort (which kept its no-op rewrites from
// clobbering real writes) is not needed.  Masked rows are unique by
// precondition, so there are no atomics.  The add is __fadd_rn, a plain
// rounded float32 add, as in the reference.
#include "hkv_common.cuh"

namespace {

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
scatter_rows_kernel(float* __restrict__ values, const int64_t* __restrict__ rows,
                    const float* __restrict__ updates, const bool* __restrict__ mask,
                    int64_t n, int64_t num_rows, int64_t d, int add) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (i >= n || !mask[i]) return;
  const int64_t r = rows[i];
  if (r < 0 || r >= num_rows) return;
  float* dst = values + r * d;
  const float* src = updates + i * d;
  if (add) {
    for (int64_t c = lane; c < d; c += hkv::kWarp) dst[c] = __fadd_rn(dst[c], src[c]);
  } else {
    for (int64_t c = lane; c < d; c += hkv::kWarp) dst[c] = src[c];
  }
}

}  // namespace

extern "C" int hkv_scatter_rows(void* values, const void* rows, const void* updates,
                                const void* mask, int64_t n, int64_t num_rows, int64_t d,
                                int add, void* stream) {
  scatter_rows_kernel<<<hkv::blocks_for_warps(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<const int64_t*>(rows),
      static_cast<const float*>(updates), static_cast<const bool*>(mask), n, num_rows, d, add);
  return static_cast<int>(cudaGetLastError());
}
