// update_scan: the fused gradient step of an HKV table, one warp per query.
//
// Replaces the TPU kernels update_scan_tlp and update_scan_pipeline
// (src/repro/kernels/update_scan.py:121 and :282), which compute the same
// function on two TPU schedules.  Per query: digest pre-filter and full-key
// confirm over bucket1, then bucket2 only on a miss (hit1 wins); the lane's
// qvalid flag gates the match; on a hit the warp reads the full value row
// [dim | aux] at bucket*128+slot, applies the sparse optimizer (sgd, sgdm,
// rowwise_adagrad or adagrad, a template parameter) and writes the row back.
// A miss, or a lane with qvalid == 0, writes nothing.
//
// Query keys are unique within a launch (the caller dedupes and sums the
// gradients first), so distinct queries touch distinct rows and the warps
// need no ordering.  The TPU kernel serialised every row read-modify-write
// because its miss lanes rewrote row b1*128+0 unchanged; here they do not
// write at all.
//
// Rounding: every operation is one IEEE-rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), in the order of the
// reference's SparseOptimizer.apply, so nvcc cannot contract a product and
// a sum into an FMA and the result equals the plain PyTorch version
// (repro_torch/embedding/sparse_opt.py) bit for bit.  rowwise_adagrad's row
// mean sums the squared gradients in one fixed order: each lane first
// halves its own columns (d, d+32, d+64, ... of the dim columns zero-padded
// to a power of two), then a __shfl_xor_sync butterfly with offsets
// 16, 8, 4, 2, 1 finishes the same halving tree the plain version takes.
//
// Bound on this card: bytes.  A query needs the 128-byte digest line of
// each probed row, the keys whose digest matched, its bucket, digest, key,
// flag and dim gradient floats, and on a hit the V-float row read and
// written; a few dozen flops a row are nothing beside that.  Each access is
// a dependent random read, so, as in find_scan, latency is hidden only by
// the warps in flight.  Rows of V = 33 floats (rowwise_adagrad at dim 32)
// are 132 bytes, so lanes read single floats; row offsets are 64-bit
// (2^27 rows of 33 floats pass 2^31).
#include "hkv_common.cuh"

namespace {

constexpr int kSgd = 0;
constexpr int kSgdm = 1;
constexpr int kRowwiseAdagrad = 2;
constexpr int kAdagrad = 3;
constexpr int kMaxCols = 8;  // columns a lane holds: dim <= 256

template <int kOpt>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
update_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                   float* __restrict__ values, const int64_t* __restrict__ bucket1,
                   const int64_t* __restrict__ bucket2, const uint8_t* __restrict__ qdigest,
                   const int64_t* __restrict__ qkeys, const bool* __restrict__ qvalid,
                   const float* __restrict__ grads, int32_t* __restrict__ found,
                   int64_t n, int64_t v, int dim, int cols, int use_digest, float lr,
                   float eps, float momentum) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (q >= n) return;  // whole warps leave together
  int slot = -1;
  int64_t b = bucket1[q];
  if (qvalid[q]) {
    const int64_t qk = qkeys[q];
    const uint32_t qd = qdigest[q];
    slot = hkv::warp_match_row(digests, keys, b, qd, qk, use_digest, lane);
    const int64_t b2 = bucket2[q];
    if (slot < 0 && b2 != b) {
      slot = hkv::warp_match_row(digests, keys, b2, qd, qk, use_digest, lane);
      b = b2;
    }
  }
  if (lane == 0) found[q] = slot >= 0 ? 1 : 0;
  if (slot < 0) return;  // a miss or a gated lane writes nothing

  float* row = values + (b * hkv::kSlots + slot) * v;
  const float* g_row = grads + q * static_cast<int64_t>(dim);
  float g[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int d = lane + hkv::kWarp * k;
    g[k] = (k < cols && d < dim) ? g_row[d] : 0.0f;
  }

  if constexpr (kOpt == kRowwiseAdagrad) {
    // mean of g*g over the dim columns: the halving tree, lane-local halves
    // first (cols is a power of two), then the warp butterfly
    float sq[kMaxCols];
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) sq[k] = __fmul_rn(g[k], g[k]);
#pragma unroll
    for (int h = kMaxCols / 2; h >= 1; h /= 2) {
      if (h < cols) {
#pragma unroll
        for (int k = 0; k < h; ++k) sq[k] = __fadd_rn(sq[k], sq[k + h]);
      }
    }
    float sum = sq[0];
#pragma unroll
    for (int off = hkv::kWarp / 2; off >= 1; off /= 2)
      sum = __fadd_rn(sum, __shfl_xor_sync(hkv::kFullMask, sum, off));
    const float acc = __fadd_rn(row[dim], __fdiv_rn(sum, static_cast<float>(dim)));
    const float step = __fdiv_rn(lr, __fadd_rn(__fsqrt_rn(acc), eps));
    __syncwarp();  // every lane has read row[dim] before lane 0 rewrites it
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int d = lane + hkv::kWarp * k;
      if (k < cols && d < dim) row[d] = __fsub_rn(row[d], __fmul_rn(step, g[k]));
    }
    if (lane == 0) row[dim] = acc;
  } else {
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int d = lane + hkv::kWarp * k;
      if (k >= cols || d >= dim) continue;
      const float e = row[d];
      if constexpr (kOpt == kSgd) {
        row[d] = __fsub_rn(e, __fmul_rn(lr, g[k]));
      } else if constexpr (kOpt == kSgdm) {
        const float m = __fadd_rn(__fmul_rn(momentum, row[dim + d]), g[k]);
        row[d] = __fsub_rn(e, __fmul_rn(lr, m));
        row[dim + d] = m;
      } else {  // adagrad: (lr * g) / (sqrt(acc) + eps), the product first
        const float acc = __fadd_rn(row[dim + d], __fmul_rn(g[k], g[k]));
        row[d] = __fsub_rn(e, __fdiv_rn(__fmul_rn(lr, g[k]), __fadd_rn(__fsqrt_rn(acc), eps)));
        row[dim + d] = acc;
      }
    }
  }
}

}  // namespace

extern "C" int hkv_update_scan(const void* digests, const void* keys, void* values,
                               const void* bucket1, const void* bucket2, const void* qdigest,
                               const void* qkeys, const void* qvalid, const void* grads,
                               void* found, int64_t n, int64_t v, int dim, int opt,
                               int use_digest, float lr, float eps, float momentum,
                               void* stream) {
  // columns a lane holds: the dim columns padded to a power of two, over 32
  int p = 1;
  while (p < dim) p *= 2;
  const int cols = p > hkv::kWarp ? p / hkv::kWarp : 1;
  if (dim < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(hkv::blocks_for_warps(n)), block(hkv::kWarp * hkv::kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
        static_cast<float*>(values), static_cast<const int64_t*>(bucket1),
        static_cast<const int64_t*>(bucket2), static_cast<const uint8_t*>(qdigest),
        static_cast<const int64_t*>(qkeys), static_cast<const bool*>(qvalid),
        static_cast<const float*>(grads), static_cast<int32_t*>(found), n, v, dim, cols,
        use_digest, lr, eps, momentum);
  };
  switch (opt) {
    case kSgd: launch(update_scan_kernel<kSgd>); break;
    case kSgdm: launch(update_scan_kernel<kSgdm>); break;
    case kRowwiseAdagrad: launch(update_scan_kernel<kRowwiseAdagrad>); break;
    case kAdagrad: launch(update_scan_kernel<kAdagrad>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
