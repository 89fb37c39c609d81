// update_scan: the fused gradient step of an HKV table, a quarter warp per query.
//
// Replaces the TPU kernels update_scan_tlp and update_scan_pipeline
// (src/repro/kernels/update_scan.py:121 and :282), which compute the same
// function on two TPU schedules.  Per query: digest pre-filter and full-key
// confirm over bucket1, then bucket2 only on a miss (hit1 wins); the lane's
// qvalid flag gates the match; on a hit the group reads the value row
// [dim | aux] at bucket*128+slot, applies the sparse optimizer (sgd, sgdm,
// rowwise_adagrad or adagrad, a template parameter) and writes the row back.
// A miss, or a lane with qvalid == 0, writes nothing.  Any dim, and float32,
// bfloat16 or float16 values (the element type is a template parameter,
// chosen by the wrapper's dtype code, never by the element's size: the two
// 2-byte types round differently).
//
// Query keys are unique within a launch (the caller dedupes and sums the
// gradients first), so distinct queries touch distinct rows and the groups
// need no ordering.  The TPU kernel serialised every row read-modify-write
// because its miss lanes rewrote row b1*128+0 unchanged; here they do not
// write at all.
//
// Rounding: every operation is one IEEE-rounded float32 intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), in the order of
// the plain PyTorch version (repro_torch/embedding/sparse_opt.py), so nvcc
// cannot contract a product and a sum into an FMA; on a bfloat16 or float16
// plane each result is rounded to the plane's type (nearest even) exactly
// where the plain version's tensor op of that type rounds it, and each
// Python scalar is what torch makes of it there (lr and dim rounded to the
// plane's type where _div fills a tensor with them; lr, eps and momentum
// float32 in a product or sum).  So kernel and plain version agree bit for
// bit at all three dtypes.
// rowwise_adagrad's row mean sums the squared gradients in one fixed order,
// the plain version's halving tree over the dim columns zero-padded to a
// power of two P.  Lane g of a group owns columns g, g+8, g+16, ..., so the
// halvings down to 8 columns pair a lane's own columns: the lane halves
// its columns locally, then a __shfl_xor_sync butterfly (4, 2, 1) within
// the group finishes the tree (below 8 columns it adds exact zeros).  Up to
// dim 32 a lane holds its four gradient columns in registers.  Wider, it
// keeps the order without holding the row: the halving tree over the
// lane's P/8 columns is the adjacent-pair tree over them in bit-reversed
// order, which a stack of log2(P/8) partial sums takes in one pass; the
// update then reads the gradient row again (from cache).
//
// Bound on this card: bytes.  A query needs its 128-byte digest line of
// each probed row, the keys whose digest matched, its bucket, digest, key,
// flag and dim gradient elements, and on a hit the V-element row read and
// written; a few dozen flops a row are nothing beside that.  Each access is
// a dependent random read, so, as in find_scan, latency is hidden only by
// the queries in flight: a group of 8 lanes serves a query
// (hkv::group_match_row, the probe find_scan and upsert_probe use), four
// queries a warp; and a lane loads four of its columns before it computes
// on any, so a wide row keeps four loads in flight a lane instead of one
// round trip a column.  Rows of V = 33 floats (rowwise_adagrad at dim 32) are
// 132 bytes, so lanes move single elements; row offsets are 64-bit (2^27
// rows of 33 floats pass 2^31).
#include "hkv_common.cuh"

namespace {

constexpr int kSgd = 0;
constexpr int kSgdm = 1;
constexpr int kRowwiseAdagrad = 2;
constexpr int kAdagrad = 3;
// rowwise_adagrad holds a lane's gradient columns in registers up to this
// many (dim <= 32); wider rows stream
constexpr int kRegTiles = 4;
// columns a lane loads before it computes on any (a streamed row's loads in
// flight): gradient, value and aux element of each column; the gradient
// alone in rowwise_adagrad's sum pass
constexpr int kChunk = 4;
constexpr int kSumChunk = 8;
// a streamed row has a power of two of tiles past kRegTiles
static_assert((2 * kRegTiles) % kSumChunk == 0, "kSumChunk must divide a streamed row's tiles");

// x rounded to T and back: the identity for float32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return hkv::to_float(hkv::from_float<T>(x));
}

template <int kOpt, typename T>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
update_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                   T* __restrict__ values, const int64_t* __restrict__ bucket1,
                   const int64_t* __restrict__ bucket2, const uint8_t* __restrict__ qdigest,
                   const int64_t* __restrict__ qkeys, const bool* __restrict__ qvalid,
                   const T* __restrict__ grads, int32_t* __restrict__ found, int64_t n,
                   int64_t v, int dim, int tiles, int levels, int use_digest, float lr,
                   float eps, float momentum) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int g = lane % hkv::kGroup;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kGroupsPerWarp;
  if (q0 >= n) return;  // whole warps leave together
  const int64_t q = q0 + lane / hkv::kGroup;
  const bool in = q < n;
  // the inputs in one round trip; the gate applies to the probe
  const bool active = in && qvalid[q];
  const int64_t qk = in ? qkeys[q] : 0;
  const uint32_t qd = in ? qdigest[q] : 0u;
  const int64_t b1 = in ? bucket1[q] : 0;
  const int64_t b2 = in ? bucket2[q] : 0;
  int slot = hkv::group_match_row(digests, keys, b1, qd, qk, use_digest, active, lane);
  const bool second = active && slot < 0 && b2 != b1;
  const int slot2 = hkv::group_match_row(digests, keys, b2, qd, qk, use_digest, second, lane);
  const int64_t b = slot2 >= 0 ? b2 : b1;   // only a second probe can match
  if (slot2 >= 0) slot = slot2;
  if (!in) return;   // past the last full-mask primitive
  if (g == 0) found[q] = slot >= 0 ? 1 : 0;
  if (slot < 0) return;  // a miss or a gated lane writes nothing (the whole group)

  T* __restrict__ row = values + (b * hkv::kSlots + slot) * v;
  const T* __restrict__ g_row = grads + q * static_cast<int64_t>(dim);
  // Where the columns are updated in any order, the group walks the row in
  // aligned windows of 8 elements (a 32-byte sector of float32): lane g
  // takes column 8w + g - o of window w, o being the row's offset into its
  // first window.  A row whose bytes are no multiple of 32 (V = 257, 897)
  // then stores whole sectors but at its two ends; lanes on columns g, g+8,
  // ... would store two partial sectors each time.
  const int o = static_cast<int>((reinterpret_cast<uintptr_t>(row) / sizeof(T)) &
                                 (hkv::kGroup - 1));
  const int windows = (dim + o + hkv::kGroup - 1) / hkv::kGroup;

  if constexpr (kOpt == kRowwiseAdagrad) {
    const unsigned gmask = 0xffu << (lane - g);
    // the accumulator, and up to dim 32 the row's embedding columns, are
    // loaded with the gradient: one round trip for the whole row
    const float acc_old = hkv::to_float(row[dim]);
    float gr[kRegTiles], e[kRegTiles];
    float sum;
    if (tiles <= kRegTiles) {
      // squares of the lane's columns, halved locally (tiles is a power of two)
      float sq[kRegTiles];
#pragma unroll
      for (int k = 0; k < kRegTiles; ++k) {
        const int d = g + hkv::kGroup * k;
        const bool live = k < tiles && d < dim;
        gr[k] = live ? hkv::to_float(g_row[d]) : 0.0f;
        e[k] = live ? hkv::to_float(row[d]) : 0.0f;
        sq[k] = rnd<T>(__fmul_rn(gr[k], gr[k]));
      }
#pragma unroll
      for (int h = kRegTiles / 2; h >= 1; h /= 2) {
        if (h < tiles) {
#pragma unroll
          for (int k = 0; k < h; ++k) sq[k] = rnd<T>(__fadd_rn(sq[k], sq[k + h]));
        }
      }
      sum = sq[0];
    } else {
      // the lane's columns in bit-reversed order of their tile index, summed
      // as the adjacent-pair tree: stack[l] holds the pending sum of 2^l;
      // kSumChunk gradient elements are loaded before any is summed (tiles
      // is a power of two past kRegTiles, so a multiple of kSumChunk)
      float stack[32];
      for (int j0 = 0; j0 < tiles; j0 += kSumChunk) {
        float x[kSumChunk];
#pragma unroll
        for (int c = 0; c < kSumChunk; ++c) {
          const int d = g + hkv::kGroup * static_cast<int>(__brev(j0 + c) >> (32 - levels));
          x[c] = d < dim ? hkv::to_float(g_row[d]) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kSumChunk; ++c) {
          const int j = j0 + c;
          float y = rnd<T>(__fmul_rn(x[c], x[c]));
          int l = 0;
          for (; (j >> l) & 1; ++l) y = rnd<T>(__fadd_rn(stack[l], y));
          stack[l] = y;
        }
      }
      sum = stack[levels];
    }
#pragma unroll
    for (int off = hkv::kGroup / 2; off >= 1; off /= 2)
      sum = rnd<T>(__fadd_rn(sum, __shfl_xor_sync(gmask, sum, off)));
    // mean = sum / dim, acc += mean, step = lr / (sqrt(acc) + eps)
    const float mean = rnd<T>(__fdiv_rn(sum, rnd<T>(static_cast<float>(dim))));
    const float acc = rnd<T>(__fadd_rn(acc_old, mean));
    const float den = rnd<T>(__fadd_rn(rnd<T>(__fsqrt_rn(acc)), eps));
    const float step = rnd<T>(__fdiv_rn(rnd<T>(lr), den));
    __syncwarp(gmask);  // every lane has read row[dim] before lane 0 rewrites it
    if (tiles <= kRegTiles) {
#pragma unroll
      for (int k = 0; k < kRegTiles; ++k) {
        const int d = g + hkv::kGroup * k;
        if (k < tiles && d < dim)
          row[d] = hkv::from_float<T>(__fsub_rn(e[k], rnd<T>(__fmul_rn(step, gr[k]))));
      }
    } else {
      for (int w0 = 0; w0 < windows; w0 += kChunk) {
        float e[kChunk], gd[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int d = hkv::kGroup * (w0 + c) + g - o;
          if (d >= 0 && d < dim) {
            e[c] = hkv::to_float(row[d]);
            gd[c] = hkv::to_float(g_row[d]);
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int d = hkv::kGroup * (w0 + c) + g - o;
          if (d >= 0 && d < dim)
            row[d] = hkv::from_float<T>(__fsub_rn(e[c], rnd<T>(__fmul_rn(step, gd[c]))));
        }
      }
    }
    if (g == 0) row[dim] = hkv::from_float<T>(acc);
  } else {
    // kChunk columns a lane at a time, every load before any store: a store
    // to row[d] may alias the next column's aux load as far as the compiler
    // knows, so without this each column would cost a round trip
    for (int w0 = 0; w0 < windows; w0 += kChunk) {
      float e[kChunk], gd[kChunk], aux[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int d = hkv::kGroup * (w0 + c) + g - o;
        if (d >= 0 && d < dim) {
          gd[c] = hkv::to_float(g_row[d]);
          e[c] = hkv::to_float(row[d]);
          if constexpr (kOpt != kSgd) aux[c] = hkv::to_float(row[dim + d]);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int d = hkv::kGroup * (w0 + c) + g - o;
        if (d < 0 || d >= dim) continue;
        if constexpr (kOpt == kSgd) {
          row[d] = hkv::from_float<T>(__fsub_rn(e[c], rnd<T>(__fmul_rn(lr, gd[c]))));
        } else if constexpr (kOpt == kSgdm) {
          const float m = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(momentum, aux[c])), gd[c]));
          row[d] = hkv::from_float<T>(__fsub_rn(e[c], rnd<T>(__fmul_rn(lr, m))));
          row[dim + d] = hkv::from_float<T>(m);
        } else {  // adagrad: (lr * g) / (sqrt(acc) + eps), the product first
          const float acc = rnd<T>(__fadd_rn(aux[c], rnd<T>(__fmul_rn(gd[c], gd[c]))));
          const float den = rnd<T>(__fadd_rn(rnd<T>(__fsqrt_rn(acc)), eps));
          row[d] = hkv::from_float<T>(
              __fsub_rn(e[c], rnd<T>(__fdiv_rn(rnd<T>(__fmul_rn(lr, gd[c])), den))));
          row[dim + d] = hkv::from_float<T>(acc);
        }
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
                               int dtype, void* stream) {
  if (dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  // a lane's columns: the dim columns padded to a power of two, over 8 lanes
  int levels = 0;
  while ((int64_t{hkv::kGroup} << levels) < dim) ++levels;
  const int tiles = 1 << levels;
  const dim3 grid(hkv::blocks_for_groups(n)), block(hkv::kWarp * hkv::kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, auto elem) {
    using T = decltype(elem);
    kernel<<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
        static_cast<T*>(values), static_cast<const int64_t*>(bucket1),
        static_cast<const int64_t*>(bucket2), static_cast<const uint8_t*>(qdigest),
        static_cast<const int64_t*>(qkeys), static_cast<const bool*>(qvalid),
        static_cast<const T*>(grads), static_cast<int32_t*>(found), n, v, dim, tiles, levels,
        use_digest, lr, eps, momentum);
  };
  auto by_opt = [&](auto elem) {
    using T = decltype(elem);
    switch (opt) {
      case kSgd: launch(update_scan_kernel<kSgd, T>, elem); return true;
      case kSgdm: launch(update_scan_kernel<kSgdm, T>, elem); return true;
      case kRowwiseAdagrad: launch(update_scan_kernel<kRowwiseAdagrad, T>, elem); return true;
      case kAdagrad: launch(update_scan_kernel<kAdagrad, T>, elem); return true;
      default: return false;
    }
  };
  const bool ok = hkv::with_elem(dtype, by_opt);
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}
