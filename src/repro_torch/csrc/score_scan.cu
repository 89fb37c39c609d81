// bucket_stats: per-bucket occupancy and minimum live score.
//
// Replaces the TPU kernel bucket_stats (src/repro/kernels/score_scan.py:46):
// for every bucket, the number of live slots (key is not EMPTY), the
// lowest live score in unsigned 64-bit order, and the slot holding it.
// Free slots take part in the minimum as the all-ones score, as in the
// reference, so ties go to the lowest slot (its argmax over is_min) and an
// all-empty bucket reports the all-ones score and slot 0.
//
// Bound on this card: bytes.  Every key and score of the table is read once
// (16 bytes a slot) and 16 bytes a bucket are written; a slot costs a
// compare or two.  One warp per bucket row in a grid-stride loop, as
// sweep_match: lane l loads slots 4l..4l+3 of each plane as two 16-byte
// words (one coalesced 1 KB transaction a plane), keeps the smallest
// (score, slot) of its four in slot order, and a __shfl_xor_sync butterfly
// takes the warp's minimum of the pairs; the occupancy is a warp sum.
#include "hkv_common.cuh"

namespace {

using u64 = unsigned long long;

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
bucket_stats_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ scores,
                    int32_t* __restrict__ occ, int64_t* __restrict__ min_score,
                    int32_t* __restrict__ argmin, int64_t num_buckets) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * hkv::kWarpsPerBlock;
  for (int64_t bucket = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                        threadIdx.x / hkv::kWarp;
       bucket < num_buckets; bucket += warps) {
    const int64_t base = bucket * hkv::kSlots + lane * hkv::kSlotsPerLane;
    const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base);
    const longlong2* sp = reinterpret_cast<const longlong2*>(scores + base);
    const longlong2 k01 = kp[0], k23 = kp[1], c01 = sp[0], c23 = sp[1];
    const long long k[4] = {k01.x, k01.y, k23.x, k23.y};
    const long long c[4] = {c01.x, c01.y, c23.x, c23.y};
    u64 best = ~0ull;
    int best_slot = lane * hkv::kSlotsPerLane;
    int live = 0;
#pragma unroll
    for (int j = 0; j < hkv::kSlotsPerLane; ++j) {
      const bool occupied = k[j] != hkv::kEmpty;
      const u64 s = occupied ? static_cast<u64>(c[j]) : ~0ull;
      live += occupied;
      if (s < best) {  // strictly lower: the first slot of a tie stays
        best = s;
        best_slot = lane * hkv::kSlotsPerLane + j;
      }
    }
#pragma unroll
    for (int off = hkv::kWarp / 2; off >= 1; off /= 2) {
      const u64 o = __shfl_xor_sync(hkv::kFullMask, best, off);
      const int o_slot = __shfl_xor_sync(hkv::kFullMask, best_slot, off);
      if (o < best || (o == best && o_slot < best_slot)) {
        best = o;
        best_slot = o_slot;
      }
    }
    const int total = __reduce_add_sync(hkv::kFullMask, live);
    if (lane == 0) {
      occ[bucket] = total;
      min_score[bucket] = static_cast<int64_t>(best);
      argmin[bucket] = best_slot;
    }
  }
}

}  // namespace

extern "C" int hkv_bucket_stats(const void* keys, const void* scores, void* occ,
                                void* min_score, void* argmin, int64_t num_buckets,
                                void* stream) {
  const int64_t want = (num_buckets + hkv::kWarpsPerBlock - 1) / hkv::kWarpsPerBlock;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  bucket_stats_kernel<<<blocks, hkv::kWarp * hkv::kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(scores),
      static_cast<int32_t*>(occ), static_cast<int64_t*>(min_score),
      static_cast<int32_t*>(argmin), num_buckets);
  return static_cast<int>(cudaGetLastError());
}
