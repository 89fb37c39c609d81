// Shared pieces of the HKV table kernels (sm_90a).
//
// Table layout (see repro_torch/core/table.py): digests uint8 [B, 128],
// keys and scores int64 [B, 128] holding unsigned 64-bit words, values
// float32 [B*128, V].  EMPTY is the all-ones key (-1 as int64).  Every
// row or element offset is computed in 64 bits: at the paper's config B
// (2^27 rows of 32 floats) a value offset passes 2^31.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hkv {

constexpr int kSlots = 128;          // slots per bucket (one digest line)
constexpr int kWarp = 32;
constexpr int kSlotsPerLane = kSlots / kWarp;
constexpr int64_t kEmpty = -1;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;    // one query per warp, 256 threads a block

// One warp matches a query against one bucket row: lane l covers slots
// 4l..4l+3.  The 128 digests are one coalesced 128-byte load (one 32-bit
// word a lane); a full key is read only where the digest matches (or
// everywhere when use_digest is 0, the "no digest" ablation).  Returns the
// lowest matching slot, or -1.
__device__ __forceinline__ int warp_match_row(const uint8_t* __restrict__ digests,
                                              const int64_t* __restrict__ keys,
                                              int64_t bucket, uint32_t qdigest,
                                              int64_t qkey, int use_digest, int lane) {
  const int64_t base = bucket * kSlots;
  const int s0 = lane * kSlotsPerLane;
  const uint32_t dword = reinterpret_cast<const uint32_t*>(digests + base)[lane];
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    const bool cand = !use_digest || ((dword >> (8 * j)) & 0xffu) == qdigest;
    if (cand && keys[base + s0 + j] == qkey) mine |= 1u << j;
  }
  const unsigned ballot = __ballot_sync(kFullMask, mine != 0);
  if (ballot == 0) return -1;
  const int first_lane = __ffs(ballot) - 1;
  const unsigned first_bits = __shfl_sync(kFullMask, mine, first_lane);
  return first_lane * kSlotsPerLane + (__ffs(first_bits) - 1);
}

inline unsigned blocks_for_warps(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace hkv
