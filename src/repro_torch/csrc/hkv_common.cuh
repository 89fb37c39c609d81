// Shared pieces of the HKV table kernels (sm_90a).
//
// Table layout (see repro_torch/core/table.py): digests uint8 [B, 128],
// keys and scores int64 [B, 128] holding unsigned 64-bit words, values
// float32 or bfloat16 [B*128, V].  EMPTY is the all-ones key (-1 as
// int64).  Every row or element offset is computed in 64 bits: at the
// paper's config B (2^27 rows of 32 floats) a value offset passes 2^31.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hkv {

constexpr int kSlots = 128;          // slots per bucket (one digest line)
constexpr int kWarp = 32;
constexpr int kSlotsPerLane = kSlots / kWarp;
constexpr int64_t kEmpty = -1;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;    // 256 threads a block
// Blocks an SM must hold for a latency-bound kernel: 8 x 256 threads is the
// SM's maximum of 2048, which caps a thread at 32 registers.
constexpr int kFullOccupancyBlocks = 8;

// The group probe: a group of kGroup lanes serves one query, so a warp
// serves kGroupsPerWarp queries: four times as many queries in flight as
// with a warp a query.  Lane g of a group covers slots
// 16g..16g+15: their digests are one 16-byte load, compared bytewise
// (__vcmpeq4) with the query's digest; a full key is read only where the
// digest matched (or all 16, in 16-byte loads, when use_digest is 0).
// Every lane of the warp calls it together, since the ballot and shuffle
// take the full mask: a lane whose group has nothing to probe passes
// active = false and reads nothing.  It treats no key specially (an EMPTY
// query key may match a free slot when use_digest is 0); callers that
// want EMPTY to miss pass active = false.  Returns the lowest matching
// slot, or -1, the same in every lane of the group.
constexpr int kGroup = 8;
constexpr int kGroupsPerWarp = kWarp / kGroup;
constexpr int kSlotsPerGroupLane = kSlots / kGroup;

__device__ __forceinline__ int group_match_row(const uint8_t* __restrict__ digests,
                                               const int64_t* __restrict__ keys,
                                               int64_t bucket, uint32_t qdigest,
                                               int64_t qkey, int use_digest, bool active,
                                               int lane) {
  const int g = lane % kGroup;
  const int leader = lane - g;
  unsigned mine = 0;
  if (active) {
    const int64_t base = bucket * kSlots + g * kSlotsPerGroupLane;
    if (use_digest) {
      const uint4 d = *reinterpret_cast<const uint4*>(digests + base);
      const unsigned words[4] = {d.x, d.y, d.z, d.w};
      const unsigned rep = qdigest * 0x01010101u;
      unsigned cand = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // 0xff in each equal byte -> one bit a byte: bit b of the product's
        // top byte is byte b's low bit (the partial products do not overlap)
        const unsigned eq = __vcmpeq4(words[i], rep) & 0x01010101u;
        cand |= ((eq * 0x01020408u) >> 24) << (4 * i);
      }
      while (cand) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        if (keys[base + j] == qkey) mine |= 1u << j;
      }
    } else {
      const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base);
#pragma unroll
      for (int i = 0; i < kSlotsPerGroupLane / 2; ++i) {
        const longlong2 k = kp[i];
        if (k.x == qkey) mine |= 1u << (2 * i);
        if (k.y == qkey) mine |= 1u << (2 * i + 1);
      }
    }
  }
  const unsigned gbits = (__ballot_sync(kFullMask, mine != 0) >> leader) & ((1u << kGroup) - 1);
  const int first = gbits ? __ffs(gbits) - 1 : 0;
  const unsigned bits = __shfl_sync(kFullMask, mine, leader + first);
  return gbits ? first * kSlotsPerGroupLane + (__ffs(bits) - 1) : -1;
}

// Value elements.  A kernel that only copies values moves them in units of
// 16, 4 or 2 bytes, whatever the element (the wrapper picks the widest
// unit that divides every row and both planes' alignment), so a copy is
// bit-exact by construction.  A kernel that computes on values reads each
// element into float32, computes there, and rounds a bfloat16 result to
// nearest even once, where it is stored.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// Calls f(U{}) with U the copy unit of `unit` bytes (16, 4 or 2); false for
// any other size.
template <typename F>
inline bool with_unit(int unit, F&& f) {
  switch (unit) {
    case 16: f(uint4{}); return true;
    case 4: f(uint32_t{}); return true;
    case 2: f(uint16_t{}); return true;
    default: return false;
  }
}

inline unsigned blocks_for_warps(int64_t n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Blocks for n queries at kGroupsPerWarp queries a warp.
inline unsigned blocks_for_groups(int64_t n) {
  return blocks_for_warps((n + kGroupsPerWarp - 1) / kGroupsPerWarp);
}

}  // namespace hkv
