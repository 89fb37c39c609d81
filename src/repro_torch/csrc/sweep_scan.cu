// sweep_match: the maintenance sweeps' whole-table predicate pass.
//
// Replaces the TPU kernel sweep_match (src/repro/kernels/sweep_scan.py:55):
// for every slot, live (key is not EMPTY) AND the SweepPredicate of the
// given kind, as a bool mask [B, 128], plus the per-bucket match count
// int32 [B].  It is the mask stage of erase_if and evict_if.  Kinds, in
// the order of core/predicates.py KINDS (every compare unsigned 64-bit):
//   0 always     1 score < a     2 score >= a
//   3 epoch_lt   score's high 32 bits < a's high 32 bits (a logical shift:
//                an arithmetic one would misorder scores >= 2^63)
//   4 key_range  a <= key < b
//
// Bound on this card: bytes.  Every key of the table is read once (8
// bytes a slot), and the score too (8 more) only for the three kinds that
// test it; one mask byte a slot and one count a bucket are written.  A
// slot costs a handful of 32-bit operations, far below the bytes' time.
// One warp per bucket row in a grid-stride loop: lane l loads slots
// 4l..4l+3 of each plane it needs as two 16-byte words (each row plane one
// coalesced 1 KB transaction), stores its four mask bytes as one 32-bit
// word (the TPU kernel wrote int32 a slot), and the count is a warp sum of
// the lanes' match counts.  The predicate kind is uniform across the
// launch, so neither the score load nor the kind's switch diverges, and
// always / key_range never touch the score plane.
#include "hkv_common.cuh"

namespace {

using u64 = unsigned long long;

__device__ __forceinline__ bool predicate(int kind, u64 key, u64 score, u64 a, u64 b) {
  switch (kind) {
    case 0: return true;
    case 1: return score < a;
    case 2: return !(score < a);
    case 3: return (score >> 32) < (a >> 32);
    case 4: return !(key < a) && key < b;
    default: return false;
  }
}

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
sweep_match_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ scores,
                   bool* __restrict__ match, int32_t* __restrict__ count,
                   int64_t num_buckets, int kind, u64 a, u64 b) {
  const int lane = threadIdx.x % hkv::kWarp;
  const bool reads_score = kind >= 1 && kind <= 3;  // score_lt, score_ge, epoch_lt
  const int64_t warps = static_cast<int64_t>(gridDim.x) * hkv::kWarpsPerBlock;
  for (int64_t bucket = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                        threadIdx.x / hkv::kWarp;
       bucket < num_buckets; bucket += warps) {
    const int64_t base = bucket * hkv::kSlots + lane * hkv::kSlotsPerLane;
    const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base);
    const longlong2* sp = reinterpret_cast<const longlong2*>(scores + base);
    const longlong2 k01 = kp[0], k23 = kp[1];
    longlong2 c01 = make_longlong2(0, 0), c23 = c01;
    if (reads_score) {
      c01 = sp[0];
      c23 = sp[1];
    }
    const long long k[4] = {k01.x, k01.y, k23.x, k23.y};
    const long long c[4] = {c01.x, c01.y, c23.x, c23.y};
    uint32_t bytes = 0;
    int mine = 0;
#pragma unroll
    for (int j = 0; j < hkv::kSlotsPerLane; ++j) {
      const bool m = k[j] != hkv::kEmpty &&
                     predicate(kind, static_cast<u64>(k[j]), static_cast<u64>(c[j]), a, b);
      bytes |= static_cast<uint32_t>(m) << (8 * j);
      mine += m;
    }
    reinterpret_cast<uint32_t*>(match + base)[0] = bytes;
    const int total = __reduce_add_sync(hkv::kFullMask, mine);
    if (lane == 0) count[bucket] = total;
  }
}

}  // namespace

extern "C" int hkv_sweep_match(const void* keys, const void* scores, void* match, void* count,
                               int64_t num_buckets, int kind, int64_t a, int64_t b,
                               void* stream) {
  // enough warps to fill the card several times over; each walks buckets
  const int64_t want = (num_buckets + hkv::kWarpsPerBlock - 1) / hkv::kWarpsPerBlock;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  sweep_match_kernel<<<blocks, hkv::kWarp * hkv::kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(scores),
      static_cast<bool*>(match), static_cast<int32_t*>(count), num_buckets, kind,
      static_cast<u64>(a), static_cast<u64>(b));
  return static_cast<int>(cudaGetLastError());
}
