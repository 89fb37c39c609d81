// The inserter's two row kernels of an HKV table: upsert_probe and claim_scan.
//
// upsert_probe replaces the TPU kernel upsert_probe
// (src/repro/kernels/upsert_scan.py:98): per query, over both candidate
// rows, the key match (found, hit_sel: 0 on a hit in bucket1, else 1;
// hit_slot: 0 on a miss) and the dual-bucket target tgt_sel: while either
// row has a free slot the less occupied one, once both are full the one
// with the lower minimum live score (unsigned 64-bit), ties to bucket1
// (paper Alg. 3).  The upsert asks for the two halves at two stages, so
// the kernel computes only the outputs its mode asks for:
//   - match (the locate stage) probes like a reader, with the group probe
//     of find_scan (hkv::group_match_row, a quarter warp a query): the
//     digest line of bucket1, keys only where the digest matched, bucket2
//     only after a miss in bucket1 (hit1 wins, so the outputs are those of
//     probing both), no scores.  Unlike find_scan, an EMPTY query key is
//     probed like any other (the locate stage masks it by key validity);
//   - target (the select stage) matches nothing and reads no digest: half
//     a warp reads each row's 1 KB of keys (four 16-byte loads in flight a
//     lane) for the occupancies, and the scores only when both rows are
//     full, the only case where the minimum decides.  A lane gate (the
//     closure's miss lanes) skips the rest: an off lane reads nothing and
//     reports 0, as does a query whose two candidates are one row;
//   - both is the TPU kernel's whole function: match, then target.
// A warp serves four queries in every mode: the groups probe them at once,
// then the target pass takes them one after another with the whole warp.
//
// Bound: bytes.  Match: the digest lines of the probed rows and the
// candidate keys (as find_scan).  Target: every key of both rows, 2 KB a
// query, and at full rows every score, 2 KB more; a few compares a slot.
// Each is a dependent random read of a whole row, so a warp keeps both
// rows in flight.

// claim_scan replaces the TPU kernel claim_scan
// (src/repro/kernels/upsert_scan.py:189): the slot of rank r of a target row
// under the total victim order (occupied, score, key, slot), compared as
// unsigned 64-bit words, with that slot's occupancy, score and key.
//
// Bound: bytes, 2 KB of row a query: a selection needs only 127 compares.
// Counting, for every slot, the slots weaker than it (the TPU's 128x128
// compare block) would make 16,384 compares a query, about 6 ms of
// integer instructions at 2^20 queries against 0.4 ms of bytes.  So a selection
// replaces the count:
//   - one warp owns a group of 32 queries: their bucket and rank words
//     come in one coalesced load each, and lane j collects query j's
//     outputs for one coalesced store of each at the end;
//   - lane l holds slots 4l..4l+3 of the row (two 16-byte loads a
//     plane); the next query's row is loaded before
//     this one is selected, so the warp has a row in flight while it
//     computes, and not at all when it is the same bucket: the upsert
//     hands its misses over in canonical order, bucket ascending, so a
//     bucket's misses are adjacent and its row is read once a run, and the
//     bytes are those of the distinct rows;
//   - empty slots sort before live ones and all hold the EMPTY key, so a
//     count of empties e splits the order: rank r < e selects among the
//     empties, otherwise rank r - e among the live slots;
//   - within that set, rank r' takes r' + 1 passes of a warp minimum
//     under (score, key, slot): a 64-bit minimum is two __reduce_min_sync
//     (high word, then low word among the lanes holding the high minimum);
//     the key is compared only when scores tie; the lowest slot among full
//     ties comes from a ballot.  The winner's slot retires and the next
//     pass finds the next.  A rank past the middle of its set is mirrored
//     (the same passes for a maximum under the reversed order), so no
//     rank takes more than 64 passes; the upsert's canonical ranks are
//     mostly 0-3, one to four passes.
// Exactly one slot is selected for any row contents (equal scores, stale
// scores on empty slots, duplicate keys) and any rank (clipped to
// [0, 128)), so the outputs equal the count's, and the plain version's.
#include "hkv_common.cuh"

namespace {

using u64 = unsigned long long;

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// Unsigned 64-bit minimum over the warp in two 32-bit reductions.
__device__ __forceinline__ u64 warp_min_u64(u64 v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned mhi = __reduce_min_sync(hkv::kFullMask, hi);
  const unsigned mlo = __reduce_min_sync(hkv::kFullMask, hi == mhi ? static_cast<unsigned>(v)
                                                                   : 0xffffffffu);
  return (static_cast<u64>(mhi) << 32) | mlo;
}

// The dual-bucket target of one query, by the whole warp (warp-uniform
// result): lanes 0-15 hold bucket1's row, lanes 16-31 bucket2's, 8 slots
// a lane.  Scores are read only when both rows are full.
__device__ __forceinline__ int warp_select_target(const int64_t* __restrict__ keys,
                                                  const int64_t* __restrict__ scores,
                                                  int64_t bucket1, int64_t bucket2, int lane) {
  constexpr int kHalf = hkv::kWarp / 2;
  constexpr int kPer = hkv::kSlots / kHalf;   // 8 slots, four 16-byte words a plane
  const bool second = lane >= kHalf;
  const int64_t base = (second ? bucket2 : bucket1) * hkv::kSlots + (lane % kHalf) * kPer;
  const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base);
  longlong2 k[kPer / 2];
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) k[i] = kp[i];
  int live = 0;
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) live += (k[i].x != hkv::kEmpty) + (k[i].y != hkv::kEmpty);
  const int occ1 = static_cast<int>(__reduce_add_sync(hkv::kFullMask, second ? 0 : live));
  const int occ2 = static_cast<int>(__reduce_add_sync(hkv::kFullMask, second ? live : 0));
  if (occ1 < hkv::kSlots || occ2 < hkv::kSlots) return occ2 < occ1 ? 1 : 0;
  // both rows full: every slot is live, so the row minimum is the live one
  const longlong2* sp = reinterpret_cast<const longlong2*>(scores + base);
  u64 mn = ~0ull;
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) {
    const longlong2 c = sp[i];
    mn = umin64(mn, umin64(static_cast<u64>(c.x), static_cast<u64>(c.y)));
  }
  const u64 min1 = warp_min_u64(second ? ~0ull : mn);
  const u64 min2 = warp_min_u64(second ? mn : ~0ull);
  return min2 < min1 ? 1 : 0;
}

enum ProbeMode { kBoth = 0, kMatch = 1, kTarget = 2 };

template <int kMode>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
upsert_probe_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ scores, const int64_t* __restrict__ bucket1,
                    const int64_t* __restrict__ bucket2, const uint8_t* __restrict__ qdigest,
                    const int64_t* __restrict__ qkeys, const bool* __restrict__ gate,
                    int32_t* __restrict__ found, int32_t* __restrict__ hit_sel,
                    int32_t* __restrict__ hit_slot, int32_t* __restrict__ tgt_sel, int64_t n,
                    int use_digest) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int g = lane % hkv::kGroup;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kGroupsPerWarp;
  if (q0 >= n) return;  // whole warps leave together
  const int64_t q = q0 + lane / hkv::kGroup;
  const bool in = q < n;
  // the target pass works on the gated lanes only (all without a gate)
  const bool on = kMode != kMatch && in && (gate == nullptr || gate[q]);
  const bool need = kMode == kTarget ? on : in;
  const int64_t b1 = need ? bucket1[q] : 0;
  const int64_t b2 = need ? bucket2[q] : 0;
  if (kMode != kTarget) {
    const int64_t qk = in ? qkeys[q] : 0;
    const uint32_t qd = in ? qdigest[q] : 0u;
    const int slot1 = hkv::group_match_row(digests, keys, b1, qd, qk, use_digest, in, lane);
    const bool second = in && slot1 < 0 && b2 != b1;
    const int slot2 = hkv::group_match_row(digests, keys, b2, qd, qk, use_digest, second, lane);
    if (in && g == 0) {
      const bool hit1 = slot1 >= 0, hit2 = slot2 >= 0;
      found[q] = (hit1 || hit2) ? 1 : 0;
      hit_sel[q] = hit1 ? 0 : 1;
      hit_slot[q] = hit1 ? slot1 : (hit2 ? slot2 : 0);
    }
  }
  if (kMode != kMatch) {
    int tgt = 0;
#pragma unroll 1
    for (int i = 0; i < hkv::kGroupsPerWarp; ++i) {
      const int leader = i * hkv::kGroup;
      const bool on_i = __shfl_sync(hkv::kFullMask, static_cast<int>(on), leader) != 0;
      const int64_t c1 = __shfl_sync(hkv::kFullMask, b1, leader);
      const int64_t c2 = __shfl_sync(hkv::kFullMask, b2, leader);
      if (!on_i || c1 == c2) continue;   // warp-uniform: target 0, nothing read
      const int t = warp_select_target(keys, scores, c1, c2, lane);
      if (lane == leader) tgt = t;
    }
    if (in && g == 0) tgt_sel[q] = tgt;
  }
}

__device__ __forceinline__ void load_row(const int64_t* __restrict__ keys,
                                         const int64_t* __restrict__ scores, int64_t bucket,
                                         int lane, u64 (&k)[hkv::kSlotsPerLane],
                                         u64 (&c)[hkv::kSlotsPerLane]) {
  const int64_t base = bucket * hkv::kSlots + lane * hkv::kSlotsPerLane;
  const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base);
  const longlong2* sp = reinterpret_cast<const longlong2*>(scores + base);
  const longlong2 k01 = kp[0], k23 = kp[1], c01 = sp[0], c23 = sp[1];
  k[0] = k01.x; k[1] = k01.y; k[2] = k23.x; k[3] = k23.y;
  c[0] = c01.x; c[1] = c01.y; c[2] = c23.x; c[3] = c23.y;
}

// The slot of rank r within the candidate slots `cand` (this lane's 4-bit
// mask) under (score, key, slot) ascending, or descending when `desc`
// (scores and keys complemented, the highest slot first among full ties).
// r + 1 passes; warp-uniform result.
__device__ __forceinline__ int select_rank(const u64 (&k)[hkv::kSlotsPerLane],
                                           const u64 (&c)[hkv::kSlotsPerLane],
                                           unsigned cand, int r, bool desc, int lane) {
  const u64 flip = desc ? ~0ull : 0ull;
  unsigned alive = cand;
  int slot = 0;
  for (int pass = 0; pass <= r; ++pass) {
    u64 m = ~0ull;
#pragma unroll
    for (int j = 0; j < hkv::kSlotsPerLane; ++j)
      if ((alive >> j) & 1u) m = umin64(m, c[j] ^ flip);
    const u64 smin = warp_min_u64(m);
    unsigned tie = 0;
#pragma unroll
    for (int j = 0; j < hkv::kSlotsPerLane; ++j)
      if (((alive >> j) & 1u) && (c[j] ^ flip) == smin) tie |= 1u << j;
    if (__reduce_add_sync(hkv::kFullMask, __popc(tie)) > 1) {   // scores tie: compare keys
      u64 mk = ~0ull;
#pragma unroll
      for (int j = 0; j < hkv::kSlotsPerLane; ++j)
        if ((tie >> j) & 1u) mk = umin64(mk, k[j] ^ flip);
      const u64 kmin = warp_min_u64(mk);
      unsigned keep = 0;
#pragma unroll
      for (int j = 0; j < hkv::kSlotsPerLane; ++j)
        if (((tie >> j) & 1u) && (k[j] ^ flip) == kmin) keep |= 1u << j;
      tie = keep;
    }
    const unsigned ballot = __ballot_sync(hkv::kFullMask, tie != 0);
    const int wl = desc ? 31 - __clz(ballot) : __ffs(ballot) - 1;
    const unsigned bits = __shfl_sync(hkv::kFullMask, tie, wl);
    const int bit = desc ? 31 - __clz(bits) : __ffs(bits) - 1;
    if (lane == wl) alive &= ~(1u << bit);
    slot = wl * hkv::kSlotsPerLane + bit;
  }
  return slot;
}

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
claim_scan_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ scores,
                  const int64_t* __restrict__ buckets, const int64_t* __restrict__ rank,
                  int32_t* __restrict__ out_slot, int32_t* __restrict__ out_occ,
                  int64_t* __restrict__ out_score, int64_t* __restrict__ out_key, int64_t n) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kWarp;
  if (q0 >= n) return;
  const int cnt = static_cast<int>(n - q0 < hkv::kWarp ? n - q0 : hkv::kWarp);
  const int64_t my_bucket = lane < cnt ? buckets[q0 + lane] : 0;
  const int64_t my_rank = lane < cnt ? rank[q0 + lane] : 0;
  int o_slot = 0, o_occ = 0;
  u64 o_score = 0, o_key = 0;
  u64 k[hkv::kSlotsPerLane], c[hkv::kSlotsPerLane];
  int64_t bucket = __shfl_sync(hkv::kFullMask, my_bucket, 0);
  load_row(keys, scores, bucket, lane, k, c);
  for (int q = 0; q < cnt; ++q) {
    // the next query's row, in flight meanwhile, unless it is this row
    const int64_t next = __shfl_sync(hkv::kFullMask, my_bucket, q + 1 < cnt ? q + 1 : q);
    const bool fresh = next != bucket;
    u64 nk[hkv::kSlotsPerLane], nc[hkv::kSlotsPerLane];
    if (fresh) load_row(keys, scores, next, lane, nk, nc);
    const int64_t rq = __shfl_sync(hkv::kFullMask, my_rank, q);
    const int r = rq < 0 ? 0 : (rq >= hkv::kSlots ? hkv::kSlots - 1 : static_cast<int>(rq));
    unsigned empty = 0;
#pragma unroll
    for (int j = 0; j < hkv::kSlotsPerLane; ++j)
      if (k[j] == ~0ull) empty |= 1u << j;
    const int e = static_cast<int>(__reduce_add_sync(hkv::kFullMask, __popc(empty)));
    const bool among_empty = r < e;
    const int size = among_empty ? e : hkv::kSlots - e;
    int rr = among_empty ? r : r - e;
    const bool desc = 2 * rr > size - 1;
    if (desc) rr = size - 1 - rr;
    const unsigned cand = among_empty ? empty : (~empty & 0xfu);
    const int slot = select_rank(k, c, cand, rr, desc, lane);
    const int bit = slot % hkv::kSlotsPerLane;
    const u64 ks = bit == 0 ? k[0] : bit == 1 ? k[1] : bit == 2 ? k[2] : k[3];
    const u64 cs = bit == 0 ? c[0] : bit == 1 ? c[1] : bit == 2 ? c[2] : c[3];
    const int wl = slot / hkv::kSlotsPerLane;
    const u64 vk = __shfl_sync(hkv::kFullMask, ks, wl);
    const u64 vc = __shfl_sync(hkv::kFullMask, cs, wl);
    if (lane == q) {
      o_slot = slot;
      o_occ = among_empty ? 0 : 1;
      o_score = vc;
      o_key = vk;
    }
    if (fresh) {
#pragma unroll
      for (int j = 0; j < hkv::kSlotsPerLane; ++j) {
        k[j] = nk[j];
        c[j] = nc[j];
      }
      bucket = next;
    }
  }
  if (lane < cnt) {
    out_slot[q0 + lane] = o_slot;
    out_occ[q0 + lane] = o_occ;
    out_score[q0 + lane] = static_cast<int64_t>(o_score);
    out_key[q0 + lane] = static_cast<int64_t>(o_key);
  }
}

}  // namespace

extern "C" int hkv_upsert_probe(const void* digests, const void* keys, const void* scores,
                                const void* bucket1, const void* bucket2, const void* qdigest,
                                const void* qkeys, const void* gate, void* found, void* hit_sel,
                                void* hit_slot, void* tgt_sel, int64_t n, int use_digest,
                                int mode, void* stream) {
  auto kernel = mode == kMatch    ? upsert_probe_kernel<kMatch>
                : mode == kTarget ? upsert_probe_kernel<kTarget>
                                  : upsert_probe_kernel<kBoth>;
  kernel<<<hkv::blocks_for_groups(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(scores), static_cast<const int64_t*>(bucket1),
      static_cast<const int64_t*>(bucket2), static_cast<const uint8_t*>(qdigest),
      static_cast<const int64_t*>(qkeys), static_cast<const bool*>(gate),
      static_cast<int32_t*>(found), static_cast<int32_t*>(hit_sel),
      static_cast<int32_t*>(hit_slot), static_cast<int32_t*>(tgt_sel), n, use_digest);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hkv_claim_scan(const void* keys, const void* scores, const void* buckets,
                              const void* rank, void* slot, void* occ, void* score, void* key,
                              int64_t n, void* stream) {
  claim_scan_kernel<<<hkv::blocks_for_warps((n + hkv::kWarp - 1) / hkv::kWarp),
                      hkv::kWarp * hkv::kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(scores),
      static_cast<const int64_t*>(buckets), static_cast<const int64_t*>(rank),
      static_cast<int32_t*>(slot), static_cast<int32_t*>(occ), static_cast<int64_t*>(score),
      static_cast<int64_t*>(key), n);
  return static_cast<int>(cudaGetLastError());
}
