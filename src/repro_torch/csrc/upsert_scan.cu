// The inserter's two row kernels of an HKV table: upsert_probe and claim_scan.
//
// upsert_probe replaces the TPU kernel upsert_probe
// (src/repro/kernels/upsert_scan.py:98).  One warp per query reads both
// candidate rows and computes, for each: the key match (digest pre-filter
// and full 64-bit confirm), the occupancy, and the minimum live score
// (unsigned 64-bit; empty slots count as +inf, so an empty row reports the
// all-ones sentinel).  From those: found, hit_sel (0 on a hit in bucket1,
// else 1), hit_slot (0 on a miss) and the dual-bucket target tgt_sel: while
// either row has a free slot the less occupied one, once both are full the
// one with the lower minimum score, ties to bucket1 (paper Alg. 3).
//
// Bound: bytes.  Occupancy and the minimum need every key and score of
// both rows, 2 x (1024 + 1024) bytes a query, and a few compares a slot
// (the kernel also reads the 128-byte digest line, which a full-key match
// over every slot could do without).  Lane l loads slots 4l..4l+3 of each plane as two 16-byte words, so
// each row plane is one fully coalesced 1 KB warp transaction; occupancy is
// one warp add and the minimum a 5-step shuffle reduction on 64-bit words
// (__reduce_min_sync is 32-bit only).
//
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
//   - lane l holds slots 4l..4l+3 of the row (two 16-byte loads a plane,
//     as upsert_probe reads it); the next query's row is loaded before
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

struct RowProbe {
  int slot;            // first matching slot, -1 if none
  int occ;             // live slots
  u64 min_score;       // unsigned minimum live score, all-ones if none
};

__device__ __forceinline__ RowProbe warp_probe_row(const uint8_t* __restrict__ digests,
                                                   const int64_t* __restrict__ keys,
                                                   const int64_t* __restrict__ scores,
                                                   int64_t bucket, uint32_t qdigest,
                                                   int64_t qkey, int use_digest, int lane) {
  const int64_t base = bucket * hkv::kSlots;
  const int s0 = lane * hkv::kSlotsPerLane;
  const uint32_t dword = reinterpret_cast<const uint32_t*>(digests + base)[lane];
  const longlong2* kp = reinterpret_cast<const longlong2*>(keys + base + s0);
  const longlong2* sp = reinterpret_cast<const longlong2*>(scores + base + s0);
  const longlong2 k01 = kp[0], k23 = kp[1], c01 = sp[0], c23 = sp[1];
  const long long k[4] = {k01.x, k01.y, k23.x, k23.y};
  const long long c[4] = {c01.x, c01.y, c23.x, c23.y};
  unsigned mine = 0;
  int occ = 0;
  u64 mn = ~0ull;
#pragma unroll
  for (int j = 0; j < hkv::kSlotsPerLane; ++j) {
    const bool live = k[j] != hkv::kEmpty;
    occ += live;
    if (live) mn = umin64(mn, static_cast<u64>(c[j]));
    const bool cand = !use_digest || ((dword >> (8 * j)) & 0xffu) == qdigest;
    if (cand && k[j] == qkey) mine |= 1u << j;
  }
  RowProbe r;
  r.occ = __reduce_add_sync(hkv::kFullMask, occ);
#pragma unroll
  for (int off = hkv::kWarp / 2; off > 0; off >>= 1)
    mn = umin64(mn, __shfl_xor_sync(hkv::kFullMask, mn, off));
  r.min_score = mn;
  const unsigned ballot = __ballot_sync(hkv::kFullMask, mine != 0);
  if (ballot == 0) {
    r.slot = -1;
  } else {
    const int first_lane = __ffs(ballot) - 1;
    const unsigned bits = __shfl_sync(hkv::kFullMask, mine, first_lane);
    r.slot = first_lane * hkv::kSlotsPerLane + (__ffs(bits) - 1);
  }
  return r;
}

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
upsert_probe_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ scores, const int64_t* __restrict__ bucket1,
                    const int64_t* __restrict__ bucket2, const uint8_t* __restrict__ qdigest,
                    const int64_t* __restrict__ qkeys, int32_t* __restrict__ found,
                    int32_t* __restrict__ hit_sel, int32_t* __restrict__ hit_slot,
                    int32_t* __restrict__ tgt_sel, int64_t n, int use_digest) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (q >= n) return;
  const int64_t qk = qkeys[q];
  const uint32_t qd = qdigest[q];
  const RowProbe r1 = warp_probe_row(digests, keys, scores, bucket1[q], qd, qk, use_digest, lane);
  const RowProbe r2 = warp_probe_row(digests, keys, scores, bucket2[q], qd, qk, use_digest, lane);
  if (lane == 0) {
    const bool hit1 = r1.slot >= 0, hit2 = r2.slot >= 0;
    found[q] = (hit1 || hit2) ? 1 : 0;
    hit_sel[q] = hit1 ? 0 : 1;
    hit_slot[q] = hit1 ? r1.slot : (hit2 ? r2.slot : 0);
    const bool any_free = r1.occ < hkv::kSlots || r2.occ < hkv::kSlots;
    tgt_sel[q] = any_free ? (r2.occ < r1.occ) : (r2.min_score < r1.min_score);
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

// Unsigned 64-bit minimum over the warp in two 32-bit reductions.
__device__ __forceinline__ u64 warp_min_u64(u64 v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned mhi = __reduce_min_sync(hkv::kFullMask, hi);
  const unsigned mlo = __reduce_min_sync(hkv::kFullMask, hi == mhi ? static_cast<unsigned>(v)
                                                                   : 0xffffffffu);
  return (static_cast<u64>(mhi) << 32) | mlo;
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
                                const void* qkeys, void* found, void* hit_sel, void* hit_slot,
                                void* tgt_sel, int64_t n, int use_digest, void* stream) {
  upsert_probe_kernel<<<hkv::blocks_for_warps(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(scores), static_cast<const int64_t*>(bucket1),
      static_cast<const int64_t*>(bucket2), static_cast<const uint8_t*>(qdigest),
      static_cast<const int64_t*>(qkeys), static_cast<int32_t*>(found),
      static_cast<int32_t*>(hit_sel), static_cast<int32_t*>(hit_slot),
      static_cast<int32_t*>(tgt_sel), n, use_digest);
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
