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
// unsigned 64-bit words, with that slot's occupancy, score and key.  One
// 128-thread block per query holds the row in shared memory; thread t
// counts the slots strictly weaker than its own (the TPU's 128x128 compare
// block), and the thread whose count equals r writes.  The counts are a
// permutation of 0..127, so exactly one thread writes.
//
// Bound: the function is bound by bytes, 2 KB of row a query, since a
// selection needs only 127 compares.  This kernel is bound by its own
// compare loop instead: 128x128 compares under the victim order a query,
// about six 32-bit integer operations each, so about 6 ms of integer issue
// at 2^20 queries against 0.4 ms of bytes.  On the H100 it runs about
// 12 ms whether the queries spread over the table or all read one cached
// row (chip_smoke.py, PERF.md), so the bytes do not set its time.
// Selecting the rank-r slot in fewer operations (r+1 warp-minimum passes)
// is later work.
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

__global__ void __launch_bounds__(hkv::kSlots)
claim_scan_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ scores,
                  const int64_t* __restrict__ buckets, const int64_t* __restrict__ rank,
                  int32_t* __restrict__ out_slot, int32_t* __restrict__ out_occ,
                  int64_t* __restrict__ out_score, int64_t* __restrict__ out_key) {
  __shared__ u64 sk[hkv::kSlots];
  __shared__ u64 ss[hkv::kSlots];
  const int64_t q = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t base = buckets[q] * hkv::kSlots;
  const u64 kt = static_cast<u64>(keys[base + t]);
  const u64 st = static_cast<u64>(scores[base + t]);
  sk[t] = kt;
  ss[t] = st;
  __syncthreads();
  const bool occ_t = kt != ~0ull;
  const int64_t rq = rank[q];
  const int r = rq < 0 ? 0 : (rq >= hkv::kSlots ? hkv::kSlots - 1 : static_cast<int>(rq));
  int weaker = 0;
  for (int u = 0; u < hkv::kSlots; ++u) {
    const u64 ku = sk[u], su = ss[u];
    const bool occ_u = ku != ~0ull;
    // is (occ_u, su, ku, u) lexicographically below (occ_t, st, kt, t)?
    const bool less =
        occ_u != occ_t ? occ_u < occ_t
                       : (su != st ? su < st : (ku != kt ? ku < kt : u < t));
    weaker += less;
  }
  if (weaker == r) {
    out_slot[q] = t;
    out_occ[q] = occ_t ? 1 : 0;
    out_score[q] = static_cast<int64_t>(st);
    out_key[q] = static_cast<int64_t>(kt);
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
  claim_scan_kernel<<<static_cast<unsigned>(n), hkv::kSlots, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(scores),
      static_cast<const int64_t*>(buckets), static_cast<const int64_t*>(rank),
      static_cast<int32_t*>(slot), static_cast<int32_t*>(occ), static_cast<int64_t*>(score),
      static_cast<int64_t*>(key));
  return static_cast<int>(cudaGetLastError());
}
