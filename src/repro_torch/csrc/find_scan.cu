// find_scan: the fused find pass of an HKV table, a quarter warp per query.
//
// Replaces the TPU kernels find_scan_tlp and find_scan_pipeline
// (src/repro/kernels/find_scan.py:131 and :350), which compute the same
// function on two TPU schedules.  Per query, over the candidate rows:
// digest pre-filter, full 64-bit key confirm, hit in bucket1 wins, then the
// hit slot's score and its value row at bucket*128+slot (zeros on a miss).
// An EMPTY query key is a miss here, with no row probed (the TPU kernel
// lets it match empty slots and its wrapper masks the result afterwards).
//
// Bound on this card: bytes, and in practice latency.  A query needs its
// 128-byte digest line per probed row, the keys whose digest matched (one
// on a hit, 0.5 false candidates a row on average), and on a hit 8 bytes
// of score and V*4 bytes of value; there is almost no arithmetic.  But
// every access is a dependent random read (inputs, digest line, candidate
// key, second row on a miss, score and value row), so the time is set by
// how many queries are in flight.  The design:
//   - a group of 8 lanes serves one query (hkv::group_match_row), so a
//     warp serves 4, and with registers capped at 32 an SM holds 8 blocks
//     of 256 threads: 256 queries in flight, 4x a warp-per-query kernel;
//   - each lane reads 16 bytes of the digest line in one load and compares
//     them bytewise; keys are read only where the digest matched, and the
//     second row only after a miss in the first;
//   - one lane of the group reads the hit's score; the group's 8 lanes copy
//     the value row in units of 16 bytes (float32 at V = 32: one 128-byte
//     row in one vector load and store a lane) where the wrapper found the
//     row's bytes a multiple of 16 and both planes 16-byte aligned, else in
//     4-byte or, for a bfloat16 or float16 row of odd width, 2-byte units
//     (V = 33, the training plane, takes 4-byte units).  The copy never
//     looks at the element type, so float32, bfloat16 and float16 planes
//     are copied bit for bit.
#include "hkv_common.cuh"

namespace {

// U is the copy unit (uint4, uint32_t or uint16_t); v is the row width in U.
template <typename U>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
find_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                 const int64_t* __restrict__ scores, const U* __restrict__ values,
                 const int64_t* __restrict__ bucket1, const int64_t* __restrict__ bucket2,
                 const uint8_t* __restrict__ qdigest, const int64_t* __restrict__ qkeys,
                 int32_t* __restrict__ found, int32_t* __restrict__ sel_out,
                 int32_t* __restrict__ slot_out, int64_t* __restrict__ score_out,
                 U* __restrict__ vals_out, int64_t n, int64_t v, int use_digest) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int g = lane % hkv::kGroup;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kGroupsPerWarp;
  if (q0 >= n) return;  // whole warps leave together
  const int64_t q = q0 + lane / hkv::kGroup;
  const bool in = q < n;
  const int64_t qk = in ? qkeys[q] : hkv::kEmpty;
  // an EMPTY query key (and a group past the end) is a miss, with no row probed
  const bool valid = qk != hkv::kEmpty;
  const uint32_t qd = valid ? qdigest[q] : 0u;
  const int64_t b1 = valid ? bucket1[q] : 0;
  const int64_t b2 = valid ? bucket2[q] : 0;
  int slot = hkv::group_match_row(digests, keys, b1, qd, qk, use_digest, valid, lane);
  const bool second = valid && slot < 0 && b2 != b1;
  const int slot2 = hkv::group_match_row(digests, keys, b2, qd, qk, use_digest, second, lane);
  const bool sel = slot2 >= 0;   // only a second probe can match
  if (sel) slot = slot2;
  if (!in) return;   // past the last full-mask primitive
  const bool hit = slot >= 0;
  const int64_t row = (sel ? b2 : b1) * hkv::kSlots + (hit ? slot : 0);
  if (g == 0) {
    found[q] = hit ? 1 : 0;
    sel_out[q] = sel ? 1 : 0;
    slot_out[q] = hit ? slot : 0;
    score_out[q] = hit ? scores[row] : 0;
  }
  // a row is narrow (V < 2^31 columns); only its offset needs 64 bits
  const int width = static_cast<int>(v);
  U* dst = vals_out + q * v;
  if (hit) {
    const U* src = values + row * v;
    for (int d = g; d < width; d += hkv::kGroup) dst[d] = src[d];
  } else {
    const U zero{};
    for (int d = g; d < width; d += hkv::kGroup) dst[d] = zero;
  }
}

// The multi-table form: T tables of one geometry in one launch, the
// reference's find_many_kernel (src/repro/kernels/ops.py:249), which
// stacks the tables' planes along the bucket axis and offsets each probe by
// t*B.  Here the planes stay where they are: `planes` holds 4*T base
// addresses (the T digest planes, then the key, score and value planes),
// and the queries come table by table, table t's at [offsets[t],
// offsets[t+1]).  A group finds its query's table by binary search over the
// T + 1 offsets, then probes that table's rows exactly as find_scan_kernel
// does (the same group probe); bucket1 and bucket2 are table-local.
template <typename U>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
find_scan_many_kernel(const int64_t* __restrict__ planes, int64_t num_tables,
                      const int64_t* __restrict__ offsets,
                      const int64_t* __restrict__ bucket1, const int64_t* __restrict__ bucket2,
                      const uint8_t* __restrict__ qdigest, const int64_t* __restrict__ qkeys,
                      int32_t* __restrict__ found, int32_t* __restrict__ sel_out,
                      int32_t* __restrict__ slot_out, int64_t* __restrict__ score_out,
                      U* __restrict__ vals_out, int64_t n, int64_t v, int use_digest) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int g = lane % hkv::kGroup;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kGroupsPerWarp;
  if (q0 >= n) return;  // whole warps leave together
  const int64_t q = q0 + lane / hkv::kGroup;
  const bool in = q < n;
  const int64_t qk = in ? qkeys[q] : hkv::kEmpty;
  const bool valid = qk != hkv::kEmpty;
  // the last table whose first query is at or before q (empty tables have
  // equal offsets, and the search passes over them)
  int64_t t = 0;
  if (in) {
    int64_t hi = num_tables - 1;
    while (t < hi) {
      const int64_t mid = (t + hi + 1) / 2;
      if (offsets[mid] <= q) t = mid; else hi = mid - 1;
    }
  }
  const uint8_t* digests = reinterpret_cast<const uint8_t*>(planes[t]);
  const int64_t* keys = reinterpret_cast<const int64_t*>(planes[num_tables + t]);
  const uint32_t qd = valid ? qdigest[q] : 0u;
  const int64_t b1 = valid ? bucket1[q] : 0;
  const int64_t b2 = valid ? bucket2[q] : 0;
  int slot = hkv::group_match_row(digests, keys, b1, qd, qk, use_digest, valid, lane);
  const bool second = valid && slot < 0 && b2 != b1;
  const int slot2 = hkv::group_match_row(digests, keys, b2, qd, qk, use_digest, second, lane);
  const bool sel = slot2 >= 0;
  if (sel) slot = slot2;
  if (!in) return;   // past the last full-mask primitive
  const bool hit = slot >= 0;
  const int64_t row = (sel ? b2 : b1) * hkv::kSlots + (hit ? slot : 0);
  if (g == 0) {
    const int64_t* scores = reinterpret_cast<const int64_t*>(planes[2 * num_tables + t]);
    found[q] = hit ? 1 : 0;
    sel_out[q] = sel ? 1 : 0;
    slot_out[q] = hit ? slot : 0;
    score_out[q] = hit ? scores[row] : 0;
  }
  const int width = static_cast<int>(v);
  U* dst = vals_out + q * v;
  if (hit) {
    const U* src = reinterpret_cast<const U*>(planes[3 * num_tables + t]) + row * v;
    for (int d = g; d < width; d += hkv::kGroup) dst[d] = src[d];
  } else {
    const U zero{};
    for (int d = g; d < width; d += hkv::kGroup) dst[d] = zero;
  }
}

}  // namespace

extern "C" int hkv_find_scan(const void* digests, const void* keys, const void* scores,
                             const void* values, const void* bucket1, const void* bucket2,
                             const void* qdigest, const void* qkeys, void* found, void* sel,
                             void* slot, void* score, void* vals, int64_t n, int64_t row_bytes,
                             int use_digest, int unit, void* stream) {
  if (unit <= 0 || row_bytes % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = hkv::with_unit(unit, [&](auto u) {
    using U = decltype(u);
    find_scan_kernel<U><<<hkv::blocks_for_groups(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
        static_cast<const int64_t*>(scores), static_cast<const U*>(values),
        static_cast<const int64_t*>(bucket1), static_cast<const int64_t*>(bucket2),
        static_cast<const uint8_t*>(qdigest), static_cast<const int64_t*>(qkeys),
        static_cast<int32_t*>(found), static_cast<int32_t*>(sel), static_cast<int32_t*>(slot),
        static_cast<int64_t*>(score), static_cast<U*>(vals), n, row_bytes / unit, use_digest);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hkv_find_scan_many(const void* planes, int64_t num_tables, const void* offsets,
                                  const void* bucket1, const void* bucket2, const void* qdigest,
                                  const void* qkeys, void* found, void* sel, void* slot,
                                  void* score, void* vals, int64_t n, int64_t row_bytes,
                                  int use_digest, int unit, void* stream) {
  if (unit <= 0 || row_bytes % unit != 0 || num_tables < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = hkv::with_unit(unit, [&](auto u) {
    using U = decltype(u);
    find_scan_many_kernel<U><<<hkv::blocks_for_groups(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(planes), num_tables, static_cast<const int64_t*>(offsets),
        static_cast<const int64_t*>(bucket1), static_cast<const int64_t*>(bucket2),
        static_cast<const uint8_t*>(qdigest), static_cast<const int64_t*>(qkeys),
        static_cast<int32_t*>(found), static_cast<int32_t*>(sel), static_cast<int32_t*>(slot),
        static_cast<int64_t*>(score), static_cast<U*>(vals), n, row_bytes / unit, use_digest);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}
