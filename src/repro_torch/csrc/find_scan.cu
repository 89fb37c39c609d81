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
//     the value row, 16 bytes a lane (V = 32: one 128-byte row in one
//     vector load and store a lane) where the wrapper found V*4 a multiple
//     of 16 and both planes 16-byte aligned, else in 4-byte words (V = 33,
//     the training plane).
#include "hkv_common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
find_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                 const int64_t* __restrict__ scores, const float* __restrict__ values,
                 const int64_t* __restrict__ bucket1, const int64_t* __restrict__ bucket2,
                 const uint8_t* __restrict__ qdigest, const int64_t* __restrict__ qkeys,
                 int32_t* __restrict__ found, int32_t* __restrict__ sel_out,
                 int32_t* __restrict__ slot_out, int64_t* __restrict__ score_out,
                 float* __restrict__ vals_out, int64_t n, int64_t v, int use_digest) {
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
  const int width = static_cast<int>(kVec ? v / 4 : v);
  if (kVec) {
    float4* dst = reinterpret_cast<float4*>(vals_out + q * v);
    if (hit) {
      const float4* src = reinterpret_cast<const float4*>(values + row * v);
      for (int d = g; d < width; d += hkv::kGroup) dst[d] = src[d];
    } else {
      for (int d = g; d < width; d += hkv::kGroup) dst[d] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    float* dst = vals_out + q * v;
    if (hit) {
      const float* src = values + row * v;
      for (int d = g; d < width; d += hkv::kGroup) dst[d] = src[d];
    } else {
      for (int d = g; d < width; d += hkv::kGroup) dst[d] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int hkv_find_scan(const void* digests, const void* keys, const void* scores,
                             const void* values, const void* bucket1, const void* bucket2,
                             const void* qdigest, const void* qkeys, void* found, void* sel,
                             void* slot, void* score, void* vals, int64_t n, int64_t v,
                             int use_digest, int vec, void* stream) {
  auto kernel = vec ? find_scan_kernel<true> : find_scan_kernel<false>;
  kernel<<<hkv::blocks_for_groups(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(scores), static_cast<const float*>(values),
      static_cast<const int64_t*>(bucket1), static_cast<const int64_t*>(bucket2),
      static_cast<const uint8_t*>(qdigest), static_cast<const int64_t*>(qkeys),
      static_cast<int32_t*>(found), static_cast<int32_t*>(sel), static_cast<int32_t*>(slot),
      static_cast<int64_t*>(score), static_cast<float*>(vals), n, v, use_digest);
  return static_cast<int>(cudaGetLastError());
}
