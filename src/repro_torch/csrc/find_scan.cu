// find_scan: the fused find pass of an HKV table, one warp per query.
//
// Replaces the TPU kernels find_scan_tlp and find_scan_pipeline
// (src/repro/kernels/find_scan.py:131 and :350), which compute the same
// function on two TPU schedules.  Per query, over the candidate rows:
// digest pre-filter, full 64-bit key confirm, hit in bucket1 wins, then the
// hit slot's score and its value row at bucket*128+slot (zeros on a miss).
// An EMPTY query key is a miss here (the TPU kernel lets it match empty
// slots and its wrapper masks the result afterwards).
//
// Bound on this card: bytes.  A query needs its 128-byte digest line per
// probed row, the keys whose digest matched (one on a hit, 0.5 false
// candidates a row on average), and on a hit 8 bytes of score and V*4
// bytes of value; there is almost no arithmetic.  The design keeps the
// bytes near that floor: the digest line is one coalesced load a warp,
// keys are read only where the digest matched, the second row is probed
// only on a miss in the first, and the value row is copied by the whole
// warp, one coalesced 128-byte transaction at V=32.  Each access is a
// dependent random read, so latency is hidden only by the number of warps
// in flight (8 a block, one block per 8 queries).
#include "hkv_common.cuh"

namespace {

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
find_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                 const int64_t* __restrict__ scores, const float* __restrict__ values,
                 const int64_t* __restrict__ bucket1, const int64_t* __restrict__ bucket2,
                 const uint8_t* __restrict__ qdigest, const int64_t* __restrict__ qkeys,
                 int32_t* __restrict__ found, int32_t* __restrict__ sel_out,
                 int32_t* __restrict__ slot_out, int64_t* __restrict__ score_out,
                 float* __restrict__ vals_out, int64_t n, int64_t v, int use_digest) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (q >= n) return;  // whole warps leave together
  const int64_t qk = qkeys[q];
  const uint32_t qd = qdigest[q];
  const int64_t b1 = bucket1[q];
  const int64_t b2 = bucket2[q];
  // an EMPTY query key is padding: a miss, with no row probed
  const bool valid = qk != hkv::kEmpty;
  int64_t b = b1;
  int sel = 0;
  int slot = valid ? hkv::warp_match_row(digests, keys, b1, qd, qk, use_digest, lane) : -1;
  if (slot < 0 && valid && b2 != b1) {
    slot = hkv::warp_match_row(digests, keys, b2, qd, qk, use_digest, lane);
    if (slot >= 0) {
      sel = 1;
      b = b2;
    }
  }
  const bool hit = slot >= 0;
  const int64_t row = b * hkv::kSlots + (hit ? slot : 0);
  if (lane == 0) {
    found[q] = hit ? 1 : 0;
    sel_out[q] = sel;
    slot_out[q] = hit ? slot : 0;
    score_out[q] = hit ? scores[row] : 0;
  }
  float* dst = vals_out + q * v;
  if (hit) {
    const float* src = values + row * v;
    for (int64_t d = lane; d < v; d += hkv::kWarp) dst[d] = src[d];
  } else {
    for (int64_t d = lane; d < v; d += hkv::kWarp) dst[d] = 0.0f;
  }
}

}  // namespace

extern "C" int hkv_find_scan(const void* digests, const void* keys, const void* scores,
                             const void* values, const void* bucket1, const void* bucket2,
                             const void* qdigest, const void* qkeys, void* found, void* sel,
                             void* slot, void* score, void* vals, int64_t n, int64_t v,
                             int use_digest, void* stream) {
  find_scan_kernel<<<hkv::blocks_for_warps(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(scores), static_cast<const float*>(values),
      static_cast<const int64_t*>(bucket1), static_cast<const int64_t*>(bucket2),
      static_cast<const uint8_t*>(qdigest), static_cast<const int64_t*>(qkeys),
      static_cast<int32_t*>(found), static_cast<int32_t*>(sel), static_cast<int32_t*>(slot),
      static_cast<int64_t*>(score), static_cast<float*>(vals), n, v, use_digest);
  return static_cast<int>(cudaGetLastError());
}
