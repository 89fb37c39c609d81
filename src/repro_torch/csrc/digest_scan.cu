// digest_scan: metadata-only locate of each query in ONE bucket row.
//
// Replaces the TPU kernels digest_scan_tlp and digest_scan_pipeline
// (src/repro/kernels/digest_scan.py:66 and :159), one function on two TPU
// schedules: per query, the 8-bit digest pre-filter over the row's 128
// digests, a full 64-bit key compare only where the digest matched, and
// (slot, found) with the lowest matching slot (the reference's argmax is
// the first match; slot 0 on a miss).  It sits behind locate_kernel:
// find_ptr, contains, and the single-bucket upsert's locate stage, one
// launch per candidate bucket.  Like the TPU kernel it always filters by
// digest and treats no key specially, and an EMPTY query key still misses:
// the only slots whose key equals it are free ones, whose digest 0xFF is
// not the EMPTY key's digest 28, so the filter skips them; a resident slot
// that happens to carry digest 28 (about 1 in 256) fails the full-key
// compare.
//
// Bound on this card: bytes.  A query needs its 128-byte digest line, the
// keys whose digest matched (one on a hit, half a false candidate a row on
// average), its inputs and two int32 outputs; 32 byte compares a lane and
// a ballot are negligible.  One warp per query: the digest line is one
// coalesced 128-byte load (a 32-bit word a lane), keys are read only
// where the digest matched (hkv::warp_match_row, shared with find_scan).
// Each query's row is a dependent random read, so latency is hidden only
// by the warps in flight (8 a block, one block per 8 queries).
#include "hkv_common.cuh"

namespace {

__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock)
digest_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ buckets, const uint8_t* __restrict__ qdigest,
                   const int64_t* __restrict__ qkeys, int32_t* __restrict__ slot_out,
                   int32_t* __restrict__ found_out, int64_t n) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                    threadIdx.x / hkv::kWarp;
  if (q >= n) return;  // whole warps leave together
  const int slot = hkv::warp_match_row(digests, keys, buckets[q], qdigest[q], qkeys[q],
                                       /*use_digest=*/1, lane);
  if (lane == 0) {
    found_out[q] = slot >= 0 ? 1 : 0;
    slot_out[q] = slot >= 0 ? slot : 0;
  }
}

}  // namespace

extern "C" int hkv_digest_scan(const void* digests, const void* keys, const void* buckets,
                               const void* qdigest, const void* qkeys, void* slot,
                               void* found, int64_t n, void* stream) {
  digest_scan_kernel<<<hkv::blocks_for_warps(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(buckets), static_cast<const uint8_t*>(qdigest),
      static_cast<const int64_t*>(qkeys), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(found), n);
  return static_cast<int>(cudaGetLastError());
}
