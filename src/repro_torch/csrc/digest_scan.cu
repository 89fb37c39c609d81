// digest_scan: the metadata-only locate of each query, a quarter warp per
// query, over one candidate bucket row or both.
//
// Replaces the TPU kernels digest_scan_tlp and digest_scan_pipeline
// (src/repro/kernels/digest_scan.py:66 and :159), one function on two TPU
// schedules: per query, the 8-bit digest pre-filter over the row's 128
// digests, a full 64-bit key compare only where the digest matched, and
// (slot, found) with the lowest matching slot (the reference's argmax is
// the first match; slot 0 on a miss).  It sits behind locate_kernel:
// find_ptr, contains, the single-bucket upsert's locate stage, and the
// locate of every reader and updater of a table whose value plane lives
// in host memory.  The TPU locate launches the kernel once per candidate
// bucket and merges the two results; here one launch takes the second
// row too (when bucket2 is given) and merges in place: a hit in bucket1
// wins, bucket2 is probed only after a miss in bucket1 (and only if it is
// another row), and sel says which row holds the hit.  Like the TPU kernel
// it always filters by digest and treats no key specially, and an EMPTY
// query key still misses: the only slots whose key equals it are free
// ones, whose digest 0xFF is not the EMPTY key's digest 28, so the filter
// skips them; a resident slot that happens to carry digest 28 (about 1 in
// 256) fails the full-key compare.
//
// Bound on this card: bytes, and in practice latency.  A query needs its
// inputs, the 128-byte digest line of each row it probes, the keys whose
// digest matched (one on a hit, half a false candidate a row on average)
// and its outputs; 32 byte compares a lane and a ballot are negligible.
// Every access is a dependent random read (inputs, digest line, candidate
// key, second row after a miss), so the time is set by the queries in
// flight:
//   - a group of 8 lanes serves one query (hkv::group_match_row, the probe
//     find_scan, upsert_probe and update_scan share): each lane reads 16
//     digest bytes in one load and compares them bytewise, and reads a key
//     only where the digest matched;
//   - a warp serves 4 queries, and with registers capped at 32 an SM holds
//     8 blocks of 256 threads: 256 queries in flight, 4x the warp a query
//     of the earlier design;
//   - one launch for both rows: the second row's probe overlaps the other
//     groups' first-row probes, and the merge costs no extra pass.
#include "hkv_common.cuh"

namespace {

template <bool kDual>
__global__ void __launch_bounds__(hkv::kWarp * hkv::kWarpsPerBlock, hkv::kFullOccupancyBlocks)
digest_scan_kernel(const uint8_t* __restrict__ digests, const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ bucket1, const int64_t* __restrict__ bucket2,
                   const uint8_t* __restrict__ qdigest, const int64_t* __restrict__ qkeys,
                   int32_t* __restrict__ slot_out, int32_t* __restrict__ found_out,
                   int32_t* __restrict__ sel_out, int64_t n) {
  const int lane = threadIdx.x % hkv::kWarp;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * hkv::kWarpsPerBlock +
                      threadIdx.x / hkv::kWarp) * hkv::kGroupsPerWarp;
  if (q0 >= n) return;  // whole warps leave together
  const int64_t q = q0 + lane / hkv::kGroup;
  const bool in = q < n;
  const int64_t qk = in ? qkeys[q] : 0;
  const uint32_t qd = in ? qdigest[q] : 0u;
  const int64_t b1 = in ? bucket1[q] : 0;
  int slot = hkv::group_match_row(digests, keys, b1, qd, qk, /*use_digest=*/1, in, lane);
  bool sel = false;
  if constexpr (kDual) {
    const int64_t b2 = in ? bucket2[q] : 0;
    const bool second = in && slot < 0 && b2 != b1;
    const int slot2 = hkv::group_match_row(digests, keys, b2, qd, qk, 1, second, lane);
    sel = slot2 >= 0;   // only a second probe can match
    if (sel) slot = slot2;
  }
  if (!in || lane % hkv::kGroup != 0) return;   // past the last full-mask primitive
  found_out[q] = slot >= 0 ? 1 : 0;
  slot_out[q] = slot >= 0 ? slot : 0;
  if constexpr (kDual) sel_out[q] = sel ? 1 : 0;
}

template <bool kDual>
void launch(const void* digests, const void* keys, const void* bucket1, const void* bucket2,
            const void* qdigest, const void* qkeys, void* slot, void* found, void* sel,
            int64_t n, cudaStream_t stream) {
  digest_scan_kernel<kDual><<<hkv::blocks_for_groups(n), hkv::kWarp * hkv::kWarpsPerBlock, 0,
                              stream>>>(
      static_cast<const uint8_t*>(digests), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(bucket1), static_cast<const int64_t*>(bucket2),
      static_cast<const uint8_t*>(qdigest), static_cast<const int64_t*>(qkeys),
      static_cast<int32_t*>(slot), static_cast<int32_t*>(found), static_cast<int32_t*>(sel), n);
}

}  // namespace

// bucket2 and sel null: the single-row form.
extern "C" int hkv_digest_scan(const void* digests, const void* keys, const void* bucket1,
                               const void* bucket2, const void* qdigest, const void* qkeys,
                               void* slot, void* found, void* sel, int64_t n, void* stream) {
  if ((bucket2 == nullptr) != (sel == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bucket2 != nullptr) {
    launch<true>(digests, keys, bucket1, bucket2, qdigest, qkeys, slot, found, sel, n, s);
  } else {
    launch<false>(digests, keys, bucket1, bucket2, qdigest, qkeys, slot, found, sel, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
