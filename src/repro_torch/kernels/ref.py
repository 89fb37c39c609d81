"""The kernels' oracles, under the reference's names
(``src/repro/kernels/ref.py``; re-exported as ``kernels.ops.ref``).

Each name is bound to the plain PyTorch version that sits beside its
kernel: the semantic ground truth the kernel is held against, on the card
in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``, and on the CPU
against the JAX package.  Where a plain version's convention differs from
the JAX oracle's:

- keys and scores are one int64 word each (the unsigned 64-bit value's
  bits), where the oracles take (hi, lo) uint32 pairs: ``digest_scan_ref``
  takes (digests, keys, buckets, qdigest, qkeys); ``find_scan_ref``
  returns (found, sel, slot, score, values), one score word;
  ``bucket_stats_ref`` takes (keys, scores) and returns (occupancy, min
  score, argmin slot);
- ``digest_scan_ref`` also takes an optional second bucket row and then
  merges both rows as the reference's locate merges its two launches;
- ``find_scan_ref`` reports a miss on an EMPTY query, where the oracle
  matches an empty slot and its wrapper masks the lane afterwards;
- ``update_scan_ref`` and ``scatter_rows_ref`` write the value plane in
  place: the first returns only ``found``, the second nothing;
- ``gather_rows_ref`` takes rows within the plane (its callers clamp) and
  an optional width, the columns it returns.
"""

from repro_torch.kernels.digest_scan import digest_scan_plain as digest_scan_ref
from repro_torch.kernels.find_scan import find_scan_plain as find_scan_ref
from repro_torch.kernels.gather import gather_rows_plain as gather_rows_ref
from repro_torch.kernels.scatter import scatter_rows_plain as scatter_rows_ref
from repro_torch.kernels.score_scan import bucket_stats_plain as bucket_stats_ref
from repro_torch.kernels.update_scan import update_scan_plain as update_scan_ref

__all__ = ["digest_scan_ref", "find_scan_ref", "update_scan_ref", "gather_rows_ref",
           "scatter_rows_ref", "bucket_stats_ref"]
