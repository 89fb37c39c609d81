"""digest_scan: the metadata-only locate of each query in one bucket row,
or in both candidate rows with the merge (CUDA source
``csrc/digest_scan.cu``).

Replaces ``digest_scan_tlp`` and ``digest_scan_pipeline``
(``src/repro/kernels/digest_scan.py``), one function on two TPU schedules:
digest pre-filter, full-key confirm, first matching slot.  Like the TPU
kernel it always filters by digest and treats no query key specially.

The TPU locate launches it once per candidate bucket and merges the two
results (``src/repro/kernels/ops.py::locate_kernel``).  Given ``buckets2``,
one launch here probes both rows and merges them the same way: a hit in
``buckets`` wins, ``sel`` = 1 where only ``buckets2`` holds the key, and
slot 0 on a miss.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.find import match_rows
from repro_torch.kernels import _build

NAME = "digest_scan"


def digest_scan_plain(digests, keys, buckets, qdigest, qkeys, buckets2=None):
    """The plain PyTorch version.  Returns (slot i32 [N], found i32 [N]),
    slot 0 on a miss; with `buckets2`, (slot, found, sel i32 [N]) merged
    over both rows, as the reference's locate merges two launches."""
    hit, slot = match_rows(keys, digests, buckets, qkeys, qdigest, use_digest=True)
    if buckets2 is None:
        return slot.to(torch.int32), hit.to(torch.int32)
    hit2, slot2 = match_rows(keys, digests, buckets2, qkeys, qdigest, use_digest=True)
    sel = ~hit & hit2
    slot = torch.where(hit, slot, torch.where(hit2, slot2, 0))
    return slot.to(torch.int32), (hit | hit2).to(torch.int32), sel.to(torch.int32)


def digest_scan(digests, keys, buckets, qdigest, qkeys, buckets2: Optional[torch.Tensor] = None):
    """(slot, found) of each query in row `buckets[i]`, or with `buckets2`
    (slot, found, sel) over both rows in one launch.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return digest_scan_plain(digests, keys, buckets, qdigest, qkeys, buckets2)
    _build.check(dev.type == "cuda", f"digest_scan: unsupported device {dev}")
    b, s = keys.shape
    n = qkeys.shape[0]
    _build.check(s == 128, "digest_scan: the kernel takes 128 slots per bucket")
    _build.check_tensor("digests", digests, torch.uint8, (b, s), dev, align=16)
    _build.check_tensor("keys", keys, torch.int64, (b, s), dev, align=8)
    for name, t, dt in (("buckets", buckets, torch.int64), ("qdigest", qdigest, torch.uint8),
                        ("qkeys", qkeys, torch.int64)):
        _build.check_tensor(name, t, dt, (n,), dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    found = torch.empty_like(slot)
    sel = None
    if buckets2 is not None:
        _build.check_tensor("buckets2", buckets2, torch.int64, (n,), dev)
        sel = torch.empty_like(slot)
    if n:
        _build.launch(NAME, digests, keys, buckets, buckets2, qdigest, qkeys, slot, found, sel, n)
    return (slot, found) if sel is None else (slot, found, sel)
