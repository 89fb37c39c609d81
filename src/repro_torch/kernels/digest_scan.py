"""digest_scan: the metadata-only locate of each query in one bucket row
(CUDA source ``csrc/digest_scan.cu``).

Replaces ``digest_scan_tlp`` and ``digest_scan_pipeline``
(``src/repro/kernels/digest_scan.py``), one function on two TPU schedules:
digest pre-filter, full-key confirm, first matching slot.  Like the TPU
kernel it always filters by digest and treats no query key specially.
"""

from __future__ import annotations

import torch

from repro_torch.core.find import match_rows
from repro_torch.kernels import _build

NAME = "digest_scan"


def digest_scan_plain(digests, keys, buckets, qdigest, qkeys):
    """The plain PyTorch version.  Returns (slot i32 [N], found i32 [N]),
    slot 0 on a miss."""
    hit, slot = match_rows(keys, digests, buckets, qkeys, qdigest, use_digest=True)
    return slot.to(torch.int32), hit.to(torch.int32)


def digest_scan(digests, keys, buckets, qdigest, qkeys):
    """(slot, found) of each query in row `buckets[i]`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return digest_scan_plain(digests, keys, buckets, qdigest, qkeys)
    _build.check(dev.type == "cuda", f"digest_scan: unsupported device {dev}")
    b, s = keys.shape
    n = qkeys.shape[0]
    _build.check(s == 128, "digest_scan: the kernel takes 128 slots per bucket")
    _build.check_tensor("digests", digests, torch.uint8, (b, s), dev, align=4)
    _build.check_tensor("keys", keys, torch.int64, (b, s), dev, align=8)
    for name, t, dt in (("buckets", buckets, torch.int64), ("qdigest", qdigest, torch.uint8),
                        ("qkeys", qkeys, torch.int64)):
        _build.check_tensor(name, t, dt, (n,), dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    found = torch.empty_like(slot)
    if n:
        _build.launch(NAME, digests, keys, buckets, qdigest, qkeys, slot, found, n)
    return slot, found
