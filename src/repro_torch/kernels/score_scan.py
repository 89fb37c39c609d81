"""bucket_stats: per-bucket occupancy, minimum live score and its slot
(CUDA source ``csrc/score_scan.cu``).

Replaces ``bucket_stats`` (``src/repro/kernels/score_scan.py``).  Free
slots count as the all-ones score, so ties go to the lowest slot and an
all-empty bucket reports the all-ones score (int64 -1) and slot 0.  No op
calls it, in the reference or here: ``kernels.ops.bucket_stats_kernel`` is
what the tests and ``chip_smoke.py`` hold.
"""

from __future__ import annotations

import torch

from repro_torch.core import u64
from repro_torch.kernels import _build

NAME = "bucket_stats"


def bucket_stats_plain(keys, scores):
    """The plain PyTorch version (the counterpart of
    ``repro/kernels/ref.py::bucket_stats_ref``).  Returns (occ int32 [B],
    min score int64 [B] as unsigned bits, argmin slot int32 [B])."""
    live = ~u64.empty_lanes(keys)
    occ = live.sum(dim=1, dtype=torch.int32)
    flipped = u64.flip(torch.where(live, scores, u64.U64_MAX))
    low = flipped.amin(dim=1)
    slot = (flipped == low[:, None]).to(torch.uint8).argmax(dim=1)   # the first of a tie
    return occ, u64.flip(low), slot.to(torch.int32)


def bucket_stats(keys, scores):
    """Per-bucket stats.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    dev = keys.device
    if dev.type == "cpu":
        return bucket_stats_plain(keys, scores)
    _build.check(dev.type == "cuda", f"bucket_stats: unsupported device {dev}")
    b, s = keys.shape
    _build.check(s == 128, "bucket_stats: the kernel takes 128 slots per bucket")
    _build.check_tensor("keys", keys, torch.int64, (b, s), dev, align=16)
    _build.check_tensor("scores", scores, torch.int64, (b, s), dev, align=16)
    occ = torch.empty(b, dtype=torch.int32, device=dev)
    low = torch.empty(b, dtype=torch.int64, device=dev)
    slot = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _build.launch(NAME, keys, scores, occ, low, slot, b)
    return occ, low, slot
