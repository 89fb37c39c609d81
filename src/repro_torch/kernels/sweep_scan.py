"""sweep_match: the maintenance sweeps' whole-table predicate pass (CUDA
source ``csrc/sweep_scan.cu``).

Replaces ``sweep_match`` (``src/repro/kernels/sweep_scan.py``): the
live-gated match mask of a ``SweepPredicate`` over every slot, and the
per-bucket match count.  The mask is bool (the TPU kernel wrote int32).
"""

from __future__ import annotations

import torch

from repro_torch.core import u64
from repro_torch.core.predicates import SweepPredicate
from repro_torch.kernels import _build

NAME = "sweep_match"


def sweep_match_plain(keys, scores, pred: SweepPredicate):
    """The plain PyTorch version.  Returns (match bool [B, S], count
    int32 [B])."""
    m = pred.matches(keys, scores) & ~u64.empty_lanes(keys)
    return m, m.sum(dim=1, dtype=torch.int32)


def sweep_match(keys, scores, pred: SweepPredicate):
    """Predicate mask and per-bucket count.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    dev = keys.device
    if dev.type == "cpu":
        return sweep_match_plain(keys, scores, pred)
    _build.check(dev.type == "cuda", f"sweep_match: unsupported device {dev}")
    b, s = keys.shape
    _build.check(s == 128, "sweep_match: the kernel takes 128 slots per bucket")
    _build.check_tensor("keys", keys, torch.int64, (b, s), dev, align=16)
    _build.check_tensor("scores", scores, torch.int64, (b, s), dev, align=16)
    match = torch.empty((b, s), dtype=torch.bool, device=dev)
    count = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _build.launch(NAME, keys, scores, match, count, b, pred.kind_index, pred.a, pred.b)
    return match, count
