"""The inserter's row kernels (CUDA source ``csrc/upsert_scan.cu``).

upsert_probe  replaces ``upsert_probe`` (``src/repro/kernels/upsert_scan.py``):
              per query over both candidate rows, the key match and the
              dual-bucket D1/D2 target, each only where the caller asks for
              it (``mode``): the locate stage takes the match, the select
              stage the target on its miss lanes (``lanes``).
claim_scan    replaces ``claim_scan`` (same file): the rank-r slot of a
              target row under the total victim order (occupied, score,
              key, slot), with its occupancy, score and key.
"""

from __future__ import annotations

import torch

from repro_torch.core import merge
from repro_torch.core.find import match_rows
from repro_torch.kernels import _build

PROBE = "upsert_probe"
CLAIM = "claim_scan"
# upsert_probe's outputs by mode: "both" is the TPU kernel's whole function
PROBE_MODES = {"both": 0, "match": 1, "target": 2}


def _check_planes(dev, b, s, planes):
    _build.check(s == 128, "the upsert kernels take 128 slots per bucket")
    for name, t, dt in planes:   # rows are read in 16-byte words
        _build.check_tensor(name, t, dt, (b, s), dev, align=16)


def upsert_probe_plain(digests, keys, scores, bucket1, bucket2, qdigest=None, qkeys=None,
                       use_digest: bool = True, *, mode: str = "both", lanes=None):
    """The plain PyTorch version.  Returns (found, hit_sel, hit_slot,
    tgt_sel), int32 [N], with None for the outputs `mode` does not ask for:
    "match" gives the first three (hit_sel is 1 on a miss, as in the
    reference), "target" the last, "both" all four.  The target mode reads
    no query (qdigest and qkeys may be None); `lanes` (bool [N], optional)
    gates it: an off lane reports tgt_sel 0."""
    _build.check(mode in PROBE_MODES, f"upsert_probe: unknown mode {mode!r}")
    _build.check(lanes is None or mode != "match", "upsert_probe: the lane gate is the target pass's")
    found = hit_sel = hit_slot = tgt = None
    i32 = torch.int32
    if mode != "target":
        hit1, slot1 = match_rows(keys, digests, bucket1, qkeys, qdigest, use_digest)
        hit2, slot2 = match_rows(keys, digests, bucket2, qkeys, qdigest, use_digest)
        found, hit_sel = (hit1 | hit2).to(i32), (~hit1).to(i32)
        hit_slot = torch.where(hit1, slot1, torch.where(hit2, slot2, 0)).to(i32)
    if mode != "match":
        s = keys.shape[1]
        occ1, min1 = merge.bucket_stats(keys[bucket1], scores[bucket1])
        occ2, min2 = merge.bucket_stats(keys[bucket2], scores[bucket2])
        any_free = (occ1 < s) | (occ2 < s)
        t = torch.where(any_free, occ2 < occ1, min2 < min1)
        tgt = (t if lanes is None else t & lanes).to(i32)
    return found, hit_sel, hit_slot, tgt


def upsert_probe(digests, keys, scores, bucket1, bucket2, qdigest=None, qkeys=None,
                 use_digest: bool = True, *, mode: str = "both", lanes=None):
    """Fused probe (see ``upsert_probe_plain`` for the modes).  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    dev = bucket1.device
    if dev.type == "cpu":
        return upsert_probe_plain(digests, keys, scores, bucket1, bucket2, qdigest, qkeys,
                                  use_digest, mode=mode, lanes=lanes)
    _build.check(dev.type == "cuda", f"upsert_probe: unsupported device {dev}")
    _build.check(mode in PROBE_MODES, f"upsert_probe: unknown mode {mode!r}")
    b, s = keys.shape
    n = bucket1.shape[0]
    _check_planes(dev, b, s, (("digests", digests, torch.uint8), ("keys", keys, torch.int64),
                              ("scores", scores, torch.int64)))
    inputs = [("bucket1", bucket1, torch.int64), ("bucket2", bucket2, torch.int64)]
    if mode != "target":
        inputs += [("qdigest", qdigest, torch.uint8), ("qkeys", qkeys, torch.int64)]
    else:   # the target pass reads no query
        qdigest = qkeys = None
    if lanes is not None:
        _build.check(mode != "match", "upsert_probe: the lane gate is the target pass's")
        inputs.append(("lanes", lanes, torch.bool))
    for name, t, dt in inputs:
        _build.check_tensor(name, t, dt, (n,), dev)
    new = lambda: torch.empty(n, dtype=torch.int32, device=dev)
    match = [new() for _ in range(3)] if mode != "target" else [None] * 3
    tgt = new() if mode != "match" else None
    if n:
        _build.launch(PROBE, digests, keys, scores, bucket1, bucket2, qdigest, qkeys, lanes,
                      *match, tgt, n, int(use_digest), PROBE_MODES[mode])
    return (*match, tgt)


def claim_scan_plain(keys, scores, buckets, rank):
    """The plain PyTorch version.  Returns (slot i32, occupied i32,
    score i64, key i64), each [N]; `rank` is clipped to [0, S)."""
    slot, occ, score, key = merge.victim_rows_at_rank(keys[buckets], scores[buckets], rank)
    return slot.to(torch.int32), occ.to(torch.int32), score, key


def claim_scan(keys, scores, buckets, rank):
    """Rank-r victim of each target row.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    dev = buckets.device
    if dev.type == "cpu":
        return claim_scan_plain(keys, scores, buckets, rank)
    _build.check(dev.type == "cuda", f"claim_scan: unsupported device {dev}")
    b, s = keys.shape
    n = buckets.shape[0]
    _check_planes(dev, b, s, (("keys", keys, torch.int64), ("scores", scores, torch.int64)))
    _build.check_tensor("buckets", buckets, torch.int64, (n,), dev)
    _build.check_tensor("rank", rank, torch.int64, (n,), dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty_like(slot)
    score = torch.empty(n, dtype=torch.int64, device=dev)
    key = torch.empty_like(score)
    if n:
        _build.launch(CLAIM, keys, scores, buckets, rank, slot, occ, score, key, n)
    return slot, occ, score, key
