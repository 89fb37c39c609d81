"""The inserter's row kernels (CUDA source ``csrc/upsert_scan.cu``).

upsert_probe  replaces ``upsert_probe`` (``src/repro/kernels/upsert_scan.py``):
              per query over both candidate rows, the key match, occupancy,
              minimum live score and the dual-bucket D1/D2 target.
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


def _check_planes(dev, b, s, planes):
    _build.check(s == 128, "the upsert kernels take 128 slots per bucket")
    for name, t, dt in planes:   # rows are read in 4-byte (digest) and 16-byte words
        _build.check_tensor(name, t, dt, (b, s), dev, align=16)


def upsert_probe_plain(digests, keys, scores, bucket1, bucket2, qdigest, qkeys,
                       use_digest: bool = True):
    """The plain PyTorch version.  Returns (found, hit_sel, hit_slot,
    tgt_sel), int32 [N]; hit_sel is 1 on a miss, as in the reference."""
    s = keys.shape[1]

    def row(b):
        hit, slot = match_rows(keys, digests, b, qkeys, qdigest, use_digest)
        return (hit, slot, *merge.bucket_stats(keys[b], scores[b]))

    hit1, slot1, occ1, min1 = row(bucket1)
    hit2, slot2, occ2, min2 = row(bucket2)
    any_free = (occ1 < s) | (occ2 < s)
    tgt = torch.where(any_free, occ2 < occ1, min2 < min1)
    slot = torch.where(hit1, slot1, torch.where(hit2, slot2, 0))
    i32 = torch.int32
    return (hit1 | hit2).to(i32), (~hit1).to(i32), slot.to(i32), tgt.to(i32)


def upsert_probe(digests, keys, scores, bucket1, bucket2, qdigest, qkeys,
                 use_digest: bool = True):
    """Fused probe.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return upsert_probe_plain(digests, keys, scores, bucket1, bucket2, qdigest,
                                  qkeys, use_digest)
    _build.check(dev.type == "cuda", f"upsert_probe: unsupported device {dev}")
    b, s = keys.shape
    n = qkeys.shape[0]
    _check_planes(dev, b, s, (("digests", digests, torch.uint8), ("keys", keys, torch.int64),
                              ("scores", scores, torch.int64)))
    for name, t, dt in (("bucket1", bucket1, torch.int64), ("bucket2", bucket2, torch.int64),
                        ("qdigest", qdigest, torch.uint8), ("qkeys", qkeys, torch.int64)):
        _build.check_tensor(name, t, dt, (n,), dev)
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n:
        _build.launch(PROBE, digests, keys, scores, bucket1, bucket2, qdigest, qkeys,
                      *out, n, int(use_digest))
    return tuple(out)


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
