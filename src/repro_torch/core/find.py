"""Digest-filtered lookup (paper §3.2, Algorithm 1): the plain PyTorch path.

For every query key, gather its candidate bucket row(s), compare the 8-bit
digests, and confirm the full 64-bit key.  A miss is definitive after one
row (single-bucket mode) or two (dual-bucket mode); in dual mode a hit in
the primary bucket wins.  The CUDA kernels in ``repro_torch.kernels``
compute the same functions and are held bit-identical to these.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import table as table_mod
from repro_torch.core import u64
from repro_torch.core.table import HKVConfig, HKVState


class Probe(NamedTuple):
    """Hash-derived routing of a batch of keys."""

    bucket1: torch.Tensor   # int64 [N] primary bucket
    bucket2: torch.Tensor   # int64 [N] secondary bucket (== bucket1 in single mode)
    digest: torch.Tensor    # uint8 [N]
    valid: torch.Tensor     # bool  [N] key is not the EMPTY sentinel


class Locate(NamedTuple):
    found: torch.Tensor     # bool  [N]
    bucket: torch.Tensor    # int64 [N] bucket holding the key (bucket1 on a miss)
    slot: torch.Tensor      # int64 [N] slot holding the key (0 on a miss)
    row: torch.Tensor       # int64 [N] value row = bucket * S + slot


def probe_keys(cfg: HKVConfig, keys: torch.Tensor) -> Probe:
    h1, h2 = u64.hash_pair(keys)
    b1 = u64.bucket_from_hash(h1, cfg.num_buckets)
    b2 = u64.bucket_from_hash(h2, cfg.num_buckets) if cfg.buckets_per_key == 2 else b1
    return Probe(bucket1=b1, bucket2=b2, digest=u64.digest_from_hash(h1),
                 valid=~u64.empty_lanes(keys))


def match_lanes(keys: torch.Tensor, q: torch.Tensor,
                digests: Optional[torch.Tensor] = None,
                q_digest: Optional[torch.Tensor] = None) -> torch.Tensor:
    """THE key-match formula: full 64-bit key equality, conjoined with the
    digest pre-filter when digests are given.  Arguments broadcast."""
    m = keys == q
    if digests is not None:
        m = m & (digests == q_digest)
    return m


def match_rows(keys: torch.Tensor, digests: torch.Tensor, bucket: torch.Tensor,
               q: torch.Tensor, q_digest: torch.Tensor, use_digest: bool = True):
    """(hit [N], first matching slot [N], 0 if none) of queries `q` within
    rows `bucket` of the key plane, digest-filtered when `use_digest`."""
    if use_digest:
        m = match_lanes(keys[bucket], q[:, None], digests[bucket], q_digest[:, None])
    else:
        m = match_lanes(keys[bucket], q[:, None])
    return m.any(dim=-1), m.to(torch.uint8).argmax(dim=-1)


def locate(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
           probe: Optional[Probe] = None) -> Locate:
    """Which (bucket, slot) holds each key, if any (hit1 wins over hit2)."""
    if probe is None:
        probe = probe_keys(cfg, keys)
    hit1, slot1 = match_rows(state.keys, state.digests, probe.bucket1, keys,
                             probe.digest, cfg.use_digest)
    if cfg.buckets_per_key == 2:
        hit2, slot2 = match_rows(state.keys, state.digests, probe.bucket2, keys,
                                 probe.digest, cfg.use_digest)
        found = (hit1 | hit2) & probe.valid
        bucket = torch.where(hit1 | ~hit2, probe.bucket1, probe.bucket2)
        slot = torch.where(hit1, slot1, torch.where(hit2, slot2, 0))
    else:
        found = hit1 & probe.valid
        bucket = probe.bucket1
        slot = torch.where(hit1, slot1, 0)
    return Locate(found=found, bucket=bucket, slot=slot,
                  row=table_mod.value_row_index(bucket, slot, state.slots_per_bucket))


def gather_rows(values: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """THE masked row gather: values[rows[i]] where mask[i], zeros
    elsewhere (`rows` within the plane)."""
    out = values[rows]
    return torch.where(mask[:, None], out, torch.zeros_like(out))


def gather_values(state: HKVState, loc: Locate, dim: Optional[int] = None,
                  tier: str = "hbm") -> torch.Tensor:
    """Position-addressed value gather; missing keys read zeros.  On the
    'hmem' tier only the located rows cross from the host."""
    rows = table_mod.tier_gather(tier, state.values, loc.row)
    rows = torch.where(loc.found[:, None], rows, torch.zeros_like(rows))
    return rows if dim is None else rows[:, :dim]
