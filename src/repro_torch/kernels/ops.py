"""The table ops' kernel-backed stages.

  find_fused_kernel   the reader: one find_scan launch resolves match,
                      score readout and value copy;
  kernel_stages       the inserter's stages for ``core.merge.upsert``:
                      locate and select_target on upsert_probe (dual-bucket
                      mode), victim_at_rank on claim_scan, scatter_values on
                      scatter_rows.  Per dual-bucket insert_or_assign: two
                      upsert_probe, one claim_scan and two scatter_rows
                      launches.

The wrappers run their plain versions on CPU tensors, so the CPU tests
reach this module too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core.table import HKVConfig, HKVState
from repro_torch.kernels.find_scan import find_scan
from repro_torch.kernels.scatter import scatter_rows
from repro_torch.kernels.upsert_scan import claim_scan, upsert_probe


class FusedFind(NamedTuple):
    values: torch.Tensor     # [N, dim + aux] full-width hit rows (zeros on miss)
    found: torch.Tensor      # bool [N]
    bucket: torch.Tensor     # int64 [N] bucket holding the key (bucket1 on miss)
    slot: torch.Tensor       # int64 [N] slot holding the key (0 on miss)
    scores: torch.Tensor     # int64 [N] hit scores (0 on miss)


def find_fused_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor) -> FusedFind:
    probe = find_mod.probe_keys(cfg, keys)
    found, sel, slot, score, vals = find_scan(
        state.digests, state.keys, state.scores, state.values,
        probe.bucket1, probe.bucket2, probe.digest, keys, use_digest=cfg.use_digest)
    # find_scan already reports an EMPTY padding key as a miss, with zero
    # values and score; found keeps the reference's mask by key validity
    return FusedFind(
        values=vals,
        found=found.to(torch.bool) & probe.valid,
        bucket=torch.where(sel == 1, probe.bucket2, probe.bucket1),
        slot=slot.to(torch.int64),
        scores=score,
    )


def kernel_stages(cfg: HKVConfig, device: torch.device) -> merge_mod.UpsertStages:
    """Kernel-backed implementations of the upsert stages."""
    s = cfg.slots_per_bucket
    if cfg.buckets_per_key == 1 and device.type == "cuda":
        raise NotImplementedError(
            "single-bucket insert_or_assign on the card needs the digest_scan "
            "kernel, which is not ported yet; use buckets_per_key=2 or backend='plain'")

    def locate(state: HKVState, _cfg, keys, probe: find_mod.Probe) -> find_mod.Locate:
        if cfg.buckets_per_key == 1:   # CPU only (see above): the plain locate
            return find_mod.locate(state, cfg, keys, probe)
        found, hit_sel, hit_slot, _tgt = upsert_probe(
            state.digests, state.keys, state.scores, probe.bucket1, probe.bucket2,
            probe.digest, keys, use_digest=cfg.use_digest)
        hit = found.to(torch.bool)
        bucket = torch.where(hit & (hit_sel == 1), probe.bucket2, probe.bucket1)
        slot = hit_slot.to(torch.int64)
        return find_mod.Locate(found=hit & probe.valid, bucket=bucket, slot=slot,
                               row=bucket * s + slot)

    def select_target(state: HKVState, _cfg, probe: find_mod.Probe) -> torch.Tensor:
        if cfg.buckets_per_key == 1:
            return probe.bucket1
        # a stats-only pass: the match result is unused
        _f, _hs, _sl, tgt = upsert_probe(
            state.digests, state.keys, state.scores, probe.bucket1, probe.bucket2,
            torch.zeros_like(probe.digest), torch.zeros_like(probe.bucket1),
            use_digest=cfg.use_digest)
        return torch.where(tgt == 1, probe.bucket2, probe.bucket1)

    def victim_at_rank(state: HKVState, _cfg, buckets, rank):
        slot, occ, score, key = claim_scan(state.keys, state.scores, buckets,
                                           rank.clamp(0, s - 1))
        return slot.to(torch.int64), occ.to(torch.bool), score, key

    def scatter_values(_cfg, values, rows, updates, mask) -> None:
        scatter_rows(values, rows, updates.to(values.dtype).contiguous(), mask, add=False)

    return merge_mod.UpsertStages(locate=locate, select_target=select_target,
                                  victim_at_rank=victim_at_rank,
                                  scatter_values=scatter_values)
