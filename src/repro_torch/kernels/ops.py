"""The table ops' kernel-backed stages.

  find_fused_kernel   the reader: one find_scan launch resolves match,
                      score readout and value copy (find, find_rows); on a
                      host-memory value plane ('hmem') locate_kernel and
                      one gather_rows launch over the host link instead, as
                      the reference routes that tier;
  find_many_kernel    T tables of one geometry in ONE find_scan launch
                      (the multi-table entry, ``find_scan_many``): one
                      FusedFind a table, equal to T find_fused_kernel calls;
  locate_kernel       the metadata-only locate: one digest_scan launch over
                      both candidate buckets (find_ptr, contains, the
                      single-bucket upsert's locate stage, and the locate
                      of the 'hmem' tier's readers and updaters);
  gather_rows_kernel  the value gather at a known locate (find and
                      find_rows at a caller's loc, find_or_insert's
                      readback);
  sweep_mask_kernel   the sweeps' live-gated predicate mask (erase_if,
                      evict_if), one sweep_match launch;
  update_rows_kernel  the updater's fused gradient step: one update_scan
                      launch probes, applies the sparse optimizer and
                      writes the rows back (update_rows, apply_grads); on
                      an 'hmem' plane the composed step below;
  update_composed_kernel  the same step composed as locate_kernel,
                      gather_rows, the optimizer in plain PyTorch on the
                      card and scatter_rows: the 'hmem' tier's updater, and
                      the fused pass's launch-count and parity baseline;
  assign_kernel       assign / assign_add of unique keys: locate_kernel and
                      one scatter_rows launch (the reference wrapper's
                      convention: aux columns zero-padded; the ops'
                      ``assign`` keeps the stored aux columns and stays
                      plain, as the reference's does);
  bucket_stats_kernel per-bucket occupancy and minimum live score, one
                      bucket_stats launch (no op calls it);
  kernel_stages       the inserter's stages for ``core.merge.upsert``:
                      dual-bucket mode locates on upsert_probe's match mode
                      and selects on its target mode, gated to the miss
                      lanes; single-bucket mode locates on digest_scan and
                      targets bucket1; victim_at_rank on claim_scan,
                      gather_values on gather_rows, scatter_values on
                      scatter_rows (on either tier's plane).  Per
                      insert_or_assign: two upsert_probe (dual; the target
                      pass launches without a miss too, and works on no
                      lane) or one digest_scan (single), one claim_scan (on
                      the miss lanes; none without a miss) and two
                      scatter_rows launches; return_evicted adds one
                      gather_rows.

The wrappers run their plain versions on CPU tensors, so the CPU tests
reach this module too.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.table import HKVConfig, HKVState
from repro_torch.kernels.digest_scan import digest_scan
from repro_torch.kernels.find_scan import find_scan, find_scan_many
from repro_torch.kernels.gather import gather_rows
from repro_torch.kernels.scatter import scatter_rows
from repro_torch.kernels.score_scan import bucket_stats
from repro_torch.kernels.sweep_scan import sweep_match
from repro_torch.kernels.update_scan import update_scan
from repro_torch.kernels.upsert_scan import claim_scan, upsert_probe


class FusedFind(NamedTuple):
    values: torch.Tensor     # [N, dim + aux] full-width hit rows (zeros on miss)
    found: torch.Tensor      # bool [N]
    bucket: torch.Tensor     # int64 [N] bucket holding the key (bucket1 on miss)
    slot: torch.Tensor       # int64 [N] slot holding the key (0 on miss)
    scores: torch.Tensor     # int64 [N] hit scores (0 on miss)


def find_fused_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor) -> FusedFind:
    if cfg.value_tier == "hmem":
        # the value plane is in host memory: locate on the card, then only
        # the hit rows cross the host link
        loc = locate_kernel(state, cfg, keys)
        return FusedFind(values=gather_rows_kernel(state, loc, state.values.shape[1]),
                         found=loc.found, bucket=loc.bucket, slot=loc.slot,
                         scores=torch.where(loc.found, state.scores[loc.bucket, loc.slot], 0))
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


def find_many_kernel(states: Sequence[HKVState], cfg: HKVConfig,
                     keys_list: Sequence[torch.Tensor]) -> list[FusedFind]:
    """T same-geometry tables in ONE find_scan launch: the embedding layer
    keeps a table a feature, and a serving wave finds every feature's keys
    at once.  The reference stacks the tables' planes along the bucket
    axis and offsets each probe by t*B; here the kernel gets the tables'
    base addresses, so no plane is copied (at config B a stack would copy
    about 19.5 GB a table).  Returns one `FusedFind` a table, with
    table-local bucket and slot, equal to `find_fused_kernel` on each."""
    if not states:
        return []
    if cfg.value_tier != "hbm":
        raise ValueError("find_many_kernel requires the hbm value tier")
    b, s = cfg.num_buckets, cfg.slots_per_bucket
    for st in states:
        if tuple(st.keys.shape) != (b, s) or st.values.shape != states[0].values.shape:
            raise ValueError("find_many_kernel requires same-geometry tables")
    probes = [find_mod.probe_keys(cfg, k) for k in keys_list]
    counts = [k.shape[0] for k in keys_list]
    cat = lambda f: torch.cat([f(p) for p in probes])  # noqa: E731
    found, sel, slot, score, vals = find_scan_many(
        [(st.digests, st.keys, st.scores, st.values) for st in states],
        cat(lambda p: p.bucket1), cat(lambda p: p.bucket2), cat(lambda p: p.digest),
        torch.cat(list(keys_list)), counts, use_digest=cfg.use_digest)
    out, start = [], 0
    for p, c in zip(probes, counts):
        sl = slice(start, start + c)
        start += c
        out.append(FusedFind(values=vals[sl], found=found[sl].to(torch.bool) & p.valid,
                             bucket=torch.where(sel[sl] == 1, p.bucket2, p.bucket1),
                             slot=slot[sl].to(torch.int64), scores=score[sl]))
    return out


def locate_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                  probe: find_mod.Probe | None = None) -> find_mod.Locate:
    """Drop-in for ``core.find.locate`` on one digest_scan launch over the
    candidate buckets, a hit in bucket1 winning (always digest-filtered,
    like the reference's locate kernel)."""
    if probe is None:
        probe = find_mod.probe_keys(cfg, keys)
    if cfg.buckets_per_key == 2:
        slot, found, sel = digest_scan(state.digests, state.keys, probe.bucket1, probe.digest,
                                       keys, probe.bucket2)
        bucket = torch.where(sel == 1, probe.bucket2, probe.bucket1)
    else:
        slot, found = digest_scan(state.digests, state.keys, probe.bucket1, probe.digest, keys)
        bucket = probe.bucket1
    slot = slot.to(torch.int64)
    return find_mod.Locate(found=found.to(torch.bool) & probe.valid, bucket=bucket, slot=slot,
                           row=bucket * cfg.slots_per_bucket + slot)


def gather_rows_kernel(state: HKVState, loc: find_mod.Locate, width: int) -> torch.Tensor:
    """The value rows at `loc` (zeros where not found), first `width`
    columns: the kernel reads only those."""
    return gather_rows(state.values, loc.row, loc.found, width)


def sweep_mask_kernel(state: HKVState, pred: SweepPredicate) -> torch.Tensor:
    """bool [B, S]: live entries matching `pred`."""
    match, _count = sweep_match(state.keys, state.scores, pred)
    return match


class UpdateRows(NamedTuple):
    """Which lanes trained; the value plane was updated in place."""

    found: torch.Tensor      # bool [N] the key was resident and its row trained


def update_rows_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                       grads: torch.Tensor, opt) -> UpdateRows:
    """The fused updater pass: one update_scan launch.  PRECONDITION: the
    valid keys are unique and `grads` summed per key.  Misses and EMPTY
    padding write nothing: the key-validity gate goes into the kernel,
    since an updater cannot mask its writes afterwards.  On an 'hmem'
    plane: the composed step, as the reference routes that tier."""
    if cfg.value_tier == "hmem":
        return update_composed_kernel(state, cfg, keys, grads, opt)
    probe = find_mod.probe_keys(cfg, keys)   # bucket2 = bucket1 in single mode
    found = update_scan(state.digests, state.keys, state.values, probe.bucket1, probe.bucket2,
                        probe.digest, keys, probe.valid,
                        grads.to(state.values.dtype).contiguous(), opt, cfg.dim,
                        use_digest=cfg.use_digest)
    return UpdateRows(found=found.to(torch.bool))


def update_composed_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                           grads: torch.Tensor, opt) -> UpdateRows:
    """The updater composed of separate passes: locate_kernel, gather_rows,
    the optimizer in plain PyTorch on the card, scatter_rows.  The 'hmem'
    tier's updater (its rows cross the host link twice), and the fused
    pass's launch-count and parity baseline, as in the reference."""
    loc = locate_kernel(state, cfg, keys)
    rows_idx = loc.row.clamp(0, state.values.shape[0] - 1)
    rows = gather_rows(state.values, rows_idx, loc.found)
    new_rows = opt.apply(rows, grads, cfg.dim).to(state.values.dtype)
    scatter_rows(state.values, rows_idx, new_rows.contiguous(), loc.found, add=False)
    return UpdateRows(found=loc.found)


def _assign_rows(state: HKVState, values: torch.Tensor) -> torch.Tensor:
    """Caller rows in the plane's dtype, aux columns zero-padded."""
    values = values.to(state.values.dtype)
    vdim = state.values.shape[1]
    if values.shape[1] < vdim:
        values = torch.cat([values, values.new_zeros((values.shape[0], vdim - values.shape[1]))],
                           dim=1)
    return values.contiguous()


def assign_kernel(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, values: torch.Tensor,
                  *, add: bool = False) -> HKVState:
    """Kernel-backed updater (assign, or assign_add with `add`): one
    digest_scan locate and one scatter_rows launch, in place.
    PRECONDITION: the valid keys are unique (duplicates are the merge
    path's business).  Rows narrower than the plane are zero-padded, so
    the aux columns of a hit are zeroed (set) or kept (add): the reference
    wrapper's convention."""
    loc = locate_kernel(state, cfg, keys)
    rows = loc.row.clamp(0, state.values.shape[0] - 1)
    scatter_rows(state.values, rows, _assign_rows(state, values), loc.found, add=add)
    return state


def assign_plain(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, values: torch.Tensor,
                 *, add: bool = False) -> HKVState:
    """`assign_kernel` composed in plain PyTorch (the plain locate and an
    index write), on any device."""
    loc = find_mod.locate(state, cfg, keys)
    values = _assign_rows(state, values)
    rows, found = loc.row[loc.found], values[loc.found]
    if add:
        state.values.index_add_(0, rows, found)
    else:
        state.values[rows] = found
    return state


def bucket_stats_kernel(state: HKVState):
    """(occupancy int32 [B], minimum live score int64 [B], its slot int32
    [B]) per bucket, one bucket_stats launch."""
    return bucket_stats(state.keys, state.scores)


def kernel_stages(cfg: HKVConfig, device: torch.device) -> merge_mod.UpsertStages:
    """Kernel-backed implementations of the upsert stages."""
    s = cfg.slots_per_bucket

    def locate(state: HKVState, _cfg, keys, probe: find_mod.Probe) -> find_mod.Locate:
        if cfg.buckets_per_key == 1:
            return locate_kernel(state, cfg, keys, probe)
        found, hit_sel, hit_slot, _ = upsert_probe(
            state.digests, state.keys, state.scores, probe.bucket1, probe.bucket2,
            probe.digest, keys, use_digest=cfg.use_digest, mode="match")
        hit = found.to(torch.bool)
        bucket = torch.where(hit & (hit_sel == 1), probe.bucket2, probe.bucket1)
        slot = hit_slot.to(torch.int64)
        return find_mod.Locate(found=hit & probe.valid, bucket=bucket, slot=slot,
                               row=bucket * s + slot)

    def select_target(state: HKVState, _cfg, probe: find_mod.Probe,
                      lanes: torch.Tensor) -> torch.Tensor:
        if cfg.buckets_per_key == 1:
            return probe.bucket1
        *_, tgt = upsert_probe(state.digests, state.keys, state.scores, probe.bucket1,
                               probe.bucket2, mode="target", lanes=lanes)
        return torch.where(tgt == 1, probe.bucket2, probe.bucket1)

    def victim_at_rank(state: HKVState, _cfg, buckets, rank):
        slot, occ, score, key = claim_scan(state.keys, state.scores, buckets,
                                           rank.clamp(0, s - 1))
        return slot.to(torch.int64), occ.to(torch.bool), score, key

    def gather_values(_cfg, values, rows, mask) -> torch.Tensor:
        return gather_rows(values, rows, mask)

    def scatter_values(_cfg, values, rows, updates, mask) -> None:
        scatter_rows(values, rows, updates.to(values.dtype).contiguous(), mask, add=False)

    return merge_mod.UpsertStages(locate=locate, select_target=select_target,
                                  victim_at_rank=victim_at_rank,
                                  gather_values=gather_values,
                                  scatter_values=scatter_values)
