"""Batch-synchronous bucket merge: the closure of paper Algorithms 2 and 3.

This is the reference's ``core/merge.py`` batch closure, ported as far as
``insert_or_assign`` needs it:

  phase 1  keys already present are updates: score transition and value
           write at their (bucket, slot);
  phase 2  the remaining keys are insertions: per target bucket, the r-th
           best incoming key (score descending, then key ascending) is
           paired with the r-th weakest existing slot under the total
           victim order (occupied, score, key, slot) and admitted iff it
           strictly beats it (existing entries win ties).

The state is updated in place, in the reference's order of reads and
writes: phase-1 score and value writes land before ``select_target`` (its
D2 rule must see this batch's score touches), and ``victim_at_rank`` reads
before the structural scatter.

Multi-key sorts become chains of stable single-key sorts, least
significant key first; unsigned 64-bit keys sort through ``u64.flip``.
The reference's phase-2 sort is unstable, but lanes can tie on all its
keys only when they are not misses, and the order of those reaches no
output, so the stable chain gives identical results.

The heavy stages are pluggable (``UpsertStages``); ``plain_stages`` is the
PyTorch reference and ``repro_torch.kernels.ops.kernel_stages`` swaps in
the CUDA kernels.  The orchestration is shared, so the two are
bit-identical wherever the stage contracts hold.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import table as table_mod
from repro_torch.core import u64
from repro_torch.core.table import HKVConfig, HKVState

STATUS_INVALID = 0    # input slot held the EMPTY sentinel (or a duplicate's lane)
STATUS_UPDATED = 1    # key existed: value/score updated in place
STATUS_INSERTED = 2   # inserted into an empty slot
STATUS_EVICTED = 3    # inserted by evicting a minimum-score entry
STATUS_REJECTED = 4   # admission control refused the entry


class UpsertStages(NamedTuple):
    """The replaceable stages of the closure.

      locate(state, cfg, keys, probe) -> find.Locate
      select_target(state, cfg, probe) -> int64 [N] target bucket
      victim_at_rank(state, cfg, buckets, rank)
          -> (slot int64, occupied bool, score int64, key int64), each [N]
      scatter_values(cfg, values, rows, updates, mask) -> None
          values[rows[i]] = updates[i] where mask[i], in place; masked rows
          are unique within the batch.
    """

    locate: Callable
    select_target: Callable
    victim_at_rank: Callable
    scatter_values: Callable


def stable_argsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting along the last axis by `keys` lexicographically
    (first key most significant), stable: a chain of stable sorts, least
    significant key first."""
    perm = torch.argsort(keys[-1], dim=-1, stable=True)
    for k in reversed(keys[:-1]):
        perm = perm.gather(-1, torch.argsort(k.gather(-1, perm), dim=-1, stable=True))
    return perm


def _dedupe_sort(keys: torch.Tensor):
    """Sort the batch by unsigned key (stable); derive group ids, group
    multiplicities, the last writer's original index, and the mask of each
    valid group's first sorted lane."""
    n = keys.shape[0]
    idx_s = torch.argsort(u64.flip(keys), stable=True)
    keys_s = keys[idx_s]
    is_first = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_first[1:] = keys_s[1:] != keys_s[:-1]
    gid = torch.cumsum(is_first, 0) - 1
    counts = torch.zeros(n, dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, gid, torch.ones_like(gid))
    last_idx = torch.zeros(n, dtype=torch.int64, device=keys.device)
    last_idx.scatter_reduce_(0, gid, idx_s, "amax", include_self=False)
    rep_mask = is_first & ~u64.empty_lanes(keys_s)
    return keys_s, idx_s, gid, counts[gid], last_idx[gid], rep_mask


def bucket_stats(keys: torch.Tensor, scores: torch.Tensor):
    """(occupancy [N], flipped minimum live score [N]) of rows [N, S].

    Empty slots count as +inf (the all-ones score), so an empty row
    reports the all-ones sentinel; the minimum is returned in flipped
    (signed-comparable) form."""
    occ = ~u64.empty_lanes(keys)
    fmin = torch.where(occ, u64.flip(scores), u64.flip(torch.full_like(scores, u64.U64_MAX)))
    return occ.sum(dim=1), fmin.min(dim=1).values


def select_target_bucket(state: HKVState, cfg: HKVConfig,
                         probe: find_mod.Probe) -> torch.Tensor:
    """Dual-bucket two-phase selection (paper Alg. 3): while either
    candidate has a free slot, the less-occupied bucket; once both are
    full, the bucket with the lower minimum score.  Ties go to the primary."""
    if cfg.buckets_per_key == 1:
        return probe.bucket1
    s = cfg.slots_per_bucket
    occ1, min1 = bucket_stats(state.keys[probe.bucket1], state.scores[probe.bucket1])
    occ2, min2 = bucket_stats(state.keys[probe.bucket2], state.scores[probe.bucket2])
    any_free = (occ1 < s) | (occ2 < s)
    second = torch.where(any_free, occ2 < occ1, min2 < min1)
    return torch.where(second, probe.bucket2, probe.bucket1)


def victim_rows_at_rank(keys: torch.Tensor, scores: torch.Tensor,
                        rank: torch.Tensor):
    """Rank-th weakest slot of each row [N, S] under the total victim order
    (occupied asc, score asc, key asc, slot asc).  `rank` is clipped to
    [0, S).  Returns (slot, occupied, score, key), each [N]."""
    s = keys.shape[1]
    occ = ~u64.empty_lanes(keys)
    order = stable_argsort(occ.to(torch.uint8), u64.flip(scores), u64.flip(keys))
    slot = order.gather(1, rank.clamp(0, s - 1).to(torch.int64)[:, None])
    take = lambda a: a.gather(1, slot)[:, 0]
    return slot[:, 0], take(occ), take(scores), take(keys)


def plain_victim_at_rank(state: HKVState, cfg: HKVConfig, buckets: torch.Tensor,
                         rank: torch.Tensor):
    return victim_rows_at_rank(state.keys[buckets], state.scores[buckets], rank)


def plain_scatter_values(cfg: HKVConfig, values: torch.Tensor, rows: torch.Tensor,
                         updates: torch.Tensor, mask: torch.Tensor) -> None:
    values[rows[mask]] = updates[mask].to(values.dtype)


def plain_stages() -> UpsertStages:
    """The plain PyTorch implementation of every stage."""
    return UpsertStages(
        locate=lambda state, cfg, keys, probe: find_mod.locate(state, cfg, keys, probe),
        select_target=select_target_bucket,
        victim_at_rank=plain_victim_at_rank,
        scatter_values=plain_scatter_values,
    )


def upsert(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
           values: torch.Tensor, *, custom_scores: Optional[torch.Tensor] = None,
           stages: Optional[UpsertStages] = None) -> torch.Tensor:
    """insert_or_assign's batch closure, in place on `state`.

    keys   : int64 [N] (EMPTY lanes ignored; duplicates: last writer wins)
    values : [N, Dtot] rows, already padded to the plane's width
    Returns the int8 [N] status codes in batch order.
    """
    n = keys.shape[0]
    b, s = cfg.num_buckets, cfg.slots_per_bucket
    dev = keys.device
    policy = cfg.policy
    if stages is None:
        stages = plain_stages()

    table_mod.advance_clock(state)
    clock, epoch = state.clock, state.epoch

    # ---- dedupe -------------------------------------------------------------
    keys_s, idx_s, gid, count_s, last_idx_s, rep_mask = _dedupe_sort(keys)
    custom_s = None if custom_scores is None else custom_scores[last_idx_s]
    status_g = torch.zeros(n, dtype=torch.int32, device=dev)

    # ---- phase 1: hits -------------------------------------------------------
    probe_s = find_mod.probe_keys(cfg, keys_s)
    loc = stages.locate(state, cfg, keys_s, probe_s)
    hit = loc.found & rep_mask
    old_sc = state.scores[loc.bucket, loc.slot]
    new_sc = policy.update_score(old_sc, clock, epoch, count_s, custom_s)
    state.scores[loc.bucket[hit], loc.slot[hit]] = new_sc[hit]
    stages.scatter_values(cfg, state.values, loc.row, values[last_idx_s], hit)
    status_g.scatter_reduce_(0, gid, hit.to(torch.int32) * STATUS_UPDATED, "amax")

    # ---- phase 2: misses -----------------------------------------------------
    miss = rep_mask & ~loc.found
    target = stages.select_target(state, cfg, probe_s)
    init_sc = policy.init_score(clock, epoch, count_s, custom_s)

    # canonical order: (bucket asc, score desc, key asc); non-misses last
    bkt_key = torch.where(miss, target, b)
    perm = stable_argsort(bkt_key, u64.flip(~init_sc), u64.flip(keys_s))
    bkt_m, key_m, gid_m = bkt_key[perm], keys_s[perm], gid[perm]
    sc_m, dig_m, vrow_m = init_sc[perm], probe_s.digest[perm], last_idx_s[perm]
    mask_m = bkt_m < b
    iota = torch.arange(n, device=dev)
    is_newb = torch.ones(n, dtype=torch.bool, device=dev)
    is_newb[1:] = bkt_m[1:] != bkt_m[:-1]
    run_start = torch.cummax(torch.where(is_newb, iota, -1), 0).values
    rank = iota - run_start

    bkt_g = bkt_m.clamp(0, b - 1)
    victim_slot, victim_occ, victim_sc, _victim_key = stages.victim_at_rank(
        state, cfg, bkt_g, rank)
    admitted = mask_m & (rank < s) & (~victim_occ | u64.gt(sc_m, victim_sc))
    evicts = admitted & victim_occ

    # structural scatter: distinct (bucket, victim_slot) pairs
    tb, ts = bkt_m[admitted], victim_slot[admitted]
    state.keys[tb, ts] = key_m[admitted]
    state.digests[tb, ts] = dig_m[admitted]
    state.scores[tb, ts] = sc_m[admitted]
    stages.scatter_values(cfg, state.values, bkt_g * s + victim_slot,
                          values[vrow_m], admitted)

    status_m = torch.where(
        admitted,
        torch.where(evicts, STATUS_EVICTED, STATUS_INSERTED),
        torch.where(mask_m, STATUS_REJECTED, STATUS_INVALID)).to(torch.int32)
    status_g.scatter_reduce_(0, gid_m, status_m, "amax")

    # group status -> batch order (duplicates share their group's status)
    status = torch.empty(n, dtype=torch.int8, device=dev)
    status[idx_s] = status_g[gid].to(torch.int8)
    return status
