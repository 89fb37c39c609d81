"""Batch-synchronous bucket merge: the closure of paper Algorithms 2 and 3.

This is the reference's ``core/merge.py`` batch closure, the one engine
behind ``insert_or_assign``, ``insert_and_evict``, ``find_or_insert`` and
``ingest``:

  phase 1  keys already present are updates: score transition and (unless
           ``write_hit_values=False``) value write at their (bucket, slot);
  phase 2  the remaining keys are insertions: per target bucket, the r-th
           best incoming key (score descending, then key ascending) is
           paired with the r-th weakest existing slot under the total
           victim order (occupied, score, key, slot) and admitted iff it
           strictly beats it (existing entries win ties).

The state is updated in place, in the reference's order of reads and
writes: phase-1 score and value writes land before ``select_target`` (its
D2 rule must see this batch's score touches), and ``victim_at_rank`` and
the evicted rows' ``gather_values`` read before the structural scatter
overwrites them.  With in-place planes the order of the calls is the
whole guarantee.

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
      select_target(state, cfg, probe, lanes) -> int64 [N] target bucket,
          read only where `lanes` (bool [N], the batch's miss lanes); the
          kernel stage works on those lanes alone
      victim_at_rank(state, cfg, buckets, rank)
          -> (slot int64, occupied bool, score int64, key int64), each [M]
          for the batch's M miss lanes (not called when M is 0)
      gather_values(cfg, values, rows, mask) -> [N, Dtot]
          values[rows[i]] where mask[i], zeros elsewhere (the evicted-value
          hand-off); rows outside the plane are clipped into it.
      scatter_values(cfg, values, rows, updates, mask) -> None
          values[rows[i]] = updates[i] where mask[i], in place; masked rows
          are unique within the batch.
    """

    locate: Callable
    select_target: Callable
    victim_at_rank: Callable
    gather_values: Callable
    scatter_values: Callable


class EvictionStream(NamedTuple):
    """Displaced (key, value, score) entries of one structural op: the
    paper's in-launch eviction hand-off (§3.6).

    Lanes align with the op's input batch (``insert_and_evict``,
    ``find_or_insert``: lane i carries the entry displaced by input key i)
    or with rank (``evict_if``: lane i is the i-th coldest).  A lane with
    mask False displaced nothing; its key, value and score are zeros, NOT
    the EMPTY sentinel, so mask before reusing them as keys
    (``masked_keys``)."""

    keys: torch.Tensor      # int64 [N] displaced keys (0 where ~mask)
    values: torch.Tensor    # [N, Dtot] full-width rows (aux columns too)
    scores: torch.Tensor    # int64 [N] their scores (0 where ~mask)
    mask: torch.Tensor      # bool [N] lane carries a displaced entry

    def masked_keys(self) -> torch.Tensor:
        """Keys with non-displacing lanes set to EMPTY: the form another
        table op takes directly (a zero lane would be the valid key 0)."""
        return torch.where(self.mask, self.keys, u64.EMPTY)

    def count(self) -> torch.Tensor:
        """int64 [] number of displaced entries."""
        return self.mask.sum()

    @classmethod
    def zero(cls, n: int, vdim: int, vdtype: torch.dtype,
             device: torch.device) -> "EvictionStream":
        """n lanes displacing nothing (n = 0: the placeholder of an op
        whose caller did not ask for the hand-off)."""
        z = torch.zeros(n, dtype=torch.int64, device=device)
        return cls(keys=z, values=torch.zeros((n, vdim), dtype=vdtype, device=device),
                   scores=z.clone(), mask=torch.zeros(n, dtype=torch.bool, device=device))


class MergeResult(NamedTuple):
    state: HKVState
    status: torch.Tensor             # int8 [N] in batch order
    evicted: EvictionStream          # batch-aligned iff return_evicted, else 0 lanes
    found: torch.Tensor              # bool [N] key existed BEFORE this op
    loc: find_mod.Locate             # where each key lives AFTER this op
                                     # (loc.found: present now, hit or admitted)


class DedupeResult(NamedTuple):
    """A key batch deduplicated in sorted space (the engine's canonical
    form).  Every tensor has the batch length N."""

    unique: torch.Tensor       # int64 [N] each group's key at its first sorted slot, EMPTY elsewhere
    idx_sorted: torch.Tensor   # int64 [N] batch position of sorted slot j
    gid: torch.Tensor          # int64 [N] group id of sorted slot j
    rep_mask: torch.Tensor     # bool [N] True at each valid group's first sorted slot
    last_index: torch.Tensor   # int64 [N] batch position of the group's LAST occurrence
    inverse: torch.Tensor      # int64 [N] batch position -> its group's first sorted slot


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


def dedupe_keys(keys: torch.Tensor) -> DedupeResult:
    """Dedupe over the canonical key sort: route or reduce per `unique`,
    then map per-group results back to the batch with `inverse`."""
    n = keys.shape[0]
    keys_s, idx_s, gid, _count, last_idx, rep = _dedupe_sort(keys)
    unique = torch.where(rep, keys_s, u64.EMPTY)
    iota = torch.arange(n, device=keys.device)
    rep_pos = torch.full((n,), n, dtype=torch.int64, device=keys.device)
    rep_pos.scatter_reduce_(0, gid, iota, "amin", include_self=True)
    inverse = torch.empty(n, dtype=torch.int64, device=keys.device)
    inverse[idx_s] = rep_pos[gid]
    return DedupeResult(unique=unique, idx_sorted=idx_s, gid=gid, rep_mask=rep,
                        last_index=last_idx, inverse=inverse)


def last_writer_mask(keys: torch.Tensor) -> torch.Tensor:
    """bool [N] in batch order: the lane is its key's last occurrence in
    the batch (every lane of a key that occurs once)."""
    _ks, idx_s, _gid, _cnt, last_idx_s, _rep = _dedupe_sort(keys)
    mask = torch.empty(keys.shape[0], dtype=torch.bool, device=keys.device)
    mask[idx_s] = idx_s == last_idx_s
    return mask


def bucket_stats(keys: torch.Tensor, scores: torch.Tensor):
    """(occupancy [N], flipped minimum live score [N]) of rows [N, S].

    Empty slots count as +inf (the all-ones score), so an empty row
    reports the all-ones sentinel; the minimum is returned in flipped
    (signed-comparable) form."""
    occ = ~u64.empty_lanes(keys)
    fmin = torch.where(occ, u64.flip(scores), u64.flip(torch.full_like(scores, u64.U64_MAX)))
    return occ.sum(dim=1), fmin.min(dim=1).values


def select_target_bucket(state: HKVState, cfg: HKVConfig, probe: find_mod.Probe,
                         lanes: torch.Tensor) -> torch.Tensor:
    """Dual-bucket two-phase selection (paper Alg. 3): while either
    candidate has a free slot, the less-occupied bucket; once both are
    full, the bucket with the lower minimum score.  Ties go to the primary.
    Lanes off the gate `lanes` report the primary, as the kernel stage's."""
    if cfg.buckets_per_key == 1:
        return probe.bucket1
    s = cfg.slots_per_bucket
    occ1, min1 = bucket_stats(state.keys[probe.bucket1], state.scores[probe.bucket1])
    occ2, min2 = bucket_stats(state.keys[probe.bucket2], state.scores[probe.bucket2])
    any_free = (occ1 < s) | (occ2 < s)
    second = torch.where(any_free, occ2 < occ1, min2 < min1) & lanes
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


def plain_gather_values(cfg: HKVConfig, values: torch.Tensor, rows: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    out = table_mod.tier_gather(cfg.value_tier, values, rows.clamp(0, values.shape[0] - 1))
    return torch.where(mask[:, None], out, torch.zeros_like(out))


def plain_scatter_values(cfg: HKVConfig, values: torch.Tensor, rows: torch.Tensor,
                         updates: torch.Tensor, mask: torch.Tensor) -> None:
    table_mod.tier_scatter(cfg.value_tier, values, rows[mask], updates[mask].to(values.dtype))


def plain_stages() -> UpsertStages:
    """The plain PyTorch implementation of every stage."""
    return UpsertStages(
        locate=lambda state, cfg, keys, probe: find_mod.locate(state, cfg, keys, probe),
        select_target=select_target_bucket,
        victim_at_rank=plain_victim_at_rank,
        gather_values=plain_gather_values,
        scatter_values=plain_scatter_values,
    )


def upsert(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
           values: torch.Tensor, *, custom_scores: Optional[torch.Tensor] = None,
           write_hit_values: bool = True, update_hit_scores: bool = True,
           insert_values: Optional[torch.Tensor] = None,
           return_evicted: bool = False,
           stages: Optional[UpsertStages] = None,
           loc: Optional[find_mod.Locate] = None) -> MergeResult:
    """The batch closure of insert_or_assign / insert_and_evict /
    find_or_insert / ingest, in place on `state`.

    keys          : int64 [N] (EMPTY lanes ignored; duplicates: last writer wins)
    values        : [N, Dtot] rows, already padded to the plane's width;
                    written on a hit (when write_hit_values) and inserted
                    on a miss (unless insert_values overrides)
    insert_values : optional distinct rows for the insertion path
    return_evicted: gather the displaced entries into a batch-aligned
                    EvictionStream (else a zero-lane placeholder)
    loc           : optional batch-order locate of `keys` against this
                    state's key plane, used in place of the closure's own
                    (exact: a locate depends only on the key plane)
    """
    n = keys.shape[0]
    b, s = cfg.num_buckets, cfg.slots_per_bucket
    dev = keys.device
    vdim = state.values.shape[1]
    policy = cfg.policy
    if insert_values is None:
        insert_values = values
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
    if loc is None:
        loc = stages.locate(state, cfg, keys_s, probe_s)
    else:   # batch order -> sorted space; EMPTY lanes forced to miss
        loc = find_mod.Locate(found=loc.found[idx_s] & probe_s.valid,
                              bucket=loc.bucket[idx_s], slot=loc.slot[idx_s],
                              row=loc.row[idx_s])
    hit = loc.found & rep_mask
    if update_hit_scores:
        old_sc = state.scores[loc.bucket, loc.slot]
        new_sc = policy.update_score(old_sc, clock, epoch, count_s, custom_s)
        state.scores[loc.bucket[hit], loc.slot[hit]] = new_sc[hit]
    if write_hit_values:
        stages.scatter_values(cfg, state.values, loc.row, values[last_idx_s], hit)
    status_g.scatter_reduce_(0, gid, hit.to(torch.int32) * STATUS_UPDATED, "amax")

    # ---- phase 2: misses -----------------------------------------------------
    miss = rep_mask & ~loc.found
    target = stages.select_target(state, cfg, probe_s, miss)   # read on the misses only
    init_sc = policy.init_score(clock, epoch, count_s, custom_s)

    # canonical order: (bucket asc, score desc, key asc); non-misses last
    bkt_key = torch.where(miss, target, b)
    perm = stable_argsort(bkt_key, u64.flip(~init_sc), u64.flip(keys_s))
    bkt_m, key_m, gid_m, idx_m = bkt_key[perm], keys_s[perm], gid[perm], idx_s[perm]
    sc_m, dig_m, vrow_m = init_sc[perm], probe_s.digest[perm], last_idx_s[perm]
    mask_m = bkt_m < b
    iota = torch.arange(n, device=dev)
    is_newb = torch.ones(n, dtype=torch.bool, device=dev)
    is_newb[1:] = bkt_m[1:] != bkt_m[:-1]
    run_start = torch.cummax(torch.where(is_newb, iota, -1), 0).values
    rank = iota - run_start

    bkt_g = bkt_m.clamp(0, b - 1)
    # The misses sort first, so they are the prefix [:m]: victim_at_rank
    # runs on those lanes only (one host read of m; the boolean indexing
    # below syncs anyway).  The other lanes keep (slot 0, free, score 0,
    # key 0), which no later step reads: admitted and evicts are False there.
    m = int(mask_m.sum())
    victim_slot = torch.zeros(n, dtype=torch.int64, device=dev)
    victim_occ = torch.zeros(n, dtype=torch.bool, device=dev)
    victim_sc = torch.zeros(n, dtype=torch.int64, device=dev)
    victim_key = torch.zeros(n, dtype=torch.int64, device=dev)
    if m:
        (victim_slot[:m], victim_occ[:m], victim_sc[:m],
         victim_key[:m]) = stages.victim_at_rank(state, cfg, bkt_g[:m], rank[:m])
    admitted = mask_m & (rank < s) & (~victim_occ | u64.gt(sc_m, victim_sc))
    evicts = admitted & victim_occ

    # the evicted rows are read before the structural scatter overwrites them
    victim_row = bkt_g * s + victim_slot
    if return_evicted:
        ev_values = stages.gather_values(cfg, state.values, victim_row, evicts)

    # structural scatter: distinct (bucket, victim_slot) pairs
    tb, ts = bkt_m[admitted], victim_slot[admitted]
    state.keys[tb, ts] = key_m[admitted]
    state.digests[tb, ts] = dig_m[admitted]
    state.scores[tb, ts] = sc_m[admitted]
    stages.scatter_values(cfg, state.values, victim_row,
                          insert_values[vrow_m].to(state.values.dtype), admitted)

    status_m = torch.where(
        admitted,
        torch.where(evicts, STATUS_EVICTED, STATUS_INSERTED),
        torch.where(mask_m, STATUS_REJECTED, STATUS_INVALID)).to(torch.int32)
    status_g.scatter_reduce_(0, gid_m, status_m, "amax")

    # group status -> batch order (duplicates share their group's status)
    status = torch.empty(n, dtype=torch.int8, device=dev)
    status[idx_s] = status_g[gid].to(torch.int8)

    # ---- post-op locations (batch order) -------------------------------------
    # Hits stay where they were located, admitted misses sit in their
    # victim's slot.  A hit can lose its slot within the batch to an
    # admitted miss whose init score beats its updated score (lfu-family
    # and custom policies, never monotone lru clocks): the final key plane
    # at the hit's position decides whether it is still there.
    hit_live = hit & find_mod.match_lanes(state.keys[loc.bucket, loc.slot], keys_s)
    pos_b = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    pos_s = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    pos_in = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    hg = torch.where(hit_live, gid, n)                 # lane n absorbs the rest
    pos_b[hg], pos_s[hg], pos_in[hg] = loc.bucket, loc.slot, hit_live
    ag = torch.where(admitted, gid_m, n)
    pos_b[ag], pos_s[ag], pos_in[ag] = bkt_m, victim_slot, admitted
    pos_b[n], pos_s[n], pos_in[n] = 0, 0, False

    def to_batch(a):
        out = torch.empty(n, dtype=a.dtype, device=dev)
        out[idx_s] = a[gid]
        return out

    post_b, post_s = to_batch(pos_b), to_batch(pos_s)
    post_loc = find_mod.Locate(found=to_batch(pos_in), bucket=post_b, slot=post_s,
                               row=post_b * s + post_s)
    pre_found = torch.empty(n, dtype=torch.bool, device=dev)
    pre_found[idx_s] = loc.found

    if return_evicted:
        oe = torch.where(evicts, idx_m, n)            # evictor's batch position
        stream = EvictionStream.zero(n + 1, vdim, state.values.dtype, dev)
        stream.keys[oe] = torch.where(evicts, victim_key, 0)
        stream.scores[oe] = torch.where(evicts, victim_sc, 0)
        stream.values[oe] = ev_values.to(state.values.dtype)
        stream.mask[oe] = evicts
        stream = EvictionStream(*(x[:n] for x in stream))
    else:
        stream = EvictionStream.zero(0, vdim, state.values.dtype, dev)
    return MergeResult(state=state, status=status, evicted=stream,
                       found=pre_found, loc=post_loc)
