"""HKV op engine (paper §4.1): the table's ops over an in-place state.

The reference's roles (paper §3.5) hold here as they do there:

  READERS    find, find_rows, find_ptr, contains, size, load_factor,
             export_batch, export_batch_if: read the state, write nothing;
  UPDATERS   assign, assign_add, assign_scores, update_rows: write values
             or scores of keys already present, never a key, digest or
             slot;
  INSERTERS  insert_or_assign, insert_and_evict, find_or_insert, ingest,
             accum_or_assign, erase, clear, erase_if, evict_if: change
             bucket membership.

Every op takes the EMPTY key as padding and ignores it.  Updaters and
inserters change `state` in place and return it.

``backend`` picks the implementation of the heavy stages:
  'auto'    the CUDA kernels when the state lies on the card, else 'plain';
  'plain'   the plain PyTorch reference, on any device.
Under 'auto' an op runs a kernel exactly where the reference's
``backend='kernel'`` runs a Pallas kernel, and plain PyTorch (on the card)
where the reference runs plain jnp:

  find, find_rows          find_scan; at a caller's ``loc``: gather_rows;
                           on the 'hmem' tier: digest_scan and gather_rows
  find_ptr, contains       digest_scan, one launch over both candidate
                           buckets
  insert_or_assign,        the upsert stages (``kernels.ops.kernel_stages``);
  ingest                   insert_and_evict adds one gather_rows for the
  insert_and_evict,        evicted rows, find_or_insert one for its readback
  find_or_insert
  erase_if, evict_if       sweep_match for the mask
  update_rows              update_scan, when no ``loc`` is given and no
                           score is touched (on the 'hmem' tier:
                           digest_scan, gather_rows, the optimizer and
                           scatter_rows); at a caller's ``loc``:
                           gather_rows, the optimizer, and assign
  the rest                 plain PyTorch (the reference's are plain jnp)

On the 'hmem' tier (``core.table``) the kernels reach the value plane in
host memory over the host link, and the plain paths move rows across the
tier through ``tier_gather`` / ``tier_scatter``.

Telemetry (``repro_torch.obs.telemetry``): every role-annotated op takes
an optional keyword-only ``telemetry=`` sink and records one
``OpTelemetry`` of counters per call (probes, digest-prefilter passes,
hits and misses, the upsert status histogram), computed in plain tensor
math over the planes, so results are bit-identical and no kernel launch is
added with the sink on.  The state changes in place, so an inserter's and
an erase's probe counters are taken before the op's first write and the
status histogram after it.  ``telemetry=None`` is the path without it:
the observers are imported only where a sink is given.  The whole-table
scans and ``clear`` are exempt (``TELEMETRY_EXEMPT``).

``HKVTable`` in ``core.api`` is the public surface; these free functions
are the implementation it delegates to.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import roles
from repro_torch.core import table as table_mod
from repro_torch.core import u64
from repro_torch.core.merge import (  # noqa: F401  (re-exported)
    STATUS_EVICTED,
    STATUS_INSERTED,
    STATUS_INVALID,
    STATUS_REJECTED,
    STATUS_UPDATED,
    EvictionStream,
    MergeResult,
)
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.table import HKVConfig, HKVState


# Role-annotated ops without a `telemetry=` seam, each with the reason
# (the reference's list, src/repro/analysis/telemetry.py).
TELEMETRY_EXEMPT: dict[str, str] = {
    "size": "whole-table scalar reduction; no probe path to count",
    "load_factor": "derived scalar over size(); no probe path to count",
    "export_batch": "bucket-range dump (checkpoint drain); traversal is "
                    "exhaustive by construction, not probe-driven",
    "export_batch_if": "predicated bucket-range dump; same exhaustive "
                       "traversal as export_batch",
    "clear": "unconditional state reset; nothing probe- or "
             "admission-shaped to observe",
}


def _obs():
    """The observers, imported only where a sink is given."""
    from repro_torch.obs import telemetry as obs_telemetry

    return obs_telemetry


def uses_kernels(backend: str, device: torch.device) -> bool:
    """Whether `backend` runs the CUDA kernels for state on `device`."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}; one of 'auto'|'plain'")
    return backend == "auto" and device.type == "cuda"


def _kernel_ops():
    from repro_torch.kernels import ops as kernel_ops  # kernels import core

    return kernel_ops


def _upsert_stages(backend: str, cfg: HKVConfig, device: torch.device):
    return _kernel_ops().kernel_stages(cfg, device) if uses_kernels(backend, device) else None


# =============================================================================
# Readers
# =============================================================================


class FindResult(NamedTuple):
    values: torch.Tensor     # [N, dim] (zeros where not found)
    found: torch.Tensor      # bool [N]
    scores: torch.Tensor     # int64 [N] unsigned scores (0 where not found)


class FindRowsResult(NamedTuple):
    rows: torch.Tensor       # [N, dim + aux] full-width rows (zeros on a miss)
    found: torch.Tensor      # bool [N]
    row: torch.Tensor        # int64 [N] value-plane row (position addressing)
    scores: torch.Tensor     # int64 [N] entry scores (0 where not found)


class ExportResult(NamedTuple):
    keys: torch.Tensor       # int64 [count * S]
    values: torch.Tensor     # [count * S, dim + aux]
    scores: torch.Tensor     # int64 [count * S]
    mask: torch.Tensor       # bool: live (and, for export_batch_if, matching)


def _read(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
          loc: Optional[find_mod.Locate], dim: Optional[int], backend: str):
    """(rows, found, row, scores) of `keys`: one find_scan launch on the
    kernel path without a `loc`, a gather_rows launch with one."""
    kern = uses_kernels(backend, state.device)
    width = state.values.shape[1] if dim is None else dim
    if loc is None and kern:
        r = _kernel_ops().find_fused_kernel(state, cfg, keys)
        return (r.values[:, :width], r.found, r.bucket * cfg.slots_per_bucket + r.slot,
                r.scores)
    if loc is None:
        loc = find_mod.locate(state, cfg, keys)
    if kern:
        vals = _kernel_ops().gather_rows_kernel(state, loc, width)
    else:
        vals = find_mod.gather_values(state, loc, dim, cfg.value_tier)
    scores = torch.where(loc.found, state.scores[loc.bucket, loc.slot], 0)
    return vals, loc.found, loc.row, scores


@roles.reader
def find(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
         loc: Optional[find_mod.Locate] = None, *, backend: str = "auto",
         telemetry=None) -> FindResult:
    """Reader.  Digest-filtered lookup with value copy (paper `find`); on
    the card one fused find_scan launch does match, score readout and
    value copy, or, at a caller's `loc`, one gather_rows launch."""
    vals, found, _row, scores = _read(state, cfg, keys, loc, cfg.dim, backend)
    if telemetry is not None:
        telemetry.record("find", _obs().observe_find(state, cfg, keys, found))
    return FindResult(values=vals, found=found, scores=scores)


@roles.reader
def find_rows(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
              loc: Optional[find_mod.Locate] = None, *,
              backend: str = "auto", telemetry=None) -> FindRowsResult:
    """Reader.  Full-width rows (embedding and aux optimizer columns),
    their row indices and scores."""
    rows, found, row, scores = _read(state, cfg, keys, loc, None, backend)
    if telemetry is not None:
        telemetry.record("find_rows", _obs().observe_find(state, cfg, keys, found))
    return FindRowsResult(rows=rows, found=found, row=row, scores=scores)


@roles.reader
def find_ptr(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, *,
             backend: str = "auto", telemetry=None) -> find_mod.Locate:
    """Reader.  The paper's pointer find: (bucket, slot, row) of each key,
    no value traffic.  On the card: one digest_scan launch."""
    if uses_kernels(backend, state.device):
        loc = _kernel_ops().locate_kernel(state, cfg, keys)
    else:
        loc = find_mod.locate(state, cfg, keys)
    if telemetry is not None:
        telemetry.record("find_ptr", _obs().observe_find(state, cfg, keys, loc.found))
    return loc


@roles.reader
def contains(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
             loc: Optional[find_mod.Locate] = None, *,
             backend: str = "auto", telemetry=None) -> torch.Tensor:
    """Reader.  Membership only."""
    if loc is None:
        loc = find_ptr(state, cfg, keys, backend=backend)
    if telemetry is not None:
        telemetry.record("contains", _obs().observe_find(state, cfg, keys, loc.found))
    return loc.found


@roles.reader
def size(state: HKVState) -> int:
    """Reader.  Number of live entries."""
    return int(state.occupied_mask().sum())


@roles.reader
def load_factor(state: HKVState) -> float:
    return size(state) / state.keys.numel()


@roles.reader
def export_batch(state: HKVState, cfg: HKVConfig, bucket_start: int,
                 bucket_count: int) -> ExportResult:
    """Reader.  A copy of a contiguous bucket range (checkpointing), with
    a liveness mask; a copy, since the ops change the planes in place."""
    s = cfg.slots_per_bucket
    keys = state.keys[bucket_start:bucket_start + bucket_count].reshape(-1).clone()
    rows = torch.arange(bucket_start * s, (bucket_start + bucket_count) * s, device=state.device)
    return ExportResult(
        keys=keys,
        values=table_mod.tier_gather(cfg.value_tier, state.values, rows),
        scores=state.scores[bucket_start:bucket_start + bucket_count].reshape(-1).clone(),
        mask=~u64.empty_lanes(keys))


@roles.reader
def export_batch_if(state: HKVState, cfg: HKVConfig, bucket_start: int,
                    bucket_count: int, score_threshold: torch.Tensor) -> ExportResult:
    """Reader.  export_batch with a score >= threshold predicate (paper
    §4.1); `score_threshold` is one unsigned word (int64 bits)."""
    out = export_batch(state, cfg, bucket_start, bucket_count)
    ge = u64.flip(out.scores) >= u64.flip(score_threshold.reshape(()).to(out.scores.device))
    return out._replace(mask=out.mask & ge)


# =============================================================================
# Updaters (in place; values and scores of keys already present)
# =============================================================================


@roles.updater
def assign(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, values: torch.Tensor,
           update_scores: bool = False,
           loc: Optional[find_mod.Locate] = None, *, telemetry=None) -> HKVState:
    """Updater.  Write the values of keys already present; misses are
    no-ops.  Duplicates in the batch: the last writer wins, decided by the
    batch order (on the card too, where a plain scatter of repeated rows
    would leave the winner undefined).  `values` narrower than the plane
    keep the stored aux columns."""
    if loc is None:
        loc = find_mod.locate(state, cfg, keys)
    if telemetry is not None:
        telemetry.record("assign", _obs().observe_update(state, cfg, keys, loc.found))
    values = values.to(state.values.dtype)
    vdim = state.values.shape[1]
    if values.shape[1] < vdim:
        old = table_mod.tier_gather(cfg.value_tier, state.values,
                                    loc.row.clamp(0, state.values.shape[0] - 1))
        values = torch.cat([values, torch.where(loc.found[:, None], old[:, values.shape[1]:], 0)],
                           dim=1)
    write = loc.found & merge_mod.last_writer_mask(keys)
    table_mod.tier_scatter(cfg.value_tier, state.values, loc.row[write], values[write])
    if update_scores:
        table_mod.advance_clock(state)
        new_sc = cfg.policy.update_score(state.scores[loc.bucket, loc.slot], state.clock,
                                         state.epoch, torch.ones_like(keys), None)
        state.scores[loc.bucket[write], loc.slot[write]] = new_sc[write]
    return state


@roles.updater
def assign_add(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, deltas: torch.Tensor,
               loc: Optional[find_mod.Locate] = None, *, telemetry=None) -> HKVState:
    """Updater.  values[k] += delta for keys already present; duplicates
    accumulate.  On the CPU the adds run in batch order, as the
    reference's scatter-add does; on the card they are float32 atomics,
    whose order (and so the rounding of a duplicated key's sum) varies."""
    if loc is None:
        loc = find_mod.locate(state, cfg, keys)
    if telemetry is not None:
        telemetry.record("assign_add", _obs().observe_update(state, cfg, keys, loc.found))
    deltas = _pad_aux(deltas, state)
    table_mod.tier_scatter(cfg.value_tier, state.values, loc.row[loc.found], deltas[loc.found],
                           add=True)
    return state


@roles.updater
def assign_scores(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                  scores: torch.Tensor,
                  loc: Optional[find_mod.Locate] = None, *, telemetry=None) -> HKVState:
    """Updater.  Overwrite the scores of keys already present (paper
    `assign_scores`); duplicates: the last writer wins."""
    if loc is None:
        loc = find_mod.locate(state, cfg, keys)
    if telemetry is not None:
        telemetry.record("assign_scores", _obs().observe_update(state, cfg, keys, loc.found))
    write = loc.found & merge_mod.last_writer_mask(keys)
    state.scores[loc.bucket[write], loc.slot[write]] = scores[write]
    return state


class RowUpdate(NamedTuple):
    """The gradient step as a structured session payload: a sparse
    optimizer and the per-key (deduplicated, summed) gradient rows.  A
    session can route it whole to ``update_rows``, and so to the fused
    update_scan kernel, which an opaque callable would not allow."""

    opt: Any                 # embedding.sparse_opt.SparseOptimizer
    grads: torch.Tensor      # [N, dim] summed gradient rows


class UpdateRowsResult(NamedTuple):
    state: HKVState
    found: torch.Tensor      # bool [N] the key was resident and its row trained


@roles.updater
def update_rows(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, grads: torch.Tensor,
                opt, *, update_scores: bool = False,
                loc: Optional[find_mod.Locate] = None,
                backend: str = "auto", telemetry=None) -> UpdateRowsResult:
    """Updater.  The gradient step: each resident key's full row
    [embedding | aux optimizer state] becomes ``opt.apply(row, grad)``, in
    place.  Misses are no-ops: keys not admitted do not train.

    PRECONDITION: the valid keys are unique and `grads` summed per key
    (``HKVEmbedding.apply_grads`` deduplicates first).

    On the card, with no `loc` and no score touch, one update_scan launch
    does probe, optimizer and write-back.  Otherwise the step is composed
    as the reference composes it: locate (or the caller's `loc`), the row
    gather, the optimizer, and ``assign`` at that locate."""
    kern = uses_kernels(backend, state.device)
    if loc is None and not update_scores and kern:
        r = _kernel_ops().update_rows_kernel(state, cfg, keys, grads, opt)
        if telemetry is not None:
            telemetry.record("update_rows", _obs().observe_update(state, cfg, keys, r.found))
        return UpdateRowsResult(state=state, found=r.found)
    if loc is None:
        loc = find_mod.locate(state, cfg, keys)
        rows = find_mod.gather_values(state, loc, tier=cfg.value_tier)
    elif kern:
        rows = _kernel_ops().gather_rows_kernel(state, loc, state.values.shape[1])
    else:
        rows = find_mod.gather_values(state, loc, tier=cfg.value_tier)
    if telemetry is not None:
        telemetry.record("update_rows", _obs().observe_update(state, cfg, keys, loc.found))
    new_rows = opt.apply(rows, grads, cfg.dim).to(state.values.dtype)
    new_rows = torch.where(loc.found[:, None], new_rows, rows)
    assign(state, cfg, keys, new_rows, update_scores=update_scores, loc=loc)
    return UpdateRowsResult(state=state, found=loc.found)


# =============================================================================
# Inserters (structural)
# =============================================================================


class UpsertResult(NamedTuple):
    state: HKVState
    status: torch.Tensor     # int8 [N]: 0 invalid / 1 updated / 2 inserted / 3 evicted / 4 rejected


class InsertAndEvictResult(NamedTuple):
    state: HKVState
    status: torch.Tensor
    evicted: EvictionStream  # batch-aligned


class FindOrInsertResult(NamedTuple):
    state: HKVState
    values: torch.Tensor     # [N, dim] stored value if present now, else the caller's init row
    found: torch.Tensor      # bool [N] key existed before this call
    status: torch.Tensor
    evicted: EvictionStream  # batch-aligned iff return_evicted, else 0 lanes


def _probe_before(telemetry, state: HKVState, cfg: HKVConfig, keys: torch.Tensor):
    """An inserter's probe counters, taken before its first write (None
    without a sink)."""
    return None if telemetry is None else _obs().probe_counters(state, cfg, keys)


def _record_upsert(telemetry, op: str, probe, keys, status, found=None) -> None:
    if telemetry is not None:
        telemetry.record(op, _obs().observe_upsert(probe, keys, status, found))


@roles.inserter
def insert_or_assign(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                     values: torch.Tensor,
                     custom_scores: Optional[torch.Tensor] = None, *,
                     backend: str = "auto", telemetry=None) -> UpsertResult:
    """Inserter.  Update-or-insert with in-line eviction and admission
    (paper Alg. 2/3), in place."""
    probe = _probe_before(telemetry, state, cfg, keys)
    res = merge_mod.upsert(state, cfg, keys, _pad_aux(values, state),
                           custom_scores=custom_scores,
                           stages=_upsert_stages(backend, cfg, state.device))
    _record_upsert(telemetry, "insert_or_assign", probe, keys, res.status)
    return UpsertResult(state=state, status=res.status)


@roles.inserter
def insert_and_evict(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                     values: torch.Tensor,
                     custom_scores: Optional[torch.Tensor] = None, *,
                     backend: str = "auto",
                     loc: Optional[find_mod.Locate] = None,
                     telemetry=None) -> InsertAndEvictResult:
    """Inserter.  insert_or_assign that hands back the displaced entries,
    batch-aligned (the paper's in-launch eviction hand-off, §3.6).  `loc`:
    a locate of the same batch against this key plane, used in place of
    the closure's own."""
    probe = _probe_before(telemetry, state, cfg, keys)
    res = merge_mod.upsert(state, cfg, keys, _pad_aux(values, state),
                           custom_scores=custom_scores, return_evicted=True,
                           stages=_upsert_stages(backend, cfg, state.device), loc=loc)
    _record_upsert(telemetry, "insert_and_evict", probe, keys, res.status)
    return InsertAndEvictResult(state=state, status=res.status, evicted=res.evicted)


@roles.inserter
def find_or_insert(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                   init_values: torch.Tensor,
                   custom_scores: Optional[torch.Tensor] = None, *,
                   backend: str = "auto", return_evicted: bool = False,
                   loc: Optional[find_mod.Locate] = None,
                   telemetry=None) -> FindOrInsertResult:
    """Inserter.  Lookup; insert `init_values` for keys not present
    (cold start).  Hits keep their stored value (scores touched per
    policy); misses insert subject to admission.  Returned rows: the
    stored value of every key present after the op, the caller's init row
    where admission rejected the key.  One probe: the closure publishes
    each key's post-op location and the readback gathers there."""
    probe = _probe_before(telemetry, state, cfg, keys)
    res = merge_mod.upsert(state, cfg, keys, _pad_aux(init_values, state),
                           custom_scores=custom_scores, write_hit_values=False,
                           return_evicted=return_evicted,
                           stages=_upsert_stages(backend, cfg, state.device), loc=loc)
    vals = _gather_post(res, cfg, init_values, backend)
    _record_upsert(telemetry, "find_or_insert", probe, keys, res.status, res.found)
    return FindOrInsertResult(state=state, values=vals, found=res.found,
                              status=res.status, evicted=res.evicted)


def _gather_post(res: MergeResult, cfg: HKVConfig, init_values: torch.Tensor,
                 backend: str) -> torch.Tensor:
    """The rows at the closure's post-op locations; a rejected key gets
    the caller's init row back."""
    state = res.state
    if uses_kernels(backend, state.device):
        vals = _kernel_ops().gather_rows_kernel(state, res.loc, cfg.dim)
    else:
        vals = find_mod.gather_values(state, res.loc, cfg.dim, cfg.value_tier)
    return torch.where(res.loc.found[:, None], vals,
                       init_values[:, :cfg.dim].to(vals.dtype))


@roles.inserter
def ingest(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
           init_values: torch.Tensor,
           custom_scores: Optional[torch.Tensor] = None, *,
           backend: str = "auto", telemetry=None) -> UpsertResult:
    """Inserter.  Admission-only upsert: find_or_insert without the value
    readback."""
    probe = _probe_before(telemetry, state, cfg, keys)
    res = merge_mod.upsert(state, cfg, keys, _pad_aux(init_values, state),
                           custom_scores=custom_scores, write_hit_values=False,
                           stages=_upsert_stages(backend, cfg, state.device))
    _record_upsert(telemetry, "ingest", probe, keys, res.status, res.found)
    return UpsertResult(state=state, status=res.status)


@roles.inserter
def accum_or_assign(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                    values: torch.Tensor,
                    custom_scores: Optional[torch.Tensor] = None, *,
                    telemetry=None) -> UpsertResult:
    """Inserter.  Paper API: ACCUMULATE into keys present (+=), ASSIGN the
    rest.  Duplicates are summed first (in batch order on the CPU, by
    float32 atomics on the card), then one += applies on a hit or the sum
    is inserted on a miss.  Plain PyTorch on every device, as the
    reference runs it on plain jnp."""
    probe = _probe_before(telemetry, state, cfg, keys)
    d = merge_mod.dedupe_keys(keys)
    v = _pad_aux(values, state)
    v_sum = torch.zeros_like(v).index_add_(0, d.gid, v[d.idx_sorted])[d.gid]
    assign_add(state, cfg, d.unique, v_sum)
    cs = None if custom_scores is None else custom_scores[d.last_index]
    res = merge_mod.upsert(state, cfg, d.unique, v_sum, custom_scores=cs,
                           write_hit_values=False)
    status = res.status[d.inverse]
    _record_upsert(telemetry, "accum_or_assign", probe, keys, status)
    return UpsertResult(state=state, status=status)


@roles.inserter
def erase(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, *,
          telemetry=None) -> HKVState:
    """Inserter.  Remove keys; their slots return to the pool."""
    loc = find_mod.locate(state, cfg, keys)
    if telemetry is not None:
        telemetry.record("erase", _obs().observe_erase(state, cfg, keys, loc.found))
    _clear_slots(state, cfg, loc.row[loc.found])
    return state


@roles.inserter
def clear(state: HKVState, cfg: HKVConfig) -> HKVState:
    """Inserter.  Drop every entry: the planes as a fresh `create` makes
    them, with the clock and epoch kept."""
    state.keys.fill_(u64.EMPTY)
    state.digests.fill_(u64.EMPTY_DIGEST)
    state.scores.zero_()
    table_mod.tier_zero(cfg.value_tier, state.values, state.device)
    return state


# =============================================================================
# Predicated sweeps (maintenance): whole-table passes driven by a
# SweepPredicate; on the card the mask is one sweep_match launch and the
# rest is shared orchestration.
# =============================================================================


class SweepResult(NamedTuple):
    state: HKVState
    swept: torch.Tensor      # int64 [] entries removed


class EvictIfResult(NamedTuple):
    state: HKVState
    # rank-aligned: lane i is the i-th coldest matching entry (score asc,
    # then key asc); mask False past the match count or `limit`
    evicted: EvictionStream
    count: torch.Tensor      # int64 [] live lanes in the stream


def _sweep_mask(state: HKVState, pred: SweepPredicate, backend: str) -> torch.Tensor:
    """bool [B, S]: live entries matching `pred`."""
    if uses_kernels(backend, state.device):
        return _kernel_ops().sweep_mask_kernel(state, pred)
    return pred.matches(state.keys, state.scores) & state.occupied_mask()


def _clear_slots(state: HKVState, cfg: HKVConfig, rows: torch.Tensor) -> None:
    """Free the slots at flat positions `rows` (= value rows): EMPTY key
    and digest, score 0, value row zeroed.  Only those rows are written,
    not the whole value plane."""
    state.keys.view(-1)[rows] = u64.EMPTY
    state.digests.view(-1)[rows] = u64.EMPTY_DIGEST
    state.scores.view(-1)[rows] = 0
    table_mod.tier_scatter(cfg.value_tier, state.values, rows, 0)


@roles.inserter
def erase_if(state: HKVState, cfg: HKVConfig, pred: SweepPredicate, *,
             backend: str = "auto", telemetry=None) -> SweepResult:
    """Inserter.  Remove EVERY live entry matching `pred` (TTL expiry:
    ``SweepPredicate.expire_before``)."""
    rows = torch.nonzero(_sweep_mask(state, pred, backend).view(-1))[:, 0]
    _clear_slots(state, cfg, rows)
    swept = torch.tensor(rows.numel(), device=state.device)
    if telemetry is not None:
        telemetry.record("erase_if", _obs().observe_sweep(cfg, swept))
    return SweepResult(state=state, swept=swept)


@roles.inserter
def evict_if(state: HKVState, cfg: HKVConfig, pred: SweepPredicate, budget: int, *,
             limit=None, backend: str = "auto", telemetry=None) -> EvictIfResult:
    """Inserter.  Remove up to `budget` matching entries, COLDEST FIRST
    (score ascending, then key ascending: a total order, keys being
    unique), and hand them back as a rank-aligned EvictionStream.

    `budget` is the stream's lane count, clamped to the capacity; `limit`
    an optional further cap (int or tensor, <= budget): lanes at rank >=
    limit stay resident.  The reference sorts the whole table with the
    non-matching entries last; only the matching ones reach the stream,
    so sorting those alone gives the same result."""
    c = cfg.capacity
    if budget < 1:
        raise ValueError(f"budget must be >= 1; got {budget}")
    budget = min(budget, c)
    dev = state.device
    mask = _sweep_mask(state, pred, backend)
    keys_f, scores_f = state.keys.view(-1), state.scores.view(-1)
    cand = torch.nonzero(mask.view(-1))[:, 0]
    order = merge_mod.stable_argsort(u64.flip(scores_f[cand]), u64.flip(keys_f[cand]))
    ranked = cand[order][:budget]
    rank = torch.arange(budget, device=dev)
    lane = rank < ranked.numel()
    if limit is not None:
        lane &= rank < torch.as_tensor(limit, device=dev)
    row_t = torch.zeros(budget, dtype=torch.int64, device=dev)
    row_t[:ranked.numel()] = ranked
    vals = table_mod.tier_gather(cfg.value_tier, state.values, row_t)
    stream = EvictionStream(
        keys=torch.where(lane, keys_f[row_t], 0),
        values=torch.where(lane[:, None], vals, torch.zeros_like(vals)),
        scores=torch.where(lane, scores_f[row_t], 0),
        mask=lane)
    _clear_slots(state, cfg, row_t[lane])
    count = lane.sum()
    if telemetry is not None:
        telemetry.record("evict_if", _obs().observe_evict_if(cfg, count))
    return EvictIfResult(state=state, evicted=stream, count=count)


# =============================================================================
# helpers
# =============================================================================


def _pad_aux(values: torch.Tensor, state: HKVState) -> torch.Tensor:
    """Caller rows in the plane's dtype, zero-padded to its width (the aux
    optimizer columns)."""
    values = values.to(state.values.dtype)
    vdim = state.values.shape[1]
    if values.shape[1] == vdim:
        return values
    pad = values.new_zeros((values.shape[0], vdim - values.shape[1]))
    return torch.cat([values, pad], dim=1)
