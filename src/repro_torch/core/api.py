"""The public surface of the port: the `HKVTable` handle.

Unlike the reference's immutable handle, this one owns a state that its
ops update in place (see ``core.table``).  Inserters return result tuples
whose ``.table`` is the same handle, and updaters return the handle
itself, so that reference-style call chains read the same.
``snapshot()`` is the explicit copy.

    table = HKVTable.create(capacity=2**27, dim=32)     # single bucket
    res = table.insert_or_assign(keys, values)          # res.table, res.status
    out = table.find(keys)                              # out.values, out.found
    loc = table.find_ptr(keys)                          # bucket, slot, row
    ev = table.insert_and_evict(keys, values).evicted   # displaced entries
    table.erase_if(SweepPredicate.key_in_range(0, 2**40))
    s = table.session()                                 # ops sharing one locate
    s.update_rows(uniq, RowUpdate(opt, grads))          # the fused gradient step
    s.commit()

`OpSession` is the reference's planner of the paper's role taxonomy
(§3.5): readers and updaters on one key batch share one locate, inserters
are serialization points, and `explain()` prints the plan.  The `KVTable`
protocol and `table_signature` are the reference's consumer-facing
contract and closure-cache key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import table as table_mod
from repro_torch.core.roles import INSERTER as _INSERTER
from repro_torch.core.roles import READER as _READER
from repro_torch.core.roles import UPDATER as _UPDATER
from repro_torch.core import u64
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.table import HKVConfig, HKVState


def normalize_keys(keys: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """Coerce caller keys to the canonical int64 [N] key tensor.

    Accepted forms:
      * numpy uint64 array or scalar: the exact 64 bits;
      * signed integers (numpy array, python int or list, torch tensor):
        non-negative ids are the key, NEGATIVE ids become the EMPTY
        padding sentinel (the embedding layer's convention);
      * unsigned integers narrower than 64 bits: zero-extended;
      * a torch uint64 tensor: the exact 64 bits (a bit-cast view; the
        form in which normalized keys pass through a handle again).
    A signed id cannot exceed 2**63 - 1, so keys at or above 2**63 enter
    through numpy uint64 or a torch uint64 tensor.
    """
    if isinstance(keys, torch.Tensor):
        if keys.dtype == torch.uint64:
            out = keys.view(torch.int64)
        elif keys.dtype in (torch.uint8, torch.uint16, torch.uint32):
            out = keys.to(torch.int64)
        elif keys.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
            k = keys.to(torch.int64)
            out = torch.where(k < 0, u64.EMPTY, k)
        else:
            raise TypeError(f"cannot use {keys.dtype} tensors as table keys")
    else:
        arr = np.atleast_1d(np.asarray(keys))
        if arr.dtype == np.uint64:
            out = u64.from_numpy_u64(arr)
        elif np.issubdtype(arr.dtype, np.signedinteger):
            a = arr.astype(np.int64)
            out = torch.from_numpy(np.where(a < 0, np.int64(u64.EMPTY), a))
        elif np.issubdtype(arr.dtype, np.unsignedinteger):
            out = torch.from_numpy(arr.astype(np.int64))
        else:
            raise TypeError(f"cannot use {arr.dtype} arrays as table keys")
    out = out.reshape(-1)
    return out if device is None else out.to(device)


def dedupe_keys(keys: Any, device: Optional[torch.device] = None) -> merge_mod.DedupeResult:
    """Key normalization and the engine's canonical dedupe: route or
    reduce per `unique`, then map per-group results back with `inverse`."""
    return merge_mod.dedupe_keys(normalize_keys(keys, device))


class TableUpsert(NamedTuple):
    table: "HKVTable"
    status: torch.Tensor     # int8 [N] — merge status codes, batch order

    @property
    def ok(self) -> torch.Tensor:
        """bool [N]: the key is present after the op (updated, inserted
        or evicted its way in)."""
        return (self.status >= ops_mod.STATUS_UPDATED) & (self.status <= ops_mod.STATUS_EVICTED)


class TableInsertAndEvict(NamedTuple):
    table: "HKVTable"
    status: torch.Tensor
    evicted: merge_mod.EvictionStream    # batch-aligned displaced entries


class TableFindOrInsert(NamedTuple):
    table: "HKVTable"
    values: torch.Tensor
    found: torch.Tensor
    status: torch.Tensor
    evicted: merge_mod.EvictionStream    # populated iff return_evicted


class TableSweep(NamedTuple):
    table: "HKVTable"
    swept: torch.Tensor      # int64 [] entries removed


class TableEvictIf(NamedTuple):
    table: "HKVTable"
    evicted: merge_mod.EvictionStream    # rank-aligned: lane i is the i-th coldest
    count: torch.Tensor      # int64 [] live lanes in the stream


# =============================================================================
# The KVTable protocol: the consumer-facing contract
# =============================================================================


@runtime_checkable
class KVTable(Protocol):
    """The minimal table contract of the reference (``repro.core.api``):
    `find` results expose `.values` and `.found`, `insert_or_assign`
    results `.table` and `.ok`; `erase_if` results `.table` and `.swept`,
    `evict_if` results `.table`, `.evicted` and `.count`."""

    @property
    def capacity(self) -> int: ...

    def find(self, keys: Any) -> Any: ...

    def insert_or_assign(self, keys: Any, values: Any) -> Any: ...

    def contains(self, keys: Any) -> torch.Tensor: ...

    def size(self) -> Any: ...

    def load_factor(self) -> Any: ...

    def erase_if(self, pred: SweepPredicate) -> Any: ...

    def evict_if(self, pred: SweepPredicate, budget: int) -> Any: ...

    def stats(self) -> Any: ...


def table_signature(table: Any) -> tuple:
    """Static identity of a table handle, for caching closures built on its
    static properties: table family, backend, dim, total value width (the
    aux optimizer columns) and score policy.  A tiered handle (a `hot` and
    a `cold` tier) recurses per tier; a handle without an `HKVConfig`
    falls back to type, backend and dim."""
    hot, cold = getattr(table, "hot", None), getattr(table, "cold", None)
    if hot is not None and cold is not None:
        return (type(table).__name__, table_signature(hot), table_signature(cold))
    cfg = getattr(table, "cfg", None)
    if cfg is not None and hasattr(cfg, "total_value_dim"):
        return (type(table).__name__, getattr(table, "backend", None),
                cfg.dim, cfg.total_value_dim, cfg.score_policy)
    return (type(table).__name__, getattr(table, "backend", None),
            int(getattr(table, "dim", 0)))


@dataclasses.dataclass
class HKVTable:
    """Cache-semantic HKV hash table; ops mutate `state` in place.

    Inserters return a result tuple whose `.table` is this handle;
    updaters (assign, assign_add, assign_scores), erase, clear and
    set_epoch update in place and return this handle."""

    state: HKVState
    cfg: HKVConfig
    backend: str = "auto"

    @classmethod
    def create(cls, cfg: Optional[HKVConfig] = None, *, device=None,
               backend: str = "auto", **cfg_kwargs) -> "HKVTable":
        """Allocate an empty table.  `device=None` means the card, and
        raises when there is none; pass device='cpu' for the CPU."""
        if cfg is None:
            cfg = HKVConfig(**cfg_kwargs)
        elif cfg_kwargs:
            cfg = dataclasses.replace(cfg, **cfg_kwargs)
        return cls(state=table_mod.create(cfg, device), cfg=cfg, backend=backend)

    @classmethod
    def wrap(cls, state: HKVState, cfg: HKVConfig, backend: str = "auto") -> "HKVTable":
        """Bind an existing state (no copy)."""
        return cls(state=state, cfg=cfg, backend=backend)

    def with_state(self, state: HKVState) -> "HKVTable":
        """A handle on `state` with this handle's config and backend."""
        return dataclasses.replace(self, state=state)

    def with_backend(self, backend: str) -> "HKVTable":
        """A handle on the SAME state with another backend: ops through
        either change both."""
        return dataclasses.replace(self, backend=backend)

    def snapshot(self) -> "HKVTable":
        """An independent copy of the table (state planes cloned; an 'hmem'
        value plane into new pinned host memory)."""
        return dataclasses.replace(self, state=self.state.clone())

    # -- views ---------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def num_buckets(self) -> int:
        """Bucket count (the `export_batch` iteration bound)."""
        return self.cfg.num_buckets

    @property
    def epoch(self) -> int:
        """The application epoch (the epoch_* policies' TTL clock)."""
        return self.state.epoch

    def keys(self, keys: Any) -> torch.Tensor:
        """The normalization point, to normalize a batch once."""
        return normalize_keys(keys, self.device)

    def probe_keys(self, keys: Any) -> find_mod.Probe:
        return find_mod.probe_keys(self.cfg, self.keys(keys))

    def _rows(self, values: Any) -> torch.Tensor:
        if isinstance(values, np.ndarray) and values.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16 (the JAX package's), which torch cannot read
            from repro_torch.convert import values_from_numpy

            values = values_from_numpy(values)
        return torch.as_tensor(values, device=self.device)

    def _opt_keys(self, x: Optional[Any]) -> Optional[torch.Tensor]:
        return None if x is None else self.keys(x)

    # -- readers -------------------------------------------------------------
    #
    # Every keyed method forwards the optional `telemetry=` sink to its op
    # (``repro_torch.obs.TelemetrySink``); None is the path without it.

    def find(self, keys: Any, *, telemetry=None) -> ops_mod.FindResult:
        return ops_mod.find(self.state, self.cfg, self.keys(keys), backend=self.backend,
                            telemetry=telemetry)

    def find_rows(self, keys: Any, *, telemetry=None) -> ops_mod.FindRowsResult:
        return ops_mod.find_rows(self.state, self.cfg, self.keys(keys), backend=self.backend,
                                 telemetry=telemetry)

    def find_ptr(self, keys: Any, *, telemetry=None) -> find_mod.Locate:
        return ops_mod.find_ptr(self.state, self.cfg, self.keys(keys), backend=self.backend,
                                telemetry=telemetry)

    def contains(self, keys: Any, *, telemetry=None) -> torch.Tensor:
        return ops_mod.contains(self.state, self.cfg, self.keys(keys), backend=self.backend,
                                telemetry=telemetry)

    def size(self) -> int:
        return ops_mod.size(self.state)

    def load_factor(self) -> float:
        return ops_mod.load_factor(self.state)

    def export_batch(self, bucket_start: int, bucket_count: int) -> ops_mod.ExportResult:
        return ops_mod.export_batch(self.state, self.cfg, bucket_start, bucket_count)

    def export_batch_if(self, bucket_start: int, bucket_count: int,
                        score_threshold: Any) -> ops_mod.ExportResult:
        return ops_mod.export_batch_if(self.state, self.cfg, bucket_start, bucket_count,
                                       self.keys(score_threshold))

    # -- updaters (in place; return this handle) -------------------------------

    def assign(self, keys: Any, values: Any, update_scores: bool = False, *,
               telemetry=None) -> "HKVTable":
        ops_mod.assign(self.state, self.cfg, self.keys(keys), self._rows(values),
                       update_scores=update_scores, telemetry=telemetry)
        return self

    def assign_add(self, keys: Any, deltas: Any, *, telemetry=None) -> "HKVTable":
        ops_mod.assign_add(self.state, self.cfg, self.keys(keys), self._rows(deltas),
                           telemetry=telemetry)
        return self

    def assign_scores(self, keys: Any, scores: Any, *, telemetry=None) -> "HKVTable":
        ops_mod.assign_scores(self.state, self.cfg, self.keys(keys), self.keys(scores),
                              telemetry=telemetry)
        return self

    # -- inserters -------------------------------------------------------------

    def insert_or_assign(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None, *,
                         telemetry=None) -> TableUpsert:
        res = ops_mod.insert_or_assign(self.state, self.cfg, self.keys(keys),
                                       self._rows(values), self._opt_keys(custom_scores),
                                       backend=self.backend, telemetry=telemetry)
        return TableUpsert(table=self, status=res.status)

    def insert_and_evict(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None, *,
                         telemetry=None) -> TableInsertAndEvict:
        res = ops_mod.insert_and_evict(self.state, self.cfg, self.keys(keys),
                                       self._rows(values), self._opt_keys(custom_scores),
                                       backend=self.backend, telemetry=telemetry)
        return TableInsertAndEvict(table=self, status=res.status, evicted=res.evicted)

    def find_or_insert(self, keys: Any, init_values: Any,
                       custom_scores: Optional[Any] = None,
                       return_evicted: bool = False, *,
                       telemetry=None) -> TableFindOrInsert:
        res = ops_mod.find_or_insert(self.state, self.cfg, self.keys(keys),
                                     self._rows(init_values), self._opt_keys(custom_scores),
                                     backend=self.backend, return_evicted=return_evicted,
                                     telemetry=telemetry)
        return TableFindOrInsert(table=self, values=res.values, found=res.found,
                                 status=res.status, evicted=res.evicted)

    def ingest(self, keys: Any, init_values: Any,
               custom_scores: Optional[Any] = None, *, telemetry=None) -> TableUpsert:
        res = ops_mod.ingest(self.state, self.cfg, self.keys(keys), self._rows(init_values),
                             self._opt_keys(custom_scores), backend=self.backend,
                             telemetry=telemetry)
        return TableUpsert(table=self, status=res.status)

    def accum_or_assign(self, keys: Any, values: Any,
                        custom_scores: Optional[Any] = None, *,
                        telemetry=None) -> TableUpsert:
        res = ops_mod.accum_or_assign(self.state, self.cfg, self.keys(keys),
                                      self._rows(values), self._opt_keys(custom_scores),
                                      telemetry=telemetry)
        return TableUpsert(table=self, status=res.status)

    def erase(self, keys: Any, *, telemetry=None) -> "HKVTable":
        ops_mod.erase(self.state, self.cfg, self.keys(keys), telemetry=telemetry)
        return self

    def clear(self) -> "HKVTable":
        ops_mod.clear(self.state, self.cfg)
        return self

    # -- maintenance sweeps ------------------------------------------------------

    def erase_if(self, pred: SweepPredicate, *, telemetry=None) -> TableSweep:
        """Remove every live entry matching `pred`."""
        res = ops_mod.erase_if(self.state, self.cfg, pred, backend=self.backend,
                               telemetry=telemetry)
        return TableSweep(table=self, swept=res.swept)

    def evict_if(self, pred: SweepPredicate, budget: int, limit=None, *,
                 telemetry=None) -> TableEvictIf:
        """Remove up to `budget` matching entries, coldest first, and hand
        them back as a rank-aligned EvictionStream."""
        res = ops_mod.evict_if(self.state, self.cfg, pred, budget, limit=limit,
                               backend=self.backend, telemetry=telemetry)
        return TableEvictIf(table=self, evicted=res.evicted, count=res.count)

    def stats(self):
        """Whole-table `TableStats` (occupancy histogram, score quantiles,
        load factor; ``repro_torch.maintenance.stats``)."""
        from repro_torch.maintenance import stats as stats_mod  # maintenance sits above core

        return stats_mod.stats_from_planes(self.state.keys, self.state.scores)

    def set_epoch(self, epoch: int) -> "HKVTable":
        table_mod.set_epoch(self.state, epoch)
        return self

    # -- sessions ----------------------------------------------------------------

    def session(self) -> "OpSession":
        """Open a role-aware op session on this handle (see OpSession)."""
        return OpSession(self)


# =============================================================================
# Op sessions: the role taxonomy as a planner
# =============================================================================


class SessionRef:
    """Deferred result of a session op; `.get()` after `commit()`."""

    __slots__ = ("op", "value", "_committed")

    def __init__(self, op: str):
        self.op = op
        self.value = None
        self._committed = False

    def get(self):
        if not self._committed:
            raise RuntimeError(f"session op {self.op!r} not executed yet: call session.commit()")
        return self.value

    def __repr__(self):
        state = "pending" if not self._committed else f"value={type(self.value).__name__}"
        return f"<SessionRef {self.op} {state}>"


@dataclasses.dataclass
class _RecordedOp:
    kind: str                    # op name
    role: str                    # reader | updater | inserter
    key_ref: Optional[int]       # index into the session's key batches (None: keyless)
    args: tuple                  # the op's payload
    ref: SessionRef
    shares_locate: bool = False  # decided by _plan


class OpSession:
    """Record table ops, share one locate among commuting ops on the same
    key batch, serialize at inserters (paper §3.5):

      * readers and updaters never change bucket membership, so the
        (bucket, slot, row) of a `locate` stays valid across any run of
        them, and ops on one key batch share one probe;
      * inserters are structural: each is a serialization point that
        invalidates every cached locate.

    Usage::

        s = table.session()
        hit = s.find(keys)                  # reader: a SessionRef
        s.assign(keys, new_values)          # updater: shares hit's locate
        st = s.insert_or_assign(k2, v2)     # inserter: a serialization point
        table = s.commit()                  # runs the plan; refs hold results
        print(s.explain())

    Results equal the same ops issued one by one, in the same order.  The
    port's ops update the state in place, so `commit()` returns the handle
    the session was opened on.  Key batches are told apart by identity:
    two ops share a locate when they were given the same object.
    """

    def __init__(self, table: HKVTable):
        self._table = table
        self._ops: list[_RecordedOp] = []
        self._key_ids: dict = {}       # id() of a key object -> batch index
        self._key_batches: list[torch.Tensor] = []
        self._key_objs: list = []      # the originals, kept alive: see _key_ref
        self._committed = False

    def _key_ref(self, keys: Any) -> int:
        tok = id(keys)
        if tok not in self._key_ids:
            self._key_ids[tok] = len(self._key_batches)
            self._key_batches.append(self._table.keys(keys))
            # keep the original object: identity is id()-based, and a freed
            # object's id may be reused by a later, different key batch
            self._key_objs.append(keys)
        return self._key_ids[tok]

    def _record(self, kind: str, role: str, keys: Any, *args) -> SessionRef:
        if self._committed:
            raise RuntimeError("session already committed; open a new one")
        ref = SessionRef(kind)
        kref = None if keys is None else self._key_ref(keys)
        self._ops.append(_RecordedOp(kind, role, kref, args, ref))
        return ref

    # -- recorded ops ----------------------------------------------------------

    def find(self, keys: Any) -> SessionRef:
        return self._record("find", _READER, keys)

    def find_rows(self, keys: Any) -> SessionRef:
        return self._record("find_rows", _READER, keys)

    def contains(self, keys: Any) -> SessionRef:
        return self._record("contains", _READER, keys)

    def assign(self, keys: Any, values: Any, update_scores: bool = False) -> SessionRef:
        return self._record("assign", _UPDATER, keys, self._table._rows(values), update_scores)

    def assign_add(self, keys: Any, deltas: Any) -> SessionRef:
        return self._record("assign_add", _UPDATER, keys, self._table._rows(deltas))

    def assign_scores(self, keys: Any, scores: Any) -> SessionRef:
        return self._record("assign_scores", _UPDATER, keys, self._table.keys(scores))

    def update_rows(self, keys: Any, fn, update_scores: bool = False) -> SessionRef:
        """Updater.  Read-modify-write of the full rows of resident keys:
        `fn` is a callable mapping the gathered rows [N, dim + aux] to
        their replacements (misses untouched; fn sees zero rows there), or
        an ``ops.RowUpdate`` (a sparse optimizer and summed gradients).  A
        callable shares the session's locate; a RowUpdate with no locate
        to share goes whole to ``ops.update_rows``, one update_scan launch
        on the card.  The ref holds an ``ops.UpdateRowsResult`` for a
        RowUpdate and the gathered ``FindRowsResult`` for a callable."""
        return self._record("update_rows", _UPDATER, keys, fn, update_scores)

    def insert_or_assign(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None) -> SessionRef:
        return self._record("insert_or_assign", _INSERTER, keys, self._table._rows(values),
                            self._table._opt_keys(custom_scores))

    def find_or_insert(self, keys: Any, init_values: Any,
                       custom_scores: Optional[Any] = None) -> SessionRef:
        return self._record("find_or_insert", _INSERTER, keys, self._table._rows(init_values),
                            self._table._opt_keys(custom_scores))

    def insert_and_evict(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None) -> SessionRef:
        return self._record("insert_and_evict", _INSERTER, keys, self._table._rows(values),
                            self._table._opt_keys(custom_scores))

    def erase(self, keys: Any) -> SessionRef:
        return self._record("erase", _INSERTER, keys)

    # -- planning --------------------------------------------------------------

    def _plan(self) -> list[list[_RecordedOp]]:
        """Split the ops into groups at the inserters and mark which
        non-structural ops reuse an earlier locate of their key batch."""
        groups: list[list[_RecordedOp]] = []
        cur: list[_RecordedOp] = []
        seen: set = set()
        for op in self._ops:
            if op.role == _INSERTER:
                if cur:
                    groups.append(cur)
                    cur = []
                op.shares_locate = False
                groups.append([op])
                seen = set()
            else:
                op.shares_locate = op.key_ref in seen
                if op.key_ref is not None:
                    seen.add(op.key_ref)
                cur.append(op)
        if cur:
            groups.append(cur)
        return groups

    def explain(self) -> str:
        """The plan in words (the reference's text): groups, shared
        probes, serialization points.  Before or after commit()."""
        lines = [f"session plan: {len(self._ops)} ops, "
                 f"{len(self._key_batches)} key batch(es)"]
        probes = 0
        for gi, group in enumerate(self._plan()):
            if group[0].role == _INSERTER:
                op = group[0]
                probes += 1
                lines.append(f"  group {gi} [INSERTER — serialization point]: "
                             f"{op.kind}(keys#{op.key_ref}) — invalidates cached locates")
                continue
            fresh = {op.key_ref for op in group if not op.shares_locate}
            probes += len(fresh)
            lines.append(f"  group {gi} [reader/updater — commuting]: "
                         f"{len(group)} op(s), {len(fresh)} locate(s)")
            for op in group:
                tag = "shares" if op.shares_locate else "issues"
                lines.append(f"    {op.kind}(keys#{op.key_ref}) — {tag} "
                             f"locate[keys#{op.key_ref}]")
        unfused = sum(1 for op in self._ops if op.key_ref is not None)
        lines.append(f"  probes: {probes} fused vs {unfused} unfused")
        return "\n".join(lines)

    # -- execution -------------------------------------------------------------

    def commit(self) -> HKVTable:
        """Run the plan, fill every SessionRef, and return the handle (the
        state was updated in place).  A second call does nothing more."""
        if self._committed:
            return self._table
        state, cfg, backend = self._table.state, self._table.cfg, self._table.backend
        locs: dict[int, find_mod.Locate] = {}
        for group in self._plan():
            for op in group:
                keys = None if op.key_ref is None else self._key_batches[op.key_ref]
                if op.role == _INSERTER:
                    locs.clear()   # a structural op: cached positions die
                    self._run_inserter(op, state, cfg, backend, keys)
                    continue
                loc = locs.get(op.key_ref)
                # a RowUpdate with no locate to share probes inside
                # ops.update_rows (one fused launch); a locate here would
                # break that
                structured = op.kind == "update_rows" and isinstance(op.args[0], ops_mod.RowUpdate)
                if loc is None and not structured:
                    loc = ops_mod.find_ptr(state, cfg, keys, backend=backend)
                    locs[op.key_ref] = loc
                self._run_nonstructural(op, state, cfg, keys, loc, backend)
        for op in self._ops:
            op.ref._committed = True
        self._committed = True
        return self._table

    @staticmethod
    def _run_nonstructural(op, state, cfg, keys, loc, backend):
        if op.kind == "find":
            op.ref.value = ops_mod.find(state, cfg, keys, loc=loc, backend=backend)
        elif op.kind == "find_rows":
            op.ref.value = ops_mod.find_rows(state, cfg, keys, loc=loc, backend=backend)
        elif op.kind == "contains":
            op.ref.value = ops_mod.contains(state, cfg, keys, loc=loc, backend=backend)
        elif op.kind == "assign":
            values, update_scores = op.args
            op.ref.value = ops_mod.assign(state, cfg, keys, values,
                                          update_scores=update_scores, loc=loc)
        elif op.kind == "assign_add":
            (deltas,) = op.args
            op.ref.value = ops_mod.assign_add(state, cfg, keys, deltas, loc=loc)
        elif op.kind == "assign_scores":
            (scores,) = op.args
            op.ref.value = ops_mod.assign_scores(state, cfg, keys, scores, loc=loc)
        elif op.kind == "update_rows":
            fn, update_scores = op.args
            if isinstance(fn, ops_mod.RowUpdate):
                op.ref.value = ops_mod.update_rows(state, cfg, keys, fn.grads, fn.opt,
                                                   update_scores=update_scores, loc=loc,
                                                   backend=backend)
            else:
                got = ops_mod.find_rows(state, cfg, keys, loc=loc, backend=backend)
                ops_mod.assign(state, cfg, keys, fn(got.rows), update_scores=update_scores,
                               loc=loc)
                op.ref.value = got
        else:  # pragma: no cover - _record admits no other kind
            raise AssertionError(op.kind)

    @staticmethod
    def _run_inserter(op, state, cfg, backend, keys):
        if op.kind == "insert_or_assign":
            values, cs = op.args
            op.ref.value = ops_mod.insert_or_assign(state, cfg, keys, values, cs,
                                                    backend=backend).status
        elif op.kind == "find_or_insert":
            init, cs = op.args
            res = ops_mod.find_or_insert(state, cfg, keys, init, cs, backend=backend)
            op.ref.value = (res.values, res.found, res.status)
        elif op.kind == "insert_and_evict":
            values, cs = op.args
            op.ref.value = ops_mod.insert_and_evict(state, cfg, keys, values, cs,
                                                    backend=backend)
        elif op.kind == "erase":
            op.ref.value = ops_mod.erase(state, cfg, keys)
        else:  # pragma: no cover - _record admits no other kind
            raise AssertionError(op.kind)
