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
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import table as table_mod
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
      * unsigned integers narrower than 64 bits: zero-extended.
    A signed id cannot exceed 2**63 - 1, so keys at or above 2**63 enter
    through numpy uint64.
    """
    if isinstance(keys, torch.Tensor):
        if keys.dtype in (torch.uint8, torch.uint16, torch.uint32):
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

    def with_backend(self, backend: str) -> "HKVTable":
        """A handle on the SAME state with another backend: ops through
        either change both."""
        return dataclasses.replace(self, backend=backend)

    def snapshot(self) -> "HKVTable":
        """An independent copy of the table (state planes cloned)."""
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
        return torch.as_tensor(values, device=self.device)

    def _opt_keys(self, x: Optional[Any]) -> Optional[torch.Tensor]:
        return None if x is None else self.keys(x)

    # -- readers -------------------------------------------------------------

    def find(self, keys: Any) -> ops_mod.FindResult:
        return ops_mod.find(self.state, self.cfg, self.keys(keys), backend=self.backend)

    def find_rows(self, keys: Any) -> ops_mod.FindRowsResult:
        return ops_mod.find_rows(self.state, self.cfg, self.keys(keys), backend=self.backend)

    def find_ptr(self, keys: Any) -> find_mod.Locate:
        return ops_mod.find_ptr(self.state, self.cfg, self.keys(keys), backend=self.backend)

    def contains(self, keys: Any) -> torch.Tensor:
        return ops_mod.contains(self.state, self.cfg, self.keys(keys), backend=self.backend)

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

    def assign(self, keys: Any, values: Any, update_scores: bool = False) -> "HKVTable":
        ops_mod.assign(self.state, self.cfg, self.keys(keys), self._rows(values),
                       update_scores=update_scores)
        return self

    def assign_add(self, keys: Any, deltas: Any) -> "HKVTable":
        ops_mod.assign_add(self.state, self.cfg, self.keys(keys), self._rows(deltas))
        return self

    def assign_scores(self, keys: Any, scores: Any) -> "HKVTable":
        ops_mod.assign_scores(self.state, self.cfg, self.keys(keys), self.keys(scores))
        return self

    # -- inserters -------------------------------------------------------------

    def insert_or_assign(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None) -> TableUpsert:
        res = ops_mod.insert_or_assign(self.state, self.cfg, self.keys(keys),
                                       self._rows(values), self._opt_keys(custom_scores),
                                       backend=self.backend)
        return TableUpsert(table=self, status=res.status)

    def insert_and_evict(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None) -> TableInsertAndEvict:
        res = ops_mod.insert_and_evict(self.state, self.cfg, self.keys(keys),
                                       self._rows(values), self._opt_keys(custom_scores),
                                       backend=self.backend)
        return TableInsertAndEvict(table=self, status=res.status, evicted=res.evicted)

    def find_or_insert(self, keys: Any, init_values: Any,
                       custom_scores: Optional[Any] = None,
                       return_evicted: bool = False) -> TableFindOrInsert:
        res = ops_mod.find_or_insert(self.state, self.cfg, self.keys(keys),
                                     self._rows(init_values), self._opt_keys(custom_scores),
                                     backend=self.backend, return_evicted=return_evicted)
        return TableFindOrInsert(table=self, values=res.values, found=res.found,
                                 status=res.status, evicted=res.evicted)

    def ingest(self, keys: Any, init_values: Any,
               custom_scores: Optional[Any] = None) -> TableUpsert:
        res = ops_mod.ingest(self.state, self.cfg, self.keys(keys), self._rows(init_values),
                             self._opt_keys(custom_scores), backend=self.backend)
        return TableUpsert(table=self, status=res.status)

    def accum_or_assign(self, keys: Any, values: Any,
                        custom_scores: Optional[Any] = None) -> TableUpsert:
        res = ops_mod.accum_or_assign(self.state, self.cfg, self.keys(keys),
                                      self._rows(values), self._opt_keys(custom_scores))
        return TableUpsert(table=self, status=res.status)

    def erase(self, keys: Any) -> "HKVTable":
        ops_mod.erase(self.state, self.cfg, self.keys(keys))
        return self

    def clear(self) -> "HKVTable":
        ops_mod.clear(self.state, self.cfg)
        return self

    # -- maintenance sweeps ------------------------------------------------------

    def erase_if(self, pred: SweepPredicate) -> TableSweep:
        """Remove every live entry matching `pred`."""
        res = ops_mod.erase_if(self.state, self.cfg, pred, backend=self.backend)
        return TableSweep(table=self, swept=res.swept)

    def evict_if(self, pred: SweepPredicate, budget: int, limit=None) -> TableEvictIf:
        """Remove up to `budget` matching entries, coldest first, and hand
        them back as a rank-aligned EvictionStream."""
        res = ops_mod.evict_if(self.state, self.cfg, pred, budget, limit=limit,
                               backend=self.backend)
        return TableEvictIf(table=self, evicted=res.evicted, count=res.count)

    def set_epoch(self, epoch: int) -> "HKVTable":
        table_mod.set_epoch(self.state, epoch)
        return self
