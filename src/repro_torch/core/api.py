"""The public surface of the port: the `HKVTable` handle.

Unlike the reference's immutable handle, this one owns a state that its
ops update in place (see ``core.table``); ``insert_or_assign`` returns the
same handle as ``.table`` so that reference-style call chains read the
same.  ``snapshot()`` is the explicit copy.

    table = HKVTable.create(capacity=2**27, dim=32, buckets_per_key=2)
    res = table.insert_or_assign(keys, values)   # res.table, res.status
    out = table.find(keys)                       # out.values, out.found
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import ops as ops_mod
from repro_torch.core import table as table_mod
from repro_torch.core import u64
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


class TableUpsert(NamedTuple):
    table: "HKVTable"
    status: torch.Tensor     # int8 [N] — merge status codes, batch order


@dataclasses.dataclass
class HKVTable:
    """Cache-semantic HKV hash table; ops mutate `state` in place."""

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

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def snapshot(self) -> "HKVTable":
        """An independent copy of the table (state planes cloned)."""
        return dataclasses.replace(self, state=self.state.clone())

    def find(self, keys: Any) -> ops_mod.FindResult:
        return ops_mod.find(self.state, self.cfg, normalize_keys(keys, self.device),
                            backend=self.backend)

    def insert_or_assign(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None) -> TableUpsert:
        cs = None if custom_scores is None else normalize_keys(custom_scores, self.device)
        res = ops_mod.insert_or_assign(
            self.state, self.cfg, normalize_keys(keys, self.device),
            torch.as_tensor(values, device=self.device), custom_scores=cs,
            backend=self.backend)
        return TableUpsert(table=self, status=res.status)

    def size(self) -> int:
        return ops_mod.size(self.state)

    def load_factor(self) -> float:
        return ops_mod.load_factor(self.state)

    def set_epoch(self, epoch: int) -> "HKVTable":
        table_mod.set_epoch(self.state, epoch)
        return self

