"""HKV-backed dynamic embedding: the cache-semantic table as a model's
input layer (the port of ``repro/embedding/dynamic.py``).

Training step:
  1. ``lookup_train``: find_or_insert on the flattened token batch, the
     step's one structural op.  New tokens are admitted subject to the
     table's score-based admission; at λ = 1.0 the table stays full and
     low-score embeddings are evicted in place.
  2. The model consumes the rows; autograd gives d(loss)/d(rows).
  3. ``apply_grads``: gradients summed per unique token feed the sparse
     optimizer, whose state lives in the rows' aux columns, as one
     structured ``RowUpdate`` session op: on the card one fused
     update_scan launch.

Serving: ``lookup_serve`` finds; a token not in the table gets the same
deterministic init row training would insert.

With ``hot_capacity`` set, the table is a ``TieredHKVTable``: a hot tier
of ``hot_capacity`` slots in HBM in front of a ``capacity``-slot cold tier
whose value plane uses ``cold_value_tier`` (pinned host memory on the
card).  The embedding's contract is unchanged; the table has to hold its
hot set in HBM, not all of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import u64
from repro_torch.core.api import HKVTable
from repro_torch.core.table import HKVConfig
from repro_torch.core.tiered import TieredHKVTable, TieredState
from repro_torch.embedding.sparse_opt import SparseOptimizer
from repro_torch.obs.trace import span


def _shape(tokens) -> tuple:
    return tuple(tokens.shape) if hasattr(tokens, "shape") else np.shape(tokens)


@dataclasses.dataclass(frozen=True)
class HKVEmbedding:
    capacity: int                      # table slots (independent of the key space)
    dim: int
    optimizer: SparseOptimizer = SparseOptimizer("rowwise_adagrad")
    buckets_per_key: int = 2           # dual bucket (§3.4)
    score_policy: str = "lru"
    value_dtype: torch.dtype = torch.float32
    value_tier: str = "hbm"
    backend: str = "auto"              # 'auto' | 'plain' (core/ops.py)
    # the tier hierarchy: with hot_capacity set, a hot tier of that many
    # slots in front of a `capacity`-slot cold tier placed per
    # cold_value_tier, whose 'custom' policy keeps the demoted pairs'
    # translated scores
    hot_capacity: Optional[int] = None
    cold_score_policy: str = "custom"
    cold_value_tier: str = "hmem"

    @property
    def is_tiered(self) -> bool:
        return self.hot_capacity is not None

    @property
    def total_capacity(self) -> int:
        return self.capacity + (self.hot_capacity or 0)

    def config(self) -> HKVConfig:
        """The flat table's config; the HOT tier's when tiered."""
        return HKVConfig(capacity=self.hot_capacity if self.is_tiered else self.capacity,
                         dim=self.dim, buckets_per_key=self.buckets_per_key,
                         score_policy=self.score_policy, value_dtype=self.value_dtype,
                         value_tier=self.value_tier,
                         aux_value_dim=self.optimizer.aux_dim(self.dim))

    def cold_config(self) -> HKVConfig:
        return dataclasses.replace(self.config(), capacity=self.capacity,
                                   score_policy=self.cold_score_policy,
                                   value_tier=self.cold_value_tier)

    def create(self, device=None):
        """An empty table on `device` (default: the card; raises without
        one, pass device='cpu' for the CPU): an HKVTable, or a
        TieredHKVTable when `hot_capacity` is set."""
        if self.is_tiered:
            return TieredHKVTable.from_configs(self.config(), self.cold_config(),
                                               backend=self.backend, device=device)
        return HKVTable.create(self.config(), device=device, backend=self.backend)

    def wrap(self, state):
        """Bind an existing state (an HKVState, or a TieredState when
        tiered) to this embedding's handle (no copy)."""
        if self.is_tiered:
            return TieredHKVTable.wrap(TieredState(*state), self.config(), self.cold_config(),
                                       backend=self.backend)
        return HKVTable.wrap(state, self.config(), backend=self.backend)

    # -- key and init derivation ---------------------------------------------

    def keys_of(self, tokens) -> torch.Tensor:
        """Token ids -> int64 keys: a negative id (padding) becomes EMPTY,
        any other keeps its low 32 bits (the reference's uint32 cast)."""
        t = torch.as_tensor(tokens).reshape(-1).to(torch.int64)
        return torch.where(t < 0, u64.EMPTY, t & u64.MASK32)

    def default_rows(self, keys: torch.Tensor) -> torch.Tensor:
        """Deterministic init per key: counter-mode fmix32 bits -> uniform
        rows in ±1/sqrt(dim), bit for bit the reference's."""
        with span("embedding.default_rows"):
            h1, _ = u64.hash_pair(keys)
            cols = torch.arange(self.dim, dtype=torch.int64, device=keys.device)
            col_salt = ((cols * 0x9E3779B9) & u64.MASK32) ^ 0x85EBCA6B
            bits = u64.fmix32(h1[:, None] ^ col_salt[None, :])
            uni = bits.to(torch.float32) * (1.0 / 4294967296.0)
            return ((uni - 0.5) * float(2.0 / np.sqrt(self.dim))).to(self.value_dtype)

    # -- roles -----------------------------------------------------------------

    def lookup_train(self, table: HKVTable, tokens):
        """Inserter: find_or_insert the token batch.  Returns (table, rows
        of shape tokens.shape + (dim,))."""
        with span("embedding.lookup_train"):
            keys = self.keys_of(tokens).to(table.device)
            res = table.find_or_insert(keys, self.default_rows(keys))
            return res.table, res.values.reshape(_shape(tokens) + (self.dim,))

    def lookup_serve(self, table: HKVTable, tokens) -> torch.Tensor:
        """Reader: find; a miss falls back to the deterministic init row.
        On a tiered table the pure reader (``find(promote=False)``): a
        promotion would be structural work the serve path throws away."""
        keys = self.keys_of(tokens).to(table.device)
        if isinstance(table, TieredHKVTable):
            res = table.find(keys, promote=False)
        else:
            res = table.find(keys)
        vals = torch.where(res.found[:, None], res.values, self.default_rows(keys))
        return vals.reshape(_shape(tokens) + (self.dim,))

    def sum_grads(self, tokens, grads: torch.Tensor):
        """The gradient rows summed per unique token, compacted: group g's
        key at lane g (EMPTY beyond the groups), its summed row at row g.
        Returns (unique keys int64 [N], sums [N, dim])."""
        with span("embedding.sum_grads"):
            keys = self.keys_of(tokens).to(grads.device)
            g = grads.reshape(-1, self.dim)
            d = merge_mod.dedupe_keys(keys)
            uniq = torch.full_like(keys, u64.EMPTY)
            uniq[d.gid] = keys[d.idx_sorted]
            g_sum = torch.zeros_like(g).index_add_(0, d.gid, g[d.idx_sorted])
            return uniq, g_sum

    def apply_grads(self, table: HKVTable, tokens, grads: torch.Tensor) -> HKVTable:
        """Updater: the sparse optimizer step on the rows of the batch's
        resident tokens, as one structured update_rows (on the card one
        update_scan launch).  Tokens the table did not admit have no row
        and do not train.  The sums run in batch order on the CPU and as
        float32 atomics on the card."""
        with span("embedding.apply_grads"):
            uniq, g_sum = self.sum_grads(tokens, grads)
            s = table.session()
            s.update_rows(uniq, ops_mod.RowUpdate(self.optimizer, g_sum))
            return s.commit()

    def ingest(self, table: HKVTable, tokens) -> HKVTable:
        """Admit the batch's new tokens without reading values."""
        keys = self.keys_of(tokens).to(table.device)
        return table.ingest(keys, self.default_rows(keys)).table
