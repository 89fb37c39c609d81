"""hkv_dlrm: the paper's own workload (Fig. 1), a DLRM-style recommender
whose sparse-feature embeddings live in one HKV cache-semantic table under
continuous online ingestion (the port's copy of
``repro/configs/hkv_dlrm.py``).

The paper's benchmark configs (Table 5):
  config A: dim=8,  capacity=128M
  config B: dim=32, capacity=128M
  config C: dim=64, capacity=64M
  config D: dim=64, capacity=128M, HBM+HMEM value tier (the value plane
            in pinned host memory on the card, ``core.table``)

`mlp_bottom` and `mlp_top` are carried over as the reference has them;
neither package's DLRM reads them (its widths are fixed, see
``models/dlrm.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.embedding.dynamic import HKVEmbedding
from repro_torch.embedding.sparse_opt import SparseOptimizer


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    num_sparse: int = 26              # criteo-style sparse fields
    dense_features: int = 13
    dim: int = 32
    capacity: int = 128 * 1024 * 1024
    mlp_bottom: tuple = (512, 256)
    mlp_top: tuple = (1024, 512, 1)
    value_tier: str = "hbm"
    buckets_per_key: int = 2
    score_policy: str = "lru"

    def embedding(self) -> HKVEmbedding:
        return HKVEmbedding(
            capacity=self.capacity,
            dim=self.dim,
            optimizer=SparseOptimizer("rowwise_adagrad", lr=0.01),
            buckets_per_key=self.buckets_per_key,
            score_policy=self.score_policy,
            value_tier=self.value_tier,
        )


PAPER_CONFIGS = {
    "A": DLRMConfig("A", dim=8, capacity=128 * 2**20),
    "B": DLRMConfig("B", dim=32, capacity=128 * 2**20),
    "C": DLRMConfig("C", dim=64, capacity=64 * 2**20),
    "D": DLRMConfig("D", dim=64, capacity=128 * 2**20, value_tier="hmem"),
}


def scaled(cfg: DLRMConfig, scale: int) -> DLRMConfig:
    """Shrink the capacity by `scale` (for small runs)."""
    return dataclasses.replace(cfg, capacity=max(256, cfg.capacity // scale))
