"""repro_torch: the PyTorch/CUDA port of the HKV table package ``repro``.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Ops run on the card unless the caller asks for the CPU:

    from repro_torch import HKVTable, SweepPredicate
    table = HKVTable.create(capacity=2**27, dim=32, buckets_per_key=2)

The training path: ``repro_torch.embedding.HKVEmbedding`` (lookup_train,
lookup_serve, apply_grads) and ``repro_torch.models.dlrm.DLRM``.  The tier
hierarchy: ``TieredHKVTable`` (an HBM hot tier over a cold tier whose value
plane is in pinned host memory, ``value_tier='hmem'``).  The sharded table:
``ShardedHKVTable`` over a mesh from ``repro_torch.launch.mesh.make_dev_mesh``.
"""

from repro_torch.core.api import (HKVTable, KVTable, OpSession, TableEvictIf, TableFindOrInsert,
                                  TableInsertAndEvict, TableSweep, TableUpsert, dedupe_keys,
                                  normalize_keys, table_signature)
from repro_torch.core.merge import EvictionStream
from repro_torch.core.ops import RowUpdate
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.table import HKVConfig, HKVState
from repro_torch.core.tiered import (TieredDemote, TieredEvictIf, TieredFind, TieredFindOrInsert,
                                     TieredHKVTable, TieredState, TieredSweep, TieredUpsert,
                                     translate_scores)
from repro_torch.distributed import ShardedHKVEmbedding, ShardedHKVTable
from repro_torch.launch.mesh import Mesh, make_dev_mesh, make_mesh

__all__ = ["EvictionStream", "HKVConfig", "HKVState", "HKVTable", "KVTable", "Mesh", "OpSession",
           "RowUpdate", "ShardedHKVEmbedding", "ShardedHKVTable", "SweepPredicate",
           "TableEvictIf", "TableFindOrInsert", "TableInsertAndEvict", "TableSweep", "TableUpsert",
           "TieredDemote", "TieredEvictIf", "TieredFind", "TieredFindOrInsert", "TieredHKVTable",
           "TieredState", "TieredSweep", "TieredUpsert", "dedupe_keys", "make_dev_mesh",
           "make_mesh", "normalize_keys", "table_signature", "translate_scores"]
