"""The sharded table: ``ShardedHKVTable`` over a device mesh
(``repro_torch.launch.mesh``), keys routed to their owner shards by an
all-to-all (the port of ``repro/distributed/table_sharding.py``)."""

from repro_torch.distributed.table_sharding import (ShardedEvictIf, ShardedFind,
                                                    ShardedFindOrInsert, ShardedHKVEmbedding,
                                                    ShardedHKVTable, ShardedSweep, ShardedUpsert,
                                                    all_to_all)

__all__ = ["ShardedEvictIf", "ShardedFind", "ShardedFindOrInsert", "ShardedHKVEmbedding",
           "ShardedHKVTable", "ShardedSweep", "ShardedUpsert", "all_to_all"]
