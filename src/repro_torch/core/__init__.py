"""Table core: key representation, policies, state, locate, merge, ops, handle.

Consumers import the handle layer from here::

    from repro_torch.core import HKVTable
    table = HKVTable.create(capacity=128 * 128, dim=32)

`repro_torch.core.ops` / `repro_torch.core.table` stay importable as the
underlying engine.
"""

from repro_torch.core.api import (  # noqa: F401
    HKVTable,
    KVTable,
    OpSession,
    TableEvictIf,
    TableFindOrInsert,
    TableInsertAndEvict,
    TableSweep,
    TableUpsert,
    dedupe_keys,
    normalize_keys,
)
from repro_torch.core.merge import EvictionStream  # noqa: F401
from repro_torch.core.predicates import SweepPredicate  # noqa: F401
from repro_torch.core.table import HKVConfig, HKVState  # noqa: F401
from repro_torch.core.tiered import (  # noqa: F401
    TieredDemote,
    TieredEvictIf,
    TieredFind,
    TieredFindOrInsert,
    TieredHKVTable,
    TieredState,
    TieredSweep,
    TieredUpsert,
    translate_scores,
)
