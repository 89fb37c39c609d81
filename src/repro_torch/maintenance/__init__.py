"""Table maintenance (the port of ``repro.maintenance``).

Policy-driven eviction as a BETWEEN-waves activity: the predicated bulk
sweeps (`erase_if` / `evict_if` in ``core/ops.py``, against the
declarative `SweepPredicate`), TTL/epoch expiry, proactive tier
rebalancing, whole-table observability (`TableStats`), and the
wave-interleaved `MaintenanceScheduler` the serving engine drives them
from.

    from repro_torch.maintenance import (MaintenancePolicy, MaintenanceScheduler,
                                         SweepPredicate)
    sched = MaintenanceScheduler(MaintenancePolicy(
        every_waves=4, sweep_budget=512, ttl_epochs=3, advance_epoch=True))
    eng = OnlineEmbeddingEngine(pub, wave_size=1024, miss_policy="admit",
                                scheduler=sched)

`SweepPredicate` itself lives in ``repro_torch.core.predicates``; it is
re-exported here as part of the subsystem's surface.
"""

from repro_torch.core.predicates import SweepPredicate  # noqa: F401
from repro_torch.maintenance.rebalance import RebalanceResult, rebalance  # noqa: F401
from repro_torch.maintenance.scheduler import (  # noqa: F401
    MaintenancePolicy,
    MaintenanceReport,
    MaintenanceScheduler,
    MaintenanceTotals,
)
from repro_torch.maintenance.stats import (  # noqa: F401
    TableStats,
    combine_stats,
    stats_from_planes,
)
