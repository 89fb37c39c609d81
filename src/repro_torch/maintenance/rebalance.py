"""Proactive tier rebalancing: watermark-driven hot->cold demotion (the
port of ``repro/maintenance/rebalance.py``).

The tier hierarchy (``core/tiered.py``) demotes REACTIVELY: a full hot
bucket demotes its victim inside the serving-path upsert, so at steady
state every admission pays an eviction and a cold-tier upsert on the
latency-critical wave.  This module moves that work BETWEEN waves: when
the hot tier's occupancy rises past `high_watermark`, the coldest hot
entries (the ones reactive eviction would pick next anyway) are swept out
down to `low_watermark` through `evict_if`'s coldest-first rank order and
demoted through the existing cascade (`TieredHKVTable.demote`: the same
`EvictionStream` transport and `translate_scores` crossing as the reactive
path).  The next wave's admissions then land in empty slots.

The two-watermark hysteresis buys (high - low) * capacity admissions of
headroom a sweep, so the sweep cadence decouples from the admission rate.
At most `budget` moves a call (the scheduler's step budget).  The sweep
runs whatever the occupancy, as in the reference; below the trigger its
`limit` is 0 and it moves nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ops as ops_mod
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.tiered import TieredHKVTable


class RebalanceResult(NamedTuple):
    table: TieredHKVTable
    moved: torch.Tensor      # int64 []: entries demoted hot -> cold
    dropped: torch.Tensor    # int64 []: pairs lost at the cold boundary


def rebalance(table: TieredHKVTable, *, low_watermark: float = 0.7,
              high_watermark: float = 0.9, budget: int = 256) -> RebalanceResult:
    """One watermark sweep (see the module docstring).

    Moves nothing while hot occupancy <= high_watermark * capacity; above
    it, demotes min(budget, occupancy - low_watermark * capacity) of the
    coldest hot entries.  The tiers change in place; `.table` is the
    hierarchy."""
    if not 0.0 <= low_watermark <= high_watermark <= 1.0:
        raise ValueError(
            f"watermarks must satisfy 0 <= low <= high <= 1; got "
            f"{low_watermark}/{high_watermark}")
    hot = table.hot
    cap = hot.capacity
    budget = min(budget, cap)
    occ = hot.size()
    need = min(max(occ - int(low_watermark * cap), 0), budget)
    limit = need if occ > int(high_watermark * cap) else 0
    ev = ops_mod.evict_if(hot.state, hot.cfg, SweepPredicate.always(), budget, limit=limit,
                          backend=hot.backend)
    dem = table.demote(ev.evicted)   # the hot tier lost its swept entries in place
    return RebalanceResult(table=dem.table, moved=dem.demoted, dropped=dem.dropped)
