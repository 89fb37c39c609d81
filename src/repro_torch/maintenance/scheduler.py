"""MaintenanceScheduler: wave-interleaved table maintenance (the port of
``repro/maintenance/scheduler.py``).

The serving loop (``repro_torch.serving.embedding_engine``) is
wave-batched, with host control between waves.  Those gaps are where
maintenance belongs: the paper's policy-driven eviction as a BETWEEN-waves
activity instead of a tax inside every serving upsert.  Once every
`every_waves` waves the scheduler snapshots the current table from its
`TableSource`, runs one maintenance step under a fixed move budget, and
offers the result back through the same compare-and-swap the engine's own
admissions use (`publisher.offer`), so a concurrent trainer `publish`
beats maintenance exactly as it beats admissions.

One maintenance step, in order:

  1. epoch tick      (optional) advance the table epoch, the TTL clock;
                     one maintenance interval == one TTL window.
  2. TTL expiry      `erase_if(expire_before(epoch - ttl))` for tables on
                     an epoch_* score policy (both tiers when tiered).
  3. rebalance       watermark-driven hot->cold demotion on tiered tables
                     (``repro_torch.maintenance.rebalance``), at most
                     `sweep_budget` moves.

The port's tables change in place: the step changes the snapshot's table
and offers that same table.  The step function is built once per table
signature (``core.api.table_signature``), as the reference compiles one,
and rebuilt when a source publishes a structurally different table.
Counters accumulate on the scheduler (`.totals`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.api import table_signature
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.tiered import TieredHKVTable
from repro_torch.maintenance.rebalance import rebalance as _rebalance
from repro_torch.obs.trace import as_tracer


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """Static knobs of one scheduler (everything the step function bakes in).

    every_waves     run cadence: one maintenance step per N waves.
    sweep_budget    max structural moves per step (evict_if lane count:
                    the step budget that bounds maintenance latency).
    ttl_epochs      expire entries untouched for this many epochs
                    (None = no expiry; requires an epoch_* score policy).
    advance_epoch   tick the table epoch at each step (one maintenance
                    interval == one TTL window).  Leave False when the
                    application owns the epoch clock (`set_epoch`).
    low/high_watermark   tiered rebalance hysteresis
                    (``repro_torch.maintenance.rebalance``);
                    `rebalance=False` disables the sweep.
    """

    every_waves: int = 1
    sweep_budget: int = 256
    ttl_epochs: Optional[int] = None
    advance_epoch: bool = False
    rebalance: bool = True
    low_watermark: float = 0.7
    high_watermark: float = 0.9

    def __post_init__(self):
        if self.every_waves < 1:
            raise ValueError("every_waves must be >= 1")
        if self.sweep_budget < 1:
            raise ValueError("sweep_budget must be >= 1")


class MaintenanceReport(NamedTuple):
    """One step's outcome (host-side ints/floats)."""

    expired: int        # entries removed by TTL expiry
    demoted: int        # entries proactively moved hot -> cold
    dropped: int        # pairs lost at the cold boundary during demotion
    elapsed_s: float    # host wall clock of the step, its device work included
    table_version: int  # source version the step ran against
    applied: bool       # False when a concurrent publish beat the offer


class MaintenanceTotals(NamedTuple):
    runs: int
    expired: int
    demoted: int
    dropped: int
    skipped_offers: int  # steps whose table lost the offer CAS
    time_s: float
    deferred: int = 0    # steps skipped because the between-wave slack
                         # budget was already spent on staging (the
                         # engine's host_budget_s: one budget for staging
                         # and maintenance)


class MaintenanceScheduler:
    """Drives maintenance steps between serving waves (see module doc).

        sched = MaintenanceScheduler(MaintenancePolicy(
            every_waves=4, sweep_budget=512,
            ttl_epochs=3, advance_epoch=True))
        eng = OnlineEmbeddingEngine(publisher, wave_size=1024,
                                    miss_policy="admit", scheduler=sched)
        # ... eng.step() now runs sched.on_wave(source) after each wave
        print(sched.totals)

    Also usable directly (no engine): `table, report = sched.run(table)`.
    """

    def __init__(self, policy: MaintenancePolicy = MaintenancePolicy(),
                 *, tracer: Optional[Any] = None):
        self.policy = policy
        self.reports: list[MaintenanceReport] = []
        self._waves = 0
        self._step_fn = None
        self._step_sig = None     # table signature the step fn was built for
        self._cost_ewma = None    # smoothed per-step host cost (slack gating)
        self.deferred = 0         # steps skipped for lack of slack budget
        # span tracing: maintenance.run spans + maintenance.deferred
        # instants (repro_torch.obs.trace; noop when unwired)
        self.tracer = as_tracer(tracer)

    # -- step construction -----------------------------------------------------

    def _supports_ttl(self, table: Any) -> bool:
        if self.policy.ttl_epochs is None:
            return False
        cfg = getattr(getattr(table, "hot", table), "cfg", None)
        if cfg is None or not hasattr(table, "set_epoch"):
            raise ValueError(
                "ttl_epochs requires a table with an epoch clock "
                f"(set_epoch + an epoch_* score policy); got "
                f"{type(table).__name__}")
        if not cfg.score_policy.startswith("epoch_"):
            raise ValueError(
                f"ttl_epochs requires an epoch_* score policy; table runs "
                f"{cfg.score_policy!r}")
        return True

    def _build(self, table: Any):
        pol = self.policy
        is_tiered = isinstance(table, TieredHKVTable)
        ttl_on = self._supports_ttl(table)
        rebalance_on = pol.rebalance and is_tiered
        can_sweep = hasattr(table, "erase_if")

        def step(t):
            expired, demoted, dropped = 0, 0, 0
            if pol.advance_epoch and hasattr(t, "set_epoch"):
                t = t.set_epoch(t.epoch + 1)      # uint32: set_epoch wraps
            if ttl_on and can_sweep:
                ttl, epoch = pol.ttl_epochs, t.epoch
                thr = epoch - ttl if epoch >= ttl else 0
                r = t.erase_if(SweepPredicate.expire_before(thr))
                t, expired = r.table, r.swept
            if rebalance_on:
                rb = _rebalance(t, low_watermark=pol.low_watermark,
                                high_watermark=pol.high_watermark,
                                budget=pol.sweep_budget)
                t, demoted, dropped = rb.table, rb.moved, rb.dropped
            return t, expired, demoted, dropped

        return step

    # -- driving ---------------------------------------------------------------

    def run(self, table: Any, *, version: int = 0) -> tuple[Any, MaintenanceReport]:
        """One maintenance step against a table the caller owns.  The step
        function is keyed on the table's static signature: a source that
        starts publishing a structurally different table (flat->tiered,
        backend flip, dim change) gets a freshly built step."""
        sig = table_signature(table)
        if self._step_fn is None or sig != self._step_sig:
            self._step_fn = self._build(table)
            self._step_sig = sig
        t0 = time.perf_counter()
        with self.tracer.span("maintenance.run", version=version):
            t2, expired, demoted, dropped = self._step_fn(table)
            # the step's device work ends before the host reads its counts
            device = getattr(t2, "device", None)
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            expired, demoted, dropped = int(expired), int(demoted), int(dropped)
        elapsed = time.perf_counter() - t0
        self._cost_ewma = (elapsed if self._cost_ewma is None
                           else 0.7 * self._cost_ewma + 0.3 * elapsed)
        rep = MaintenanceReport(expired=expired, demoted=demoted, dropped=dropped,
                                elapsed_s=elapsed, table_version=version, applied=True)
        self.reports.append(rep)
        return t2, rep

    def on_wave(self, source: Any, slack_s: Optional[float] = None) -> Optional[MaintenanceReport]:
        """Wave-interleave hook: called by the engine after each wave.
        Runs a step every `every_waves` waves against the source's current
        snapshot and offers the result back (CAS: a racing trainer publish
        wins, as it beats admission offers).

        `slack_s` is the remaining between-wave host budget after the
        engine's own staging work (pack/unpack) spent its share: one
        budget, competed for.  When the step's estimated cost (EWMA of past
        runs) exceeds the remaining slack, the step DEFERS to the next
        interval (`totals.deferred`); the first step always runs so that
        the estimate exists.  `slack_s=None` keeps the cadence-only
        contract."""
        self._waves += 1
        if self._waves % self.policy.every_waves:
            return None
        if (slack_s is not None and self._cost_ewma is not None
                and self._cost_ewma > slack_s):
            self.deferred += 1
            self.tracer.instant("maintenance.deferred", slack_s=slack_s,
                                cost_ewma_s=self._cost_ewma)
            return None
        version, table = source.snapshot()
        table2, rep = self.run(table, version=version)
        applied = bool(source.offer(version, table2))
        if not applied:
            rep = rep._replace(applied=False)
            self.reports[-1] = rep
        return rep

    # -- observability ---------------------------------------------------------

    @property
    def totals(self) -> MaintenanceTotals:
        return MaintenanceTotals(
            runs=len(self.reports),
            expired=sum(r.expired for r in self.reports),
            demoted=sum(r.demoted for r in self.reports),
            dropped=sum(r.dropped for r in self.reports),
            skipped_offers=sum(1 for r in self.reports if not r.applied),
            time_s=sum(r.elapsed_s for r in self.reports),
            deferred=self.deferred,
        )
