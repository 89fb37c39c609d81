"""OnlineEmbeddingEngine: the paper's title scenario as a serving loop (the
port of ``repro/serving/embedding_engine.py``).

Continuous online embedding storage (§1, Fig. 1) means a table read under
heavy traffic WHILE an online trainer keeps ingesting and updating.  This
engine is that read path, over an `HKVTable`, a `TieredHKVTable`, a
`DictKVTable` or a `ShardedHKVTable` (whose owners admit with their own
init rows, and whose readonly waves promote on tiered shards).

Admission comes in two modes (`admission=`):

  'wave'        wave-granular: requests queue whole; each `step()` packs
                up to `wave_size` key lanes (EMPTY-padded), launches,
                waits, and unpacks: one serial cycle per wave.
  'continuous'  continuous batching: admission is decoupled from the
                serving cycle.  A persistent staging buffer with per-lane
                occupancy splices arriving requests into the partially
                drained staging wave at `submit()` time, and every time
                the buffer FILLS, the wave dispatches right there, so a
                burst's waves queue back to back on the card.  In-flight
                waves sit in a deque; `poll()` reaps finished ones without
                blocking, `step()` flushes the partial staging wave and
                reaps.  Under shallow load a lone in-flight wave with
                nothing staged behind it retires in the same step.

A wave's launches go to the card's stream in order; its results are copied
to the host once, and a `torch.cuda.Event` recorded after them says when
the wave is ready (`Event.query()`).  A wave on a CPU table is ready when
its function returns.  An admitting wave's upsert reads counts on the host
inside the op, so dispatching it waits for the card there.

Miss policy (the §3.5 role the read path plays):

  'readonly'  the wave runs `find` (READER role); misses return the
              engine's default row (zeros or a caller hook).  On tiered
              tables `promote` threads through to `find(promote=...)`:
              promotion re-admits cold hits into the hot tier, while
              `promote=False` keeps the wave a pure reader.
  'admit'     the wave runs `find_or_insert` (INSERTER role): misses are
              admitted with the default row as init, so a re-accessed key
              is a hit from its second wave on.

Served rows are exactly `table.dim` wide under both policies (aux
optimizer columns never leak to clients), float32.

Tables are drawn from a `TableSource` (``repro_torch.serving.publisher``)
once per wave, at dispatch; when the policy changed the table (admission,
promotion) the wave offers it back right away.  The port's tables change
in place, so the offered table is the snapshot's own object.  The wave
function is built once per table signature (type / backend / dims / score
policy) and rebuilt when a publish changes it.

Metrics split queue-wait from service per REQUEST, on top of the per-wave
numbers:

  queue-wait   submit -> dispatch of the first wave carrying the request;
  service      that dispatch -> results unpacked into the request;
  total        submit -> done (== queue-wait + service).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.api import HKVTable, table_signature
from repro_torch.core.tiered import TieredHKVTable
from repro_torch.obs.trace import as_tracer
from repro_torch.serving.publisher import StaticSource, TableSource

MISS_POLICIES = ("readonly", "admit")
ADMISSION_MODES = ("wave", "continuous")
EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


# =============================================================================
# Requests and metrics
# =============================================================================


@dataclasses.dataclass
class EmbeddingRequest:
    """One lookup request: a batch of feature ids awaiting embedding rows."""

    rid: int
    keys: np.ndarray                    # uint64 [n] feature ids
    values: Optional[np.ndarray] = None  # float32 [n, dim]: filled on completion
    found: Optional[np.ndarray] = None   # bool [n]
    done: bool = False
    # SLO accounting (host perf_counter stamps; see module doc)
    t_submit: Optional[float] = None     # stamped by engine.submit()
    t_admit: Optional[float] = None      # dispatch of the first carrying wave
    t_done: Optional[float] = None       # last carrying wave unpacked

    @property
    def queue_wait_s(self) -> float:
        """Time spent queued before the first carrying wave dispatched."""
        if self.t_submit is None or self.t_admit is None:
            return 0.0
        return self.t_admit - self.t_submit

    @property
    def service_s(self) -> float:
        """First dispatch -> results unpacked (device and in-flight overlap)."""
        if self.t_admit is None or self.t_done is None:
            return 0.0
        return self.t_done - self.t_admit

    @property
    def total_latency_s(self) -> float:
        """submit -> done == queue-wait + service."""
        if self.t_submit is None or self.t_done is None:
            return 0.0
        return self.t_done - self.t_submit


class WaveReport(NamedTuple):
    size: int           # live key lanes served (padding excluded)
    hits: int
    latency_s: float    # host wall clock: dispatch -> results ready
    table_version: int  # source version the wave was served from
    hot_hits: int = 0   # lanes served from the HOT tier (tiered readonly
                        # waves; == hits elsewhere)
    demotions: int = 0  # REACTIVE hot->cold demotions this wave's own
                        # structural motion caused (tiered admission or
                        # promotion): the serving-path eviction tax the
                        # maintenance scheduler's rebalancing drives down

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.size, 1)

    @property
    def kv_per_s(self) -> float:
        return self.size / max(self.latency_s, 1e-12)


class EngineMetrics(NamedTuple):
    waves: int
    keys: int
    hits: int
    hit_rate: float
    hot_rate: float     # hot-tier serve fraction (== hit_rate off-tier)
    kv_per_s: float     # total keys / total wave wall clock
    p50_latency_s: float
    p99_latency_s: float
    # reactive serving-path demotions, total and per wave (tiered tables;
    # 0 elsewhere)
    reactive_demotions: int = 0
    demotions_per_wave: float = 0.0
    # per-REQUEST SLO split (completed requests; module doc):
    requests: int = 0
    p50_queue_wait_s: float = 0.0
    p99_queue_wait_s: float = 0.0
    p50_service_s: float = 0.0
    p99_service_s: float = 0.0
    p50_total_s: float = 0.0
    p99_total_s: float = 0.0

    @classmethod
    def zero(cls) -> "EngineMetrics":
        """The well-formed empty snapshot (no waves, no requests)."""
        return cls(waves=0, keys=0, hits=0, hit_rate=0.0, hot_rate=0.0,
                   kv_per_s=0.0, p50_latency_s=0.0, p99_latency_s=0.0)


class _Inflight(NamedTuple):
    """A dispatched, not-yet-retired wave."""

    host: tuple         # (vals, found, hot, dem): the results' host copies
    ready: Optional[torch.cuda.Event]   # recorded after the copies; None on the CPU
    segments: list      # (request, key offset, lane0, take)
    used: int
    lanes: np.ndarray
    version: int
    t_dispatch: float


# =============================================================================
# The engine
# =============================================================================


class OnlineEmbeddingEngine:
    """Wave-batched embedding lookups over an `HKVTable` or a
    `TieredHKVTable`.

        table = TieredHKVTable.create(hot_capacity=8*128,
                                      cold_capacity=64*128, dim=16)
        eng = OnlineEmbeddingEngine(table, wave_size=512,
                                    miss_policy="admit",
                                    admission="continuous")
        eng.submit(EmbeddingRequest(rid=0, keys=ids))
        eng.run_until_drained()
        print(eng.metrics())

    `table=` may instead be a `TableSource` (e.g. `TablePublisher`): every
    wave then serves from the source's latest table.
    `default_row(keys) -> [n, dim]` (keys: the wave's normalized int64 key
    tensor on the table's device) overrides the zero miss fallback and the
    admit policy's init rows.

    `host_budget_s` is the between-wave slack budget that staging and
    maintenance COMPETE for: the host time this step spent packing and
    unpacking is charged against it, and only the remainder is offered to
    the scheduler, which defers its step when its estimated cost exceeds
    it.  `None` (default) leaves the scheduler cadence-only.
    """

    def __init__(self, table: Any, *, wave_size: int,
                 miss_policy: str = "readonly",
                 promote: Optional[bool] = None,
                 default_row: Optional[Callable[[torch.Tensor], Any]] = None,
                 scheduler: Optional[Any] = None,
                 admission: str = "wave",
                 host_budget_s: Optional[float] = None,
                 tracer: Optional[Any] = None):
        if miss_policy not in MISS_POLICIES:
            raise ValueError(f"miss_policy {miss_policy!r}; one of {MISS_POLICIES}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission {admission!r}; one of {ADMISSION_MODES}")
        self.source: TableSource = (
            table if isinstance(table, TableSource) else StaticSource(table))
        self.wave_size = wave_size
        self.miss_policy = miss_policy
        self.promote = promote
        self.admission = admission
        self.host_budget_s = host_budget_s
        self._default_row = default_row
        # span tracing (repro_torch.obs.trace): engine.submit / wave.splice
        # / wave.dispatch / wave.reap / request lifetimes
        self.tracer = as_tracer(tracer)
        # wave-interleaved maintenance (repro_torch.maintenance.scheduler):
        # after each wave the scheduler gets the hand-off gap.  Maintenance
        # time is the scheduler's own metric, never wave latency.
        self.scheduler = scheduler
        self._queue: deque = deque()      # (request, key offset)
        # staging buffer: the NEXT wave, with per-lane occupancy
        self._stage_lanes = np.full(wave_size, EMPTY_KEY, np.uint64)
        self._stage_segments: list = []
        self._stage_used = 0
        self._stage_age = 0               # steps a partial stage has waited
        self._flights: deque = deque()    # dispatched, not yet retired
        self._wave_fn = None              # keyed on the table signature
        self._wave_sig = None
        self._mutates = False             # resolved with the wave fn
        self.completed: list = []
        self.reports: list[WaveReport] = []
        # waves in flight when each wave was dispatched (itself excluded)
        self.depth_at_dispatch: list[int] = []

    # -- admission -------------------------------------------------------------

    def submit(self, req: EmbeddingRequest):
        req.values = None
        req.found = None
        req.done = False
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.tracer.instant("engine.submit", rid=req.rid, keys=len(req.keys))
        self._queue.append((req, 0))
        if self.admission == "continuous":
            # splice into the partially drained staging wave right away;
            # every wave the splice FILLS dispatches immediately
            while True:
                self._fill_staging()
                if self._stage_used < self.wave_size:
                    break
                lanes, segments, used = self._take_staging()
                flight = self._dispatch(lanes, segments, used)
                if flight is not None:
                    self._flights.append(flight)

    @property
    def idle(self) -> bool:
        return (not self._queue and self._stage_used == 0
                and not self._stage_segments and not self._flights)

    def _fill_staging(self):
        """Move queued keys into the staging buffer's free lanes
        (`_stage_used` is the first free lane)."""
        while self._queue and self._stage_used < self.wave_size:
            req, off = self._queue.popleft()
            take = min(len(req.keys) - off, self.wave_size - self._stage_used)
            lane0 = self._stage_used
            self._stage_lanes[lane0:lane0 + take] = req.keys[off:off + take]
            self._stage_segments.append((req, off, lane0, take))
            self._stage_used += take
            if off + take < len(req.keys):   # spans into the next wave
                self._queue.appendleft((req, off + take))
                break

    def _take_staging(self):
        """Claim the staged wave and reset the buffer for the next one."""
        with self.tracer.span("wave.splice"):
            self._fill_staging()
        lanes, segments, used = self._stage_lanes, self._stage_segments, self._stage_used
        self._stage_lanes = np.full(self.wave_size, EMPTY_KEY, np.uint64)
        self._stage_segments = []
        self._stage_used = 0
        self._stage_age = 0
        return lanes, segments, used

    # -- the wave step ---------------------------------------------------------

    def _build_wave_fn(self, table):
        from repro_torch.baselines import DictKVTable  # the baselines sit beside serving
        from repro_torch.distributed import ShardedHKVTable  # the mesh sits beside serving

        if not isinstance(table, (HKVTable, TieredHKVTable, DictKVTable, ShardedHKVTable)):
            raise NotImplementedError(
                f"the engine serves HKVTable, TieredHKVTable, DictKVTable and "
                f"ShardedHKVTable; not {type(table).__name__}")
        policy, promote = self.miss_policy, self.promote
        is_tiered = isinstance(table, TieredHKVTable)
        is_sharded = isinstance(table, ShardedHKVTable)
        default_row = self._default_row
        # Does this policy change the table?  Admission always does; a
        # readonly wave only through tiered or sharded promotion
        self._mutates = policy == "admit" or (bool(promote) and (is_tiered or is_sharded))

        def init_rows(table, lanes):
            if default_row is None:
                return torch.zeros((lanes.shape[0], table.dim), dtype=torch.float32,
                                   device=table.device)
            return torch.as_tensor(default_row(table.keys(lanes)), dtype=torch.float32,
                                   device=table.device)

        def wave(table, lanes):
            # lanes stay numpy uint64 until the handle normalizes them: a
            # key at or above 2**63 would be padding as a signed id
            init = init_rows(table, lanes)
            if policy == "admit":
                # a sharded table's owners recompute the init rows from the
                # key (caller init is not routed), so its rows are the
                # stored ones
                r = table.find_or_insert(lanes) if is_sharded else table.find_or_insert(lanes, init)
                # clients get exactly dim columns; reactive demotions are
                # what this wave's admissions pushed hot->cold
                return (r.table, r.values[:, :table.dim], r.found, r.found,
                        getattr(r, "demoted", 0))
            # readonly: READER role, default-row fallback on a miss
            if is_tiered or is_sharded:
                r = table.find(lanes, promote=bool(promote))
                succ = r.table if promote else table
            else:
                r = table.find(lanes)
                succ = table
            vals = torch.where(r.found[:, None], r.values[:, :table.dim].to(init.dtype), init)
            dem = getattr(r, "demoted", 0) if promote else 0
            return succ, vals, r.found, getattr(r, "hot_hit", r.found), dem

        return wave

    def _wave_fn_for(self, table):
        """The wave function for this table, rebuilt when the published
        table's static signature changed (type / backend / dims / score
        policy)."""
        sig = table_signature(table)
        if self._wave_fn is None or sig != self._wave_sig:
            self._wave_fn = self._build_wave_fn(table)
            self._wave_sig = sig
        return self._wave_fn

    def _dispatch(self, lanes, segments, used) -> Optional[_Inflight]:
        """Launch one wave without waiting for it.  Zero-live waves (only
        zero-length requests) complete immediately without a launch."""
        version, table = self.source.snapshot()  # ONE read: wave-consistent
        if used == 0:
            now = time.perf_counter()
            for req, _off, _lane0, _take in segments:
                req.values = np.zeros((0, table.dim), np.float32)
                req.found = np.zeros(0, bool)
                req.t_admit = req.t_admit or now
                req.t_done = now
                req.done = True
                self.completed.append(req)
                self.tracer.complete_abs("request", req.t_submit, now,
                                         rid=req.rid, keys=len(req.keys))
            return None
        fn = self._wave_fn_for(table)
        depth = len(self._flights)
        t0 = time.perf_counter()
        with self.tracer.span("wave.dispatch", used=used, version=version):
            succ, vals, found, hot, dem = fn(table, lanes)
            host, ready = _to_host(vals.float(), found, hot, dem)
            if self._mutates:     # admission / promotion changed the table
                self.source.offer(version, succ)
        self.depth_at_dispatch.append(depth)
        for req, _off, _lane0, _take in segments:
            if req.t_admit is None:
                req.t_admit = t0
        return _Inflight(host=host, ready=ready, segments=segments, used=used, lanes=lanes,
                         version=version, t_dispatch=t0)

    def _retire(self, flight: _Inflight) -> WaveReport:
        """Wait for a dispatched wave, unpack results into its requests."""
        with self.tracer.span("wave.reap", used=flight.used, version=flight.version):
            if flight.ready is not None:
                flight.ready.synchronize()
            dt = time.perf_counter() - flight.t_dispatch
            vals, found, hot, dem = (x.numpy() for x in flight.host)
            now = time.perf_counter()
            for req, off, lane0, take in flight.segments:
                if req.values is None:
                    req.values = np.zeros((len(req.keys), vals.shape[1]), vals.dtype)
                    req.found = np.zeros(len(req.keys), bool)
                req.values[off:off + take] = vals[lane0:lane0 + take]
                req.found[off:off + take] = found[lane0:lane0 + take]
                if off + take == len(req.keys):
                    req.done = True
                    req.t_done = now
                    self.completed.append(req)
                    # the request's full submit->done lifetime, from the
                    # engine's own SLO stamps (raw perf_counter epoch)
                    self.tracer.complete_abs("request", req.t_submit, now,
                                             rid=req.rid, keys=len(req.keys))
        used = flight.used
        live = flight.lanes[:used] != EMPTY_KEY
        report = WaveReport(size=int(live.sum()),
                            hits=int(found[:used][live].sum()),
                            latency_s=dt, table_version=flight.version,
                            hot_hits=int(hot[:used][live].sum()),
                            demotions=int(dem))
        self.reports.append(report)
        return report

    def _maintenance_slot(self, staging_s: float):
        """The between-wave hand-off gap: staging already spent
        `staging_s` of the host budget; maintenance competes for the rest."""
        if self.scheduler is None:
            return
        slack = None
        if self.host_budget_s is not None:
            slack = max(0.0, self.host_budget_s - staging_s)
        self.scheduler.on_wave(self.source, slack_s=slack)

    def step(self) -> Optional[WaveReport]:
        """Serve one wave; returns its report.

        'wave' mode: pack -> dispatch -> wait -> unpack, serially (None
        when the queue is idle).  'continuous' mode: flush the partial
        staging wave (waves the splice filled already dispatched at
        submit), reap finished flights without blocking, and retire the
        oldest wave, waiting for it, when draining or when a lone
        shallow-load wave is in flight.  The report may cover an earlier
        wave than the one dispatched this step; None when nothing retired
        (check `.idle`, or use `run_until_drained`)."""
        if self.idle:
            return None
        t_host0 = time.perf_counter()
        if self.admission == "wave":
            lanes, segments, used = self._take_staging()
            flight = self._dispatch(lanes, segments, used)
            pack_s = time.perf_counter() - t_host0
            report = self._retire(flight) if flight is not None else None
            self._maintenance_slot(pack_s)
            return report
        # continuous: full waves already dispatched at submit.  The PARTIAL
        # staging wave flushes when the pipeline is SHALLOW (<= 1 in
        # flight) or once it has waited out two whole steps without
        # filling (the straggler cap).  While the pipeline is deep, staged
        # keys keep accepting splices so backlog traffic rides densely
        # packed waves
        flight = None
        if ((self._queue or self._stage_used or self._stage_segments)
                and (len(self._flights) <= 1 or self._stage_age >= 2)):
            lanes, segments, used = self._take_staging()
            flight = self._dispatch(lanes, segments, used)
            if flight is not None:
                self._flights.append(flight)
        elif self._stage_used or self._stage_segments:
            self._stage_age += 1
        pack_s = time.perf_counter() - t_host0
        # non-blocking reap of finished waves, in chain order
        report = None
        reaped = False
        while self._flights and _flight_ready(self._flights[0]):
            report = self._retire(self._flights.popleft())
            reaped = True
        if self._flights and flight is None and not reaped:
            # nothing dispatched, nothing ready: wait for the oldest so
            # that every step makes progress (the drain path)
            report = self._retire(self._flights.popleft())
        elif (flight is not None and len(self._flights) == 1
                and not self._queue and self._stage_used == 0
                and not self._stage_segments):
            # pipeline collapse: a lone shallow-load wave with nothing
            # staged behind it retires in the step it dispatched
            report = self._retire(self._flights.popleft())
        unpack_s = time.perf_counter() - t_host0 - pack_s
        self._maintenance_slot(pack_s + unpack_s)
        return report

    def poll(self) -> Optional[WaveReport]:
        """Non-blocking reap: retire every in-flight wave whose results are
        ready, without dispatching anything.  Returns the last retired
        wave's report (None if nothing was ready)."""
        report = None
        while self._flights and _flight_ready(self._flights[0]):
            report = self._retire(self._flights.popleft())
        return report

    def run_until_drained(self, max_waves: int = 100_000) -> list:
        for _ in range(max_waves):
            self.step()
            if self.idle:
                break
        return self.completed

    # -- metrics ---------------------------------------------------------------

    def metrics(self, *, skip_warmup: bool = True) -> EngineMetrics:
        """Aggregate wave reports and per-request SLO latencies.  Counts
        (waves/keys/hits and the rates) cover EVERY wave; the timing
        aggregates (kv_per_s, wave p50/p99) skip the first wave by default
        (it pays the first call's set-up; `skip_warmup=False` keeps it).
        The per-request percentiles cover every COMPLETED request."""
        if not self.reports and not self.completed:
            return EngineMetrics.zero()
        keys = sum(r.size for r in self.reports)
        hits = sum(r.hits for r in self.reports)
        demos = sum(r.demotions for r in self.reports)
        timed = (self.reports[1:] if skip_warmup and len(self.reports) > 1
                 else self.reports)
        lat = np.array([r.latency_s for r in timed]) if timed else np.zeros(1)
        tkeys = sum(r.size for r in timed)
        reqs = [r for r in self.completed if r.t_done is not None]
        qw = np.array([r.queue_wait_s for r in reqs]) if reqs else np.zeros(1)
        sv = np.array([r.service_s for r in reqs]) if reqs else np.zeros(1)
        tot = np.array([r.total_latency_s for r in reqs]) if reqs else np.zeros(1)
        return EngineMetrics(
            waves=len(self.reports), keys=keys, hits=hits,
            hit_rate=hits / max(keys, 1),
            hot_rate=sum(r.hot_hits for r in self.reports) / max(keys, 1),
            kv_per_s=tkeys / max(float(lat.sum()), 1e-12),
            p50_latency_s=float(np.percentile(lat, 50)),
            p99_latency_s=float(np.percentile(lat, 99)),
            reactive_demotions=demos,
            demotions_per_wave=demos / max(len(self.reports), 1),
            requests=len(reqs),
            p50_queue_wait_s=float(np.percentile(qw, 50)),
            p99_queue_wait_s=float(np.percentile(qw, 99)),
            p50_service_s=float(np.percentile(sv, 50)),
            p99_service_s=float(np.percentile(sv, 99)),
            p50_total_s=float(np.percentile(tot, 50)),
            p99_total_s=float(np.percentile(tot, 99)),
        )


def _to_host(*outs) -> tuple[tuple, Optional[torch.cuda.Event]]:
    """Host copies of a wave's results, and the event that marks them
    done: on the card, copies into pinned memory queued after the wave's
    launches; on the CPU the results themselves and no event."""
    dev = outs[0].device
    outs = tuple(torch.as_tensor(x, device=dev) for x in outs)
    if dev.type != "cuda":
        return outs, None
    host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
                 for x in outs)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _flight_ready(flight: _Inflight) -> bool:
    """True when a dispatched wave's results are on the host (its retire
    would not wait)."""
    return flight.ready is None or flight.ready.query()
