"""Span tracing: a low-overhead host-side tracer with Chrome export (the
port's copy of ``repro/obs/trace.py``, host only, its JSON format
unchanged), and the program's own spans and counters on the hot path.

Records nestable spans (``with tracer.span("wave.dispatch"): ...``) and
instant events (``tracer.instant("maintenance.deferred")``), then exports
the Chrome trace-event JSON format (the ``{"traceEvents": [...]}`` object
form) loadable in Perfetto or ``chrome://tracing``.  Timestamps are on the
clock `torch.profiler` stamps its events in (``time.time_ns()``), in
microseconds, so a tracer's file and a profiler's trace share one timeline.

Span taxonomy wired by the serving stack:

  engine.submit      request admission into the splice queue
  wave.splice        staging-buffer fill from queued requests
  wave.dispatch      launch of one wave (snapshot -> fn -> offer)
  wave.reap          flight retirement (wait on the wave's event + deliver)
  request            one request's full queue-wait + service lifetime
                     (emitted at completion from the engine's stamps)
  maintenance.run    one scheduler step (fn + one synchronisation)
  maintenance.deferred   instant: on_wave skipped, cost EWMA over slack
  publisher.publish  instant: staged table promoted to serving
  publisher.offer    instant: new table version offered to the publisher
  delta.export / delta.ingest   checkpoint delta streaming

Every consumer stores ``self.tracer = as_tracer(tracer)`` so call sites
are unconditional; the default `NOOP_TRACER` makes each a no-op attribute
call (no branches at the call sites, no events retained).

Program spans (`span`) sit inside the table ops, the upsert closure's
stages, the hashing, the embedding's steps and every kernel launch:

  embedding.lookup_train / .apply_grads / .default_rows / .sum_grads
  op.find / op.insert_or_assign / op.find_or_insert / op.ingest /
  op.update_rows     one op call, the root of its stages; its counters
  op.readback        find_or_insert's rows at the post-op locations
  hash               ``core.find.probe_keys``: hash pair, buckets, digest
  closure.<stage>    ``core.merge.upsert``: dedupe, locate, hits, target,
                     order, rank, miss_count (the host read of the miss
                     count), victims, write, status, post
  kernel.<name>      one custom-kernel launch (``kernels._build.launch``)

An op call's span is opened by `op_span`.  A program span is live only while a `Tracer` is installed (`install`) or
a `torch.profiler` runs; it then records its name, start and end (ns on
``time.time_ns()``), its id, its parent's id and the id of the op call it
belongs to.  Under `install` the records go into the tracer; under a
profiler alone into a bounded module-level recorder (`recorded`).  Off,
`span` returns the shared `NOOP_SPAN` after two flag checks.  A program
span is no profiler range: it adds no event to the profiler's timelines.

An op span carries counters, taken from the op's own outputs with at most
three small launches and no host read (read with `Span.counters` after
the window): ``lanes`` (valid key lanes), ``hits`` (find: found;
find_or_insert and ingest: found before the op; update_rows: the rows
trained; insert_or_assign: updated in place), the inserters' status
histogram ``updated``, ``inserted``, ``evicted``, ``rejected``, and
``launches`` (custom-kernel launches within the call, a host int).
``op.readback`` counts ``plane_rows``, the rows it read from the value
plane (one sum); ``closure.post`` counts ``stream_rows``, the eviction
stream's rows (a host int).
"""

from __future__ import annotations

import collections
import itertools
import json
import sys
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The records a running profiler leaves with no tracer installed.
RECORDER_SPANS = 1 << 18


class Tracer:
    """Collects trace events in memory; thread-safe (the serving engine
    dispatches and reaps from the caller thread but maintenance may run
    from a helper).  `now` counts seconds since the tracer's creation; the
    export puts every stamp on ``time.time_ns()``'s clock, through the
    offset between the two clocks read once at creation."""

    def __init__(self):
        before = time.perf_counter()
        self._wall_ns = time.time_ns()
        self._t0 = (before + time.perf_counter()) / 2
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self.spans: list[Span] = []          # the program's spans while installed

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer epoch (pair with `complete`)."""
        return time.perf_counter() - self._t0

    def _us(self, t_s: float) -> float:
        return round(t_s * 1e6, 3)

    def _ts(self, t_s: float) -> float:
        """An epoch-relative stamp in µs on ``time.time_ns()``'s clock."""
        return round(self._wall_ns / 1e3 + t_s * 1e6, 3)

    # -- recording -----------------------------------------------------------

    @contextmanager
    def span(self, name: str, **args):
        """Record a complete span (ph="X") around the with-body."""
        t_start = self.now()
        try:
            yield self
        finally:
            self.complete(name, t_start, self.now(), **args)

    def complete(self, name: str, t_start: float, t_end: float, **args):
        """Record a span from explicit epoch-relative stamps (seconds) —
        for lifetimes that straddle call boundaries, e.g. a request's
        submit→done window stamped by the engine."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._ts(t_start),
            "dur": self._us(max(t_end - t_start, 0.0)),
            "pid": 0,
            "tid": 0,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def complete_abs(self, name: str, t_start: float, t_end: float, **args):
        """`complete` from raw `time.perf_counter()` stamps — for code
        that stamped lifetimes before a tracer was in the picture (the
        engine's per-request t_submit/t_done)."""
        self.complete(name, t_start - self._t0, t_end - self._t0, **args)

    def instant(self, name: str, **args):
        """Record an instant event (ph="i", thread-scoped)."""
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._ts(self.now()),
            "pid": 0,
            "tid": 0,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def _add_span(self, sp: "Span") -> None:
        with self._lock:
            self.spans.append(sp)

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event object form (Perfetto-loadable); the
        program's spans carry their ids and counters as args (the
        counters are read from the device here)."""
        with self._lock:
            events, spans = list(self.events), list(self.spans)
        return {
            "traceEvents": events + [sp.chrome_event() for sp in spans],
            "displayTimeUnit": "ms",
            "otherData": {"tracer": "hkv-obs"},
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=None, separators=(",", ":"))
            f.write("\n")

    def __len__(self) -> int:
        with self._lock:
            return len(self.events) + len(self.spans)


class _NoopSpan:
    """The span of a call with tracing off: no stamp, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:  # `if sp:` → "is this span live?"
        return False

    def count(self, **counters) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Absorbs the full `Tracer` surface at near-zero cost — the default
    when no tracer is wired, so instrumented code never branches."""

    events: tuple = ()

    def now(self) -> float:
        return 0.0

    def span(self, name: str, **args):
        return NOOP_SPAN

    def complete(self, name: str, t_start: float, t_end: float, **args):
        pass

    def complete_abs(self, name: str, t_start: float, t_end: float, **args):
        pass

    def instant(self, name: str, **args):
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": []}

    def save(self, path) -> None:
        raise RuntimeError("NoopTracer records nothing; wire a Tracer first")

    def __len__(self) -> int:
        return 0

    def __bool__(self) -> bool:  # `if self.tracer:` → "is tracing live?"
        return False


NOOP_TRACER = NoopTracer()


def as_tracer(tracer: Optional[Tracer]):
    """Normalize an optional tracer argument: None → the shared noop."""
    return NOOP_TRACER if tracer is None else tracer


# =============================================================================
# The program's spans
# =============================================================================

_installed: Optional[Tracer] = None
_recorder: collections.deque = collections.deque(maxlen=RECORDER_SPANS)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _launches() -> int:
    """Custom-kernel launches so far (0 before the kernels' module loads)."""
    build = sys.modules.get("repro_torch.kernels._build")
    return sum(build.launch_counts.values()) if build is not None else 0


class Span:
    """One live program span: name, start and end in ns on
    ``time.time_ns()``, its id, its parent's id and its op call's id (None
    outside any op), and, on an op span, its counters."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "op", "_counts", "_launches0",
                 "_tracer", "_is_op")

    def __init__(self, name: str, tracer: Optional[Tracer], is_op: bool = False):
        self.name, self._tracer, self._is_op = name, tracer, is_op
        self.start_ns = self.end_ns = 0
        self._counts: dict = {}

    def __enter__(self) -> "Span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.op = self.id if self._is_op else (up.op if up is not None else None)
        self._launches0 = _launches() if self._is_op else None
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _stack().pop()
        if self._launches0 is not None:
            self._counts["launches"] = _launches() - self._launches0
        if self._tracer is not None:
            self._tracer._add_span(self)
        else:
            _recorder.append(self)
        return False

    def count(self, **counters) -> None:
        """Attach counters, read in `counters`: each a host int, an integer
        tensor on the device whose elements sum to the counter, or a
        (tensor, index) pair naming one of its elements (no launch here)."""
        self._counts.update(counters)

    def counters(self) -> dict:
        """{counter: int}, read from the device (after the window), each
        tensor once."""
        read: dict = {}

        def host(t: torch.Tensor) -> list:
            if id(t) not in read:
                read[id(t)] = t.reshape(-1).tolist()
            return read[id(t)]

        return {k: host(v[0])[v[1]] if isinstance(v, tuple)
                else sum(host(v)) if isinstance(v, torch.Tensor) else int(v)
                for k, v in self._counts.items()}

    def chrome_event(self) -> dict:
        args = {"id": self.id, "parent": self.parent, "op": self.op, **self.counters()}
        return {"name": self.name, "ph": "X", "ts": round(self.start_ns / 1e3, 3),
                "dur": round((self.end_ns - self.start_ns) / 1e3, 3), "pid": 0, "tid": 0,
                "args": args}


def span(name: str):
    """The program's span `name`: live under an installed tracer or a
    running profiler, else the shared no-op."""
    if _installed is None and not _autograd_profiler._is_profiler_enabled:
        return NOOP_SPAN
    return Span(name, _installed)


def op_span(name: str):
    """`span` for one op call: the spans inside it take its id as their op
    call's, and it counts the custom-kernel launches within it."""
    if _installed is None and not _autograd_profiler._is_profiler_enabled:
        return NOOP_SPAN
    return Span(name, _installed, is_op=True)


@contextmanager
def install(tracer: Optional[Tracer]):
    """Send the program's spans to `tracer` within the with-body (None or
    the noop tracer installs nothing)."""
    global _installed
    prev = _installed
    _installed = None if tracer is None or isinstance(tracer, NoopTracer) else tracer
    try:
        yield tracer
    finally:
        _installed = prev


def recorded() -> list:
    """The program's spans recorded while a profiler ran with no tracer
    installed (the newest `RECORDER_SPANS`), in the order they ended."""
    return list(_recorder)
