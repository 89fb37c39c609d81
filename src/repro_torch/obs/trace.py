"""Span tracing: a low-overhead host-side tracer with Chrome export (the
port's copy of ``repro/obs/trace.py``, host only, its JSON format unchanged).

Records nestable spans (``with tracer.span("wave.dispatch"): ...``) and
instant events (``tracer.instant("maintenance.deferred")``) against a
single `perf_counter` epoch, then exports the Chrome trace-event JSON
format (the ``{"traceEvents": [...]}`` object form) loadable in Perfetto
or ``chrome://tracing``.

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
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Optional


class Tracer:
    """Collects trace events in memory; thread-safe (the serving engine
    dispatches and reaps from the caller thread but maintenance may run
    from a helper).  Timestamps are microseconds since the tracer's
    creation — one shared epoch so spans from all components align."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.events: list[dict] = []

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer epoch (pair with `complete`)."""
        return time.perf_counter() - self._t0

    def _us(self, t_s: float) -> float:
        return round(t_s * 1e6, 3)

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
            "ts": self._us(t_start),
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
            "ts": self._us(self.now()),
            "pid": 0,
            "tid": 0,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event object form (Perfetto-loadable)."""
        with self._lock:
            return {
                "traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"tracer": "hkv-obs"},
            }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=None, separators=(",", ":"))
            f.write("\n")

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)


class NoopTracer:
    """Absorbs the full `Tracer` surface at near-zero cost — the default
    when no tracer is wired, so instrumented code never branches."""

    events: tuple = ()

    def now(self) -> float:
        return 0.0

    @contextmanager
    def span(self, name: str, **args):
        yield self

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
