"""Observability: the op telemetry channel (`OpTelemetry` counters that
every keyed op records into a `TelemetrySink` given as ``telemetry=``),
the host-side span tracer (Chrome trace-event JSON) with the program's own
spans and counters, and the metrics registry (Prometheus text and a flat
JSON snapshot), which the serving engine, the maintenance scheduler, the
publisher and the telemetry sink report to.

The ops open program spans on every call, so ``obs.trace`` loads with
them; the telemetry module loads at the first use of one of its names
(``telemetry=None`` imports no observer)."""

import importlib

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (NOOP_SPAN, NOOP_TRACER, NoopTracer, Span, Tracer, as_tracer,
                                   install, op_span, recorded, span)

_TELEMETRY = ("OpTelemetry", "TelemetrySink", "observe_erase", "observe_evict_if",
              "observe_find", "observe_sweep", "observe_update", "observe_upsert",
              "probe_counters", "psum_telemetry", "tier_motion")

__all__ = ["MetricsRegistry", "NOOP_SPAN", "NOOP_TRACER", "NoopTracer", "Span", "Tracer",
           "as_tracer", "install", "op_span", "recorded", "span", *_TELEMETRY]


def __getattr__(name):
    if name in _TELEMETRY:
        return getattr(importlib.import_module("repro_torch.obs.telemetry"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
