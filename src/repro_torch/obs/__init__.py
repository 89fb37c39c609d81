"""Observability: the op telemetry channel (`OpTelemetry` counters that
every keyed op records into a `TelemetrySink` given as ``telemetry=``),
the host-side span tracer (Chrome trace-event JSON) and the metrics
registry (Prometheus text and a flat JSON snapshot), which the serving
engine, the maintenance scheduler, the publisher and the telemetry sink
report to."""

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.telemetry import (OpTelemetry, TelemetrySink, host_telemetry,
                                       observe_erase, observe_evict_if, observe_find,
                                       observe_sweep, observe_update, observe_upsert,
                                       probe_counters, psum_telemetry, tier_motion)
from repro_torch.obs.trace import NOOP_TRACER, NoopTracer, Tracer, as_tracer

__all__ = ["MetricsRegistry", "NOOP_TRACER", "NoopTracer", "OpTelemetry", "TelemetrySink",
           "Tracer", "as_tracer", "host_telemetry", "observe_erase", "observe_evict_if",
           "observe_find", "observe_sweep", "observe_update", "observe_upsert",
           "probe_counters", "psum_telemetry", "tier_motion"]
