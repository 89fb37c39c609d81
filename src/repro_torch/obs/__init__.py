"""Observability: the host-side span tracer (Chrome trace-event JSON) and
the metrics registry (Prometheus text and a flat JSON snapshot), which the
serving engine, the maintenance scheduler and the publisher report to.
The op telemetry channel of the reference's ``repro.obs`` is not ported
yet."""

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP_TRACER, NoopTracer, Tracer, as_tracer

__all__ = ["MetricsRegistry", "Tracer", "NoopTracer", "NOOP_TRACER", "as_tracer"]
