"""Metrics registry: one snapshot over the serving stack's measurements
(the port's copy of ``repro/obs/metrics.py``, its gauge names and export
formats unchanged).

`MetricsRegistry` folds the subsystem summaries (`EngineMetrics` host
timers, `MaintenanceTotals`, `TableStats` / `tier_stats()`) into a single
flat gauge namespace (with the op telemetry sink's per-op counters and
rates, `observe_telemetry`), then exports it two ways:

  * `prometheus()`: text exposition format (`# HELP`/`# TYPE`/value lines)
    for scraping or a one-shot `--metrics-out` dump;
  * `to_json()` / `snapshot()`: a flat dict (schema ``hkv-metrics/v1``).

Gauge names follow the Prometheus convention `hkv_<subsystem>_<metric>`:

  hkv_engine_*        waves, keys, hit_rate, kv_per_s, SLO percentiles
  hkv_maintenance_*   runs, expired, demoted, dropped, deferred, time_s
  hkv_table_*         size, capacity, load_factor (hkv_hot_* / hkv_cold_*
                      for the tier hierarchy's per-tier stats)
  hkv_op_<op>_*       TelemetrySink counters, derived rates, call counts

Everything is pull: observers hand their summary objects in, the registry
flattens to floats at observe time (a tensor on the card is read once),
and exports read the gauge dict.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _scalar(v) -> float:
    """Float of a host value or a one-element tensor on any device."""
    if isinstance(v, torch.Tensor):
        return float(v.item())
    return float(np.asarray(v))


class MetricsRegistry:
    """A flat gauge registry with subsystem-aware observers."""

    def __init__(self, namespace: str = "hkv"):
        self.namespace = namespace
        self._gauges: dict[str, float] = {}
        self._help: dict[str, str] = {}

    # -- primitive surface ---------------------------------------------------

    def set(self, name: str, value, help: str = "") -> None:
        self._gauges[name] = _scalar(value)
        if help:
            self._help[name] = help

    def inc(self, name: str, value=1.0) -> None:
        self._gauges[name] = self._gauges.get(name, 0.0) + _scalar(value)

    def get(self, name: str) -> float:
        return self._gauges[name]

    # -- subsystem observers -------------------------------------------------

    def observe_engine(self, metrics) -> None:
        """Fold an `EngineMetrics` snapshot (NamedTuple) into gauges."""
        p = f"{self.namespace}_engine_"
        for field, value in metrics._asdict().items():
            self.set(p + field, value)
        self._help[p + "kv_per_s"] = "serving throughput, keys per second"
        self._help[p + "hit_rate"] = "fraction of served keys found resident"

    def observe_maintenance(self, totals) -> None:
        """Fold `MaintenanceTotals` (NamedTuple) into gauges."""
        p = f"{self.namespace}_maintenance_"
        for field, value in totals._asdict().items():
            self.set(p + field, value)
        self._help[p + "deferred"] = (
            "maintenance steps skipped: between-wave slack already spent")

    def observe_table(self, stats, *, tier: str = "table") -> None:
        """Fold a `TableStats` into gauges; `tier` prefixes the name
        ("table" for a flat table, "hot"/"cold" per tier)."""
        p = f"{self.namespace}_{tier}_"
        self.set(p + "size", stats.size, "live entries")
        self.set(p + "capacity", stats.capacity)
        self.set(p + "load_factor", stats.load_factor,
                 "live entries / slots (lambda)")
        hist = stats.occupancy_hist
        hist = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
        full = int(hist[-1]) if hist.size else 0
        self.set(p + "full_buckets", full,
                 "buckets at slot capacity (reactive-eviction pressure)")

    def observe_telemetry(self, sink) -> None:
        """Fold a `TelemetrySink`'s accumulated per-op `OpTelemetry` into
        gauges, with the derived rates the paper's claims anchor to."""
        for op, tel in sink.by_op.items():
            self.observe_op(op, tel, calls=sink.calls.get(op, 0))

    def observe_op(self, op: str, tel, *, calls: int = 0) -> None:
        p = f"{self.namespace}_op_{op}_"
        for counter, value in tel.to_dict().items():
            self.set(p + counter, value)
        for rate, value in tel.rates().items():
            self.set(p + rate, value)
        if calls:
            self.set(p + "calls", calls)
        self._help[p + "probes_per_query"] = (
            "bucket rows fetched per valid key (flat across load factor)")
        self._help[p + "digest_pass_rate"] = (
            "probed slots passing the 8-bit digest prefilter")

    # -- exports -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The flat {gauge: float} view (sorted, JSON-ready)."""
        return dict(sorted(self._gauges.items()))

    def prometheus(self) -> str:
        """Prometheus text exposition format (all gauges)."""
        lines = []
        for name, value in sorted(self._gauges.items()):
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} gauge")
            if value == int(value) and abs(value) < 1e15:
                lines.append(f"{name} {int(value)}")
            else:
                lines.append(f"{name} {value:.6g}")
        return "\n".join(lines) + "\n"

    def to_json(self, **extra) -> str:
        """JSON dump of the snapshot (+ caller-supplied context fields)."""
        doc = {"schema": "hkv-metrics/v1", "gauges": self.snapshot()}
        doc.update(extra)
        return json.dumps(doc, indent=2, sort_keys=True)

    def save(self, path, *, format: str = "prometheus") -> None:
        text = self.prometheus() if format == "prometheus" else self.to_json()
        with open(path, "w") as f:
            f.write(text)

    def __len__(self) -> int:
        return len(self._gauges)
