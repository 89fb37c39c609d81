"""The port's host tracer and metrics registry (``repro_torch.obs``) against
the JAX package's (``repro.obs``), and the port's serving launcher.

The same calls go to both packages' tracers and registries.  Held exactly:
the Chrome trace-event structure (every key of every event and of the
document, with only the clock readings `ts` and `dur` left out), the
Prometheus text and the JSON snapshot of registries fed the same values
(including `TableStats` of equal tables, one from each package), and the
launcher's `--trace-out` / `--metrics-out` files, whose span names and
gauge names must be the reference's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.maintenance.scheduler import MaintenanceTotals as JTotals  # noqa: E402
from repro.serving.embedding_engine import EngineMetrics as JMetrics  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.maintenance import MaintenanceTotals as PTotals  # noqa: E402
from repro_torch.serving import EngineMetrics as PMetrics  # noqa: E402

CLOCK = ("ts", "dur")


def _structure(doc):
    return {**{k: v for k, v in doc.items() if k != "traceEvents"},
            "traceEvents": [{k: v for k, v in ev.items() if k not in CLOCK}
                            for ev in doc["traceEvents"]]}


def _record(obs):
    tr = obs.Tracer()
    with tr.span("outer", tag="a"):
        tr.instant("mark", n=1)
        with tr.span("inner"):
            pass
    tr.complete_abs("abs", tr._t0, tr._t0 + 0.5, rid=7)
    tr.complete("plain", 0.0, 0.25)
    return tr


def test_tracer_events_match_the_reference(tmp_path):
    tj, tp = _record(jobs), _record(pobs)
    assert len(tp) == len(tj) == 5
    dj, dp = tj.to_chrome(), tp.to_chrome()
    assert _structure(dp) == _structure(dj)
    by_name = {e["name"]: e for e in dp["traceEvents"]}
    assert by_name["mark"]["ph"] == "i" and by_name["mark"]["s"] == "t"
    assert abs(by_name["abs"]["dur"] - 5e5) < 1e3 and by_name["plain"]["dur"] == 2.5e5
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    tp.save(tmp_path / "p.json")
    tj.save(tmp_path / "j.json")
    raw_p, raw_j = (tmp_path / "p.json").read_text(), (tmp_path / "j.json").read_text()
    assert raw_p.endswith("\n") and raw_j.endswith("\n")
    assert _structure(json.loads(raw_p)) == _structure(json.loads(raw_j))


def test_noop_tracer_matches_the_reference():
    for obs in (jobs, pobs):
        noop = obs.NOOP_TRACER
        assert obs.as_tracer(None) is noop and not noop and len(noop) == 0
        t = obs.Tracer()
        assert obs.as_tracer(t) is t
        with noop.span("x"):
            noop.instant("y")
        noop.complete("z", 0.0, 1.0)
        noop.complete_abs("z", 0.0, 1.0)
        assert noop.to_chrome() == {"traceEvents": []} and noop.now() == 0.0
        with pytest.raises(RuntimeError):
            noop.save("unused.json")


def _fill(obs, metrics, totals, stats_pair):
    reg = obs.MetricsRegistry()
    reg.set("hkv_demo_total", 3, help="a demo counter")
    reg.set("hkv_demo_rate", 0.25)
    reg.inc("hkv_demo_total", 2)
    reg.inc("hkv_demo_fresh")
    reg.observe_engine(metrics)
    reg.observe_maintenance(totals)
    reg.observe_table(stats_pair[0], tier="hot")
    reg.observe_table(stats_pair[1], tier="cold")
    return reg


def test_metrics_registry_matches_the_reference():
    keys = np.arange(1, 200, dtype=np.uint64)
    vals = np.tile(keys.astype(np.float32)[:, None], (1, 4))
    tj = jcore.TieredHKVTable.create(hot_capacity=128, cold_capacity=2 * 128, dim=4)
    tj = tj.insert_or_assign(keys, jnp.asarray(vals)).table
    tp = repro_torch.TieredHKVTable.create(hot_capacity=128, cold_capacity=2 * 128, dim=4,
                                           device="cpu")
    tp.insert_or_assign(keys, torch.from_numpy(vals))
    numbers = dict(waves=12, keys=3072, hits=1763, hit_rate=1763 / 3072, hot_rate=0.5,
                   kv_per_s=27123.456789, p50_latency_s=0.0065, p99_latency_s=0.0298,
                   reactive_demotions=33, demotions_per_wave=2.75, requests=12,
                   p50_queue_wait_s=1e-4, p99_queue_wait_s=2e-4, p50_service_s=0.007,
                   p99_service_s=0.0633, p50_total_s=0.0072, p99_total_s=0.0634)
    tot = dict(runs=12, expired=0, demoted=262, dropped=0, skipped_offers=1, time_s=0.054,
               deferred=2)
    rj = _fill(jobs, JMetrics(**numbers), JTotals(**tot), tj.tier_stats())
    rp = _fill(pobs, PMetrics(**numbers), PTotals(**tot), tp.tier_stats())
    assert rp.prometheus() == rj.prometheus()
    assert rp.to_json(run="t") == rj.to_json(run="t")
    assert rp.snapshot() == rj.snapshot() and len(rp) == len(rj)
    text = rp.prometheus()
    assert "# HELP hkv_demo_total a demo counter" in text and "\nhkv_demo_total 5\n" in text
    assert rp.get("hkv_hot_load_factor") == 1.0 and rp.get("hkv_hot_full_buckets") == 1.0
    zj = _fill(jobs, JMetrics.zero(), JTotals(0, 0, 0, 0, 0, 0.0), tj.tier_stats())
    zp = _fill(pobs, PMetrics.zero(), PTotals(0, 0, 0, 0, 0, 0.0), tp.tier_stats())
    assert zp.prometheus() == zj.prometheus()
    assert len(PMetrics.zero()) == len(PMetrics._fields) == len(JMetrics._fields)


def _reference_gauges(maintain: bool) -> set:
    """The gauge names the reference's launcher writes."""
    t = jcore.TieredHKVTable.create(hot_capacity=128, cold_capacity=2 * 128, dim=4)
    reg = jobs.MetricsRegistry()
    reg.observe_engine(JMetrics.zero())
    if maintain:
        reg.observe_maintenance(JTotals(0, 0, 0, 0, 0, 0.0))
    hot, cold = t.tier_stats()
    reg.observe_table(hot, tier="hot")
    reg.observe_table(cold, tier="cold")
    return set(reg.snapshot())


def test_serve_launcher_writes_the_reference_formats(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    assert serve.main(["--device", "cpu", "--smoke", "--waves", "4", "--wave-size", "64",
                       "--maintain", "--trace-out", str(trace),
                       "--metrics-out", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "deferred=" in out and "published=" in out and "[serve] table: hot" in out
    doc = json.loads(trace.read_text())
    assert doc["displayTimeUnit"] == "ms" and doc["otherData"] == {"tracer": "hkv-obs"}
    evs = doc["traceEvents"]
    assert evs and all("ph" in e and "ts" in e and "name" in e for e in evs)
    assert all("dur" in e for e in evs if e["ph"] == "X")
    names = {e["name"] for e in evs}
    assert {"wave.dispatch", "wave.reap", "wave.splice", "engine.submit", "request",
            "maintenance.run", "publisher.publish", "publisher.offer"} <= names
    text = metrics.read_text()
    gauges = {ln.split()[0] for ln in text.splitlines() if not ln.startswith("#")}
    assert gauges == _reference_gauges(maintain=True)
    assert "# TYPE hkv_engine_waves gauge" in text and "hkv_maintenance_deferred" in text


def test_serve_launcher_lm_mode_is_refused(monkeypatch):
    """`--mode lm` runs on the card: without one, and without `--device
    cpu`, the launcher refuses it (tests/test_torch_serving_lm.py runs it
    on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "lm"])
