"""The open loop on the CPU at a tiny size, the chip's look skipped: the
schedule repeats by seed, a request is timed from when it fell due, the
readers against hand counts, the engine's answers against the reference
through the whole harness, and the control and planted faults in the
engine's unpacking come out not correct."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from hkvbench import harness, open_loop
from repro_torch.serving import embedding_engine

CPU = torch.device("cpu")
SEED = 2**31 + 777
MIX = {"samples_min": 2, "samples_max": 6, "field_sizes": [900, 3, 40, 2500], "wave_size": 64,
       "rate_qps": 300, "prefill_batch": 256}


def tiny(**work) -> harness.Cell:
    c = harness.load_cell("hkv_b.serve_open")
    return dataclasses.replace(
        c, config=dict(c.config, capacity=8 * 128), mix=dict(c.mix, **MIX),
        work=dict(c.work, warmup_batches=20, samples=24,
                  trace={"after": 0.5, "batches": 6}, **work))


def run(traced: bool = False, **kw) -> dict:
    return harness.run_cell(tiny(), SEED, 0.4, traced, CPU, time.perf_counter(), **kw)


def kind():
    return harness.load_module(harness.HERE / "traffic" / "poisson_queries.py")


def test_the_schedule_and_every_query_repeat_by_seed():
    gen, mix, config = kind(), tiny().mix, tiny().config
    a, b = (gen.schedule(mix, config, SEED, 50, CPU) for _ in range(2))
    assert np.array_equal(a.due, b.due) and np.array_equal(a.sizes, b.sizes)
    assert np.array_equal(a.keys, b.keys)
    for j in (0, 17, 49):
        want = gen.query(mix, config, SEED, j, int(a.sizes[j]), CPU)
        assert np.array_equal(a.query(j), want.numpy().view(np.uint64))
    # another seed: the same sizes and gaps in another order, other keys
    c = gen.schedule(mix, config, SEED + 1, 50, CPU)
    assert np.array_equal(np.sort(c.sizes), np.sort(a.sizes))
    assert np.allclose(np.sort(np.diff(c.due, prepend=0)), np.sort(np.diff(a.due, prepend=0)))
    assert not np.array_equal(c.sizes, a.sizes) and not np.array_equal(c.keys[:50], a.keys[:50])
    assert set(a.sizes.tolist()) <= {4 * n for n in range(2, 7)}


def test_a_stall_shows_in_the_requests_due_during_it(monkeypatch):
    """One engine call held for 0.3 s: every request due meanwhile is
    submitted late by the rest of the stall, and its time counts it."""
    c = tiny()
    gen, drv, _ = harness.start(c, CPU, None)
    drv.create()
    for b in gen.prefill(c.mix, c.config, SEED, CPU):
        drv.prefill(b)
    eng = drv.engine(c.mix)
    stall, calls = [], [0]
    real = embedding_engine.OnlineEmbeddingEngine.step

    def step(self):
        calls[0] += 1
        if calls[0] == 5:
            t = time.perf_counter()
            time.sleep(0.3)
            stall.extend([t, time.perf_counter()])
        return real(self)

    monkeypatch.setattr(embedding_engine.OnlineEmbeddingEngine, "step", step)
    sched = gen.schedule(c.mix, c.config, SEED, 200, CPU)
    got = open_loop.serve(drv, eng, sched, harness.Spans(CPU, False))
    assert not np.isnan(got.done).any()
    request = np.asarray(got.ms(got.due, got.done))
    parts = np.asarray(got.ms(got.due, got.admitted)) + np.asarray(got.ms(got.admitted, got.done))
    assert np.allclose(parts, request, rtol=0, atol=1e-6)
    late = np.asarray(got.ms(got.due, got.submitted))
    during = (got.due >= stall[0]) & (got.due < stall[1])
    assert during.sum() >= 20
    held = (stall[1] - got.due[during]) * 1e3
    assert (late[during] >= held).all() and (request[during] >= held).all()


def _run(**ms) -> harness.Run:
    r = harness.Run(cell=tiny(), config={}, **ms)
    r.window_s, r.keys = 2.0, 3_000_000
    return r


def test_the_readers_against_hand_counts():
    ms = [float(k) for k in range(1, 102)]          # 1 .. 101: p99 = 100.0
    read = {m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read
            for m in ("request_ms_p50", "serve.request_ms_p99", "serve.queue_ms_p99",
                      "serve.service_ms_p99", "serve.late_ms_p99", "serve.wave_ms_p95",
                      "kv_per_s")}
    r = _run(request_ms=ms, queue_ms=ms[::-1], service_ms=[2 * x for x in ms],
             late_ms=[x / 4 for x in ms], wave_ms=[3 * x for x in ms[:21]])
    assert read["request_ms_p50"](r) == pytest.approx(51.0)
    assert read["serve.request_ms_p99"](r) == pytest.approx(100.0)
    assert read["serve.queue_ms_p99"](r) == pytest.approx(100.0)
    assert read["serve.service_ms_p99"](r) == pytest.approx(200.0)
    assert read["serve.late_ms_p99"](r) == pytest.approx(25.0)
    assert read["serve.wave_ms_p95"](r) == pytest.approx(60.0)      # 3 x 20.0
    assert read["kv_per_s"](r) == pytest.approx(1.5)
    # a traced run: the requests due before the slice, unanswered ones left out
    r = _run(request_ms=ms[:50] + [float("nan")] + [1e6] * 50)
    r.profiled = list(range(51, 60))
    assert read["serve.request_ms_p99"](r) == pytest.approx(np.percentile(ms[:50], 99))
    assert read["serve.request_ms_p99"](_run(request_ms=[float("nan")])) is None
    assert read["request_ms_p50"](_run(request_ms=[1.0, float("nan"), 5.0])) == pytest.approx(3.0)
    assert read["serve.wave_ms_p95"](_run()) is None


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(traced):
    r = run(traced)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 120 and r["failed"] == 0
    assert r["phases_s"]["replayed_batches"] >= 24
    assert list(r)[-1] == "checks" and r["checks"]["unanswered"]["value"] == 0
    want = ({"serve.request_ms_p99", "serve.queue_ms_p99", "serve.wave_ms_p95"} if traced
            else {"kv_per_s", "request_ms_p50", "setup_s"})
    assert want <= set(r["metrics"])


def test_the_bfloat16_control_is_not_correct():
    r = run(value_dtype="bfloat16")
    assert not r["correct"] and r["checks"]["rows_gap"]["value"] > 0


REAL_RETIRE = embedding_engine.OnlineEmbeddingEngine._retire


def _shifted(self, flight):
    """Each request's segment of a wave unpacked one lane over (but where
    it ends at the wave's last lane)."""
    segs = [(r, o, l0 + 1 if l0 + t < len(flight.lanes) else l0, t)
            for r, o, l0, t in flight.segments]
    return REAL_RETIRE(self, flight._replace(segments=segs))


def _half(self, flight):
    """The second half of each request's rows and flags left unfilled."""
    report = REAL_RETIRE(self, flight)
    for r, *_ in flight.segments:
        if r.done:
            r.values[len(r.keys) // 2:] = 0
            r.found[len(r.keys) // 2:] = False
    return report


@pytest.mark.parametrize("fault", [_shifted, _half], ids=["shifted", "half"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(embedding_engine.OnlineEmbeddingEngine, "_retire", fault)
    r = run()
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["found_mismatch"]["value"] > 0 or r["checks"]["rows_gap"]["value"] > 0
