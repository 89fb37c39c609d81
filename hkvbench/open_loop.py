"""The open loop: requests submitted on a seeded schedule whether or not
the ones before them are done, each timed from when it fell due.

A cell whose traffic kind gives a schedule runs here (`harness.run_cell`
branches to `run`).  The kind gives the schedule (`schedule(mix, config, seed,
n, device, stream)`: due times, sizes and every key, drawn on the card in
set-up and kept on the host) and each query again by its index
(`query(mix, config, seed, j, size, device, stream)`); its op gives the
program's engine (`engine(mix)`), a request (`request(rid, keys,
t_due)`) and what of an answered request is kept.

One thread runs the engine's own serving loop: a query that falls due is
submitted at once, stamped with its due time, and followed by a `poll()`
that reaps finished waves without waiting; while no query is due and the
engine has work, `step()`.  So a wave that holds the thread delays the
queries that fall due meanwhile, and their latency shows it: a request's
time runs from its due time to its answer on the host.  The window is
`--seconds` of arrivals, then the engine drains.
"""

from __future__ import annotations

import dataclasses
import random
import time
import types

import numpy as np
import torch

from hkvbench import harness
from hkvbench import trace as trace_mod

DRAIN_S = 60.0      # how long past the last due time the window waits for answers


@dataclasses.dataclass
class Served:
    """What a stream of requests got, a request each, on
    `time.perf_counter`'s clock (NaN where it never happened)."""

    due: np.ndarray
    submitted: np.ndarray
    admitted: np.ndarray
    done: np.ndarray
    kept: dict              # rid -> the op's kept answer
    profiled: list          # the rids submitted in the profiled slice
    wave_ms: list           # the waves retired before the profiled slice

    def ms(self, a: np.ndarray, b: np.ndarray) -> list:
        return ((b - a) * 1e3).tolist()


def serve(drv, eng, sched, spans: harness.Spans, keep=frozenset(), slice_at: int = -1,
          slice_n: int = 0, prof=None) -> Served:
    """Submit each query of `sched` when it falls due and drive the engine
    until it has answered them all (or `DRAIN_S` past the last due time).
    With `prof`, requests `slice_at` .. `slice_at + slice_n - 1` are
    submitted under the profiler, which stops once they are answered."""
    n = len(sched.due)
    out = Served(due=time.perf_counter() + sched.due, submitted=np.full(n, np.nan),
                 admitted=np.full(n, np.nan), done=np.full(n, np.nan), kept={}, profiled=[],
                 wave_ms=[])
    left, first, cut = n, len(eng.reports), None

    def stop_slice():
        prof.stop()
        spans.on = spans.profiling = False
        out.profiled = [k for k in range(slice_at, slice_at + slice_n) if not np.isnan(out.done[k])]

    def collect():
        # a server hands each answer to its client and lets it go
        nonlocal left
        for r in eng.completed:
            out.admitted[r.rid], out.done[r.rid] = r.t_admit, r.t_done
            if r.rid in keep:
                out.kept[r.rid] = drv.keep(r)
            left -= 1
        eng.completed.clear()

    j = 0
    while j < n:
        now = time.perf_counter()
        if now >= out.due[j]:
            if j == slice_at and prof is not None:
                cut = len(eng.reports)
                prof.start()
                spans.on = spans.profiling = True
            out.submitted[j] = now
            with spans("submit"):
                eng.submit(drv.request(j, sched.query(j), float(out.due[j])))
            with spans("poll"):
                eng.poll()
            j += 1
        elif not eng.idle:
            with spans("step"):
                eng.step()
        collect()
        if spans.profiling and j >= slice_at + slice_n \
                and not np.isnan(out.done[slice_at:slice_at + slice_n]).any():
            stop_slice()
    deadline = out.due[-1] + DRAIN_S if n else 0.0
    while left and time.perf_counter() < deadline:
        with spans("step"):
            eng.step()
        collect()
    if spans.profiling:
        stop_slice()
    out.wave_ms = [w.latency_s * 1e3 for w in eng.reports[first:cut]]
    return out


def run(gen, drv, run: harness.Run, seed: int, seconds: float, traced: bool,
        device: torch.device, started: float) -> dict:
    """One run of an open-loop cell, `harness.run_cell`'s result."""
    cell = run.cell
    config, mix, work = cell.config, cell.mix, cell.work
    cuda = device.type == "cuda"

    # ---- set-up: the schedules (the card's peak counted after them), the
    # kernels, the table, its prefill, the engine and its warm-up stream ------
    window = gen.schedule(mix, config, seed, round(mix["rate_qps"] * seconds), device)
    warm = gen.schedule(mix, config, seed, work["warmup_batches"], device, "warmup")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    harness.build_kernels(run, device)
    drv.create()
    for b in gen.prefill(mix, config, seed, device):
        drv.prefill(b)
    eng = drv.engine(mix)
    spans = harness.Spans(device, False)
    serve(drv, eng, warm, spans)
    prof = harness.profiler(device) if traced else None
    harness.sync(device)
    run.setup_s = time.perf_counter() - started

    # ---- the window ---------------------------------------------------------
    n = len(window.due)
    keep = set(random.Random(seed * 1_000_003 + 17).sample(range(n), min(work["samples"], n)))
    slice_at = int(np.searchsorted(window.due, work["trace"]["after"] * seconds))
    got = serve(drv, eng, window, spans, keep, slice_at,
                min(work["trace"]["batches"], n - slice_at), prof)
    answered = ~np.isnan(got.done)
    run.request_ms = got.ms(got.due, got.done)
    run.queue_ms = got.ms(got.due, got.admitted)
    run.service_ms = got.ms(got.admitted, got.done)
    run.late_ms = got.ms(got.due, got.submitted)
    run.wave_ms = got.wave_ms
    run.keys = int(window.sizes[answered].sum())
    last = np.nanmax(got.done) if answered.any() else got.due[-1]
    run.window_s = float(last - got.due[0])
    run.profiled = got.profiled
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if prof is not None and got.profiled:
        run.slice = trace_mod.Slice(prof)
    del eng

    # ---- the comparison with the reference ----------------------------------
    t_check = time.perf_counter()
    queries = types.SimpleNamespace(
        prefill=gen.prefill,
        batch=lambda mix, config, seed, j, device: {
            "keys": gen.query(mix, config, seed, j, int(window.sizes[j]), device)})
    checks, failed, replayed = harness._check(
        drv, queries, run, types.SimpleNamespace(kept=got.kept), seed, n, device)
    checks["unanswered"] = int(n - answered.sum())
    harness.sync(device)
    t_check = time.perf_counter() - t_check
    return harness.report(run, device, traced, checks, n, failed + checks["unanswered"],
                          {"check": t_check, "replayed_batches": replayed})


def tail(run: harness.Run, ms: list, q: float = 99.0) -> float | None:
    """The q-th percentile (numpy's linear interpolation) of a
    per-request time of `run`, over the answered requests and, in a
    traced run, only those due before the profiled slice: the profiler's
    start and stop hold the thread, and the requests due meanwhile show
    it.  None where there is none."""
    ms = np.asarray(ms[:run.profiled[0]] if run.profiled else ms, dtype=np.float64)
    ms = ms[~np.isnan(ms)]
    return float(np.percentile(ms, q)) if ms.size else None
