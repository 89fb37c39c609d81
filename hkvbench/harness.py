"""The benchmark's run of one cell: set-up, the measured window, the traced
slice, the comparison with the reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix, op or
metric is a file of its own, found by the name that BENCHMARK.json gives:

  configs/<config>.json     the table as deployed (sizes, policy, tier)
  traffic/<mix>.json        the traffic mix's parameters; its "kind" names
  traffic/<kind>.py         the generator that reads them
  workloads/<cell>.json     the cell's op, warm-up, checks and limits; its
  ops/<op>.py               "op" names the module of the program's entry
  metrics/<metric>.py       each metric's reader: read(run) -> number | None
  roofline/<op>.py          the least bytes of an op's batch

The loop is closed: one batch in flight, each timed from the call into
the port to the synchronize after it.  Every batch is drawn from the seed
just before its call, so the reference can draw it again.  A cell whose
traffic kind gives a `schedule` runs the open loop of ``open_loop.py``
instead: requests submitted on a seeded schedule, each timed from when it
fell due.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import random
import sys
import time

import torch

from hkvbench import trace as trace_mod

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")    # top-level module names


def forbidden_modules() -> list:
    """The JAX stack or the JAX package, by whole top-level name, if loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    name = "hkvbench_file_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict           # configs/<config>.json
    mix: dict              # traffic/<traffic>.json
    work: dict             # workloads/<cell>.json
    metrics: tuple         # (end_to_end, per_layer) entries of BENCHMARK.json that apply

    @property
    def chips(self) -> int:
        return self.work.get("chips", 1)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    reported = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in reported}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return Cell(name=name, config=load_json(HERE / "configs" / f"{entry['config']}.json"),
                mix=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                work=dict(load_json(HERE / "workloads" / f"{name}.json"), chips=entry["chips"]),
                metrics=(tuple(reported), tuple(layer)))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's own spans, on in a traced run only.  Outside the
    profiled slice: a synchronize at each boundary and the host's
    milliseconds a span.  Inside it: a `record_function` that the trace
    reader finds, and no synchronize, so that the device's idle time is
    the untraced window's (the trace assigns each device operation to the
    span that launched it)."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on, self.profiling = device, on, False
        self.ms: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        if self.profiling:
            with torch.profiler.record_function(trace_mod.PREFIX + name):
                yield
            return
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)


class Reservoir:
    """A uniform sample of `k` of the window's answers, drawn from the seed
    (reservoir sampling: the count of batches is not known beforehand)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.kept = k, rng, {}
        self.held = 0                   # device bytes the kept answers hold

    def offer(self, index: int, seen: int, value) -> bool:
        """Whether the answer was kept (and another perhaps let go)."""
        if len(self.kept) < self.k:
            self._keep(index, value)
            return True
        r = self.rng.randrange(seen)
        if r < self.k:
            self.held -= device_bytes(self.kept.pop(sorted(self.kept)[r]))
            self._keep(index, value)
            return True
        return False

    def _keep(self, index: int, value) -> None:
        self.kept[index] = value
        self.held += device_bytes(value)


def device_bytes(value) -> int:
    """The device memory that a kept answer (a tensor or a tuple of them)
    holds, as the caching allocator counts it: each storage once, rounded
    up to its 512-byte blocks."""
    tensors = value if isinstance(value, (tuple, list)) else (value,)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if t.is_cuda}
    return sum(-(-n // 512) * 512 for n in storages.values())


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    config: dict
    window_s: float = 0.0
    keys: int = 0
    batch_ms: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    build_s: float = 0.0
    peak_bytes: int = 0             # the program's: the harness's kept answers left out
    span_ms: dict = dataclasses.field(default_factory=dict)
    slice: trace_mod.Slice | None = None
    profiled: list = dataclasses.field(default_factory=list)   # batch indices in the slice
    counts: dict = dataclasses.field(default_factory=dict)     # batch index -> work counts
    # the open loop's, a request due in the window each (ms): due -> done,
    # due -> first wave's dispatch, that dispatch -> done, due -> submitted
    request_ms: list = dataclasses.field(default_factory=list)
    queue_ms: list = dataclasses.field(default_factory=list)
    service_ms: list = dataclasses.field(default_factory=list)
    late_ms: list = dataclasses.field(default_factory=list)
    # the open loop's, a wave each (ms, the engine's `WaveReport.latency_s`:
    # dispatch -> results on the host), retired before the profiled slice
    wave_ms: list = dataclasses.field(default_factory=list)

    def roofline(self, op: str, spans: tuple) -> float | None:
        """The least time of the profiled batches' work over the device
        time inside their spans, in %; None where the cell has none."""
        from hkvbench import roofline

        if self.slice is None or self.cell.work["op"] != op or not self.profiled:
            return None
        model = roofline.model(op)
        least = sum(roofline.least_seconds(model.least_bytes(self.counts[i], self.config))[0]
                    for i in self.profiled)
        device_s = self.slice.span_device_ns(spans) / 1e9
        return 100.0 * least / device_s if device_s > 0 else None


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             started: float, value_dtype: str | None = None) -> dict:
    """One run of `cell`: the result line's object.  `started` is the
    process's start on `time.perf_counter`'s clock; `value_dtype` other
    than the configuration's is the control."""
    config, mix, work = cell.config, cell.mix, cell.work
    gen, drv, run = start(cell, device, value_dtype)
    if hasattr(gen, "schedule"):
        from hkvbench import open_loop

        return open_loop.run(gen, drv, run, seed, seconds, traced, device, started)
    spans = Spans(device, traced)
    quiet = Spans(device, False)

    # ---- set-up: the kernels, the table, its prefill, the warm-up batches -----
    build_kernels(run, device)
    drv.create()
    for b in gen.prefill(mix, config, seed, device):
        drv.prefill(b)
    warm = work["warmup_batches"]
    for i in range(warm):
        drv.call(gen.batch(mix, config, seed, i, device), quiet)
    prof = profiler(device) if traced else None
    sync(device)
    run.setup_s = time.perf_counter() - started
    cuda = device.type == "cuda"

    # ---- the window ---------------------------------------------------------
    per_batch = gen.keys_per_batch(mix, config)
    samples = Reservoir(work["samples"], random.Random(seed * 1_000_003 + 17))
    slice_at, slice_n = work["trace"]["after"] * seconds, work["trace"]["batches"]
    i, t0 = warm, time.perf_counter()
    while True:
        if prof is not None and not run.profiled and time.perf_counter() - t0 >= slice_at:
            prof.start()
            spans.profiling = True
        with spans("traffic"):
            b = gen.batch(mix, config, seed, i, device)
        tb = time.perf_counter()
        out = drv.call(b, spans)
        sync(device)
        run.batch_ms.append((time.perf_counter() - tb) * 1e3)
        held = samples.held
        kept = samples.offer(i, i - warm + 1, drv.keep(out))
        out = None
        if kept and cuda:
            # the program's peak: the kept answers are the harness's.  The
            # peak since the last change to the reservoir, less what it
            # held all that while; then a new stretch from here.
            run.peak_bytes = max(run.peak_bytes, torch.cuda.max_memory_allocated(device) - held)
            torch.cuda.reset_peak_memory_stats(device)
        if spans.profiling:
            run.profiled.append(i)
            if len(run.profiled) == slice_n:
                prof.stop()
                spans.profiling = False
        i += 1
        # a traced run's window lasts until its slice is taken
        if time.perf_counter() - t0 >= seconds and (prof is None or run.profiled) \
                and not spans.profiling:
            break
    run.window_s = time.perf_counter() - t0
    run.keys = per_batch * (i - warm)
    del b
    if cuda:
        run.peak_bytes = max(run.peak_bytes, torch.cuda.max_memory_allocated(device) - samples.held)
    run.span_ms = spans.ms
    if prof is not None:
        run.slice = trace_mod.Slice(prof)

    # ---- the comparison with the reference ----------------------------------
    t_check = time.perf_counter()
    checks, failed, replayed = _check(drv, gen, run, samples, seed, i, device)
    sync(device)
    t_check = time.perf_counter() - t_check
    return report(run, device, traced, checks, i - warm, failed,
                  {"check": t_check, "replayed_batches": replayed})


def start(cell: Cell, device: torch.device, value_dtype: str | None):
    """The cell's traffic kind, its op (the program's table not yet built)
    and its `Run`, the card's peak counted from here."""
    config = cell.config
    gen = load_module(HERE / "traffic" / f"{cell.mix['kind']}.py")
    drv = load_module(HERE / "ops" / f"{cell.work['op']}.py").Op(
        config, device, value_dtype or config["value_dtype"])
    run = Run(cell=cell, config=dict(config, width=drv.width))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    return gen, drv, run


def build_kernels(run: Run, device: torch.device) -> None:
    if device.type == "cuda":
        from repro_torch.kernels import _build

        t_build = time.perf_counter()
        _build.library()            # nvcc on a checkout's first run, else a load
        run.build_s = time.perf_counter() - t_build


def report(run: Run, device: torch.device, traced: bool, checks: dict, attempted: int,
           failed: int, phases: dict) -> dict:
    """The result line's object: the verdict on `checks` against the cell's
    limits, the metrics its readers find in `run`, the device, and with a
    traced slice its breakdown."""
    cell = run.cell
    limits = cell.work["limits"]
    verdict = {n: {"value": v, "limit": limits[n]} for n, v in checks.items()}
    correct = all(v <= limits[n] for n, v in checks.items())
    end_to_end, per_layer = cell.metrics
    wanted = per_layer if traced else end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.slice is not None:
        dev["busy_s"] = run.slice.busy_ns(run.slice.t0, run.slice.t1) / 1e9
        dev["window_s"] = run.slice.window_ns / 1e9
        result["breakdown"] = {"device_ops": run.slice.top_ops(),
                               "idle_gaps": run.slice.idle_gaps()}
        # how many device operations were matched to their launch
        result["traced_ops"] = {"device": len(run.slice.device),
                                "by_launch": run.slice.by_launch}
    result["phases_s"] = {"setup": run.setup_s, "build": run.build_s, "window": run.window_s,
                          **phases}
    result["checks"] = verdict
    return result


def profiler(device: torch.device):
    """The traced slice's profiler, not yet started; its own start-up is
    paid here, in set-up."""
    with torch.profiler.profile(activities=_activities(device)):
        torch.ones(1, device=device).add_(1)
    return torch.profiler.profile(activities=_activities(device))


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _check(drv, gen, run: Run, samples: Reservoir, seed: int, end: int,
           device: torch.device):
    """Replay the run on the reference and compare.  Returns ({number:
    value}, the checked batches whose answers differ, the batches the
    reference replayed after the prefill)."""
    mix, config, limits = run.cell.mix, run.cell.config, run.cell.work["limits"]
    ref = drv.reference()
    for b in gen.prefill(mix, config, seed, device):
        drv.ref_prefill(ref, b)
    replay = range(end) if drv.stateful else sorted(set(samples.kept) | set(run.profiled))
    totals, failed = {}, 0
    for j in replay:
        b = gen.batch(mix, config, seed, j, device)
        want, counts = drv.ref_call(ref, b)
        if j in run.profiled:
            run.counts[j] = counts
        if j in samples.kept:
            numbers = drv.compare(samples.kept.pop(j), want)
            failed += any(v > limits[n] for n, v in numbers.items())
            for n, v in numbers.items():
                totals[n] = max(totals.get(n, 0), v) if n.endswith("_gap") else totals.get(n, 0) + v
    totals.update(drv.compare_planes(ref))
    ref.free()
    drv.free()
    return totals, failed, len(replay)
