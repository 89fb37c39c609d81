"""The program's spans and counters (``repro_torch.obs.trace``) on the CPU.

Held: the off path records nothing and hands back the shared no-op; a
live span (under `install` or a running `torch.profiler`) records its
name, stamps, parent and op call; its stamps are on the profiler's clock;
each op span's counters equal the ``telemetry=`` observer's on the same
call; every op's outputs and planes are bit-identical with tracing live
and off; and the package opens no profiler range of its own.
"""

import pathlib
import statistics
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ops  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.obs import TelemetrySink  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
OPS = ("find", "insert_or_assign", "find_or_insert", "ingest", "update_rows")
COUNTERS = ("lanes", "hits", "updated", "inserted", "evicted", "rejected")
CLOSURE = ("closure.dedupe", "closure.locate", "closure.hits", "closure.target", "closure.order",
           "closure.rank", "closure.miss_count", "closure.victims", "closure.write",
           "closure.status", "closure.post")


def _table(dual: int = 2, fill: int = 700, seed: int = 0):
    """A 4-bucket table past full (fill keys into 512 slots) and its
    embedding, with SGD (no aux column)."""
    emb = HKVEmbedding(capacity=4 * 128, dim=4, buckets_per_key=dual,
                       optimizer=SparseOptimizer("sgd", lr=0.5))
    t = emb.create(device="cpu")
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.permutation(np.arange(1, fill + 1)).astype(np.int64))
    ops.insert_or_assign(t.state, t.cfg, keys, torch.ones(fill, 4))
    return emb, t


def _batch(seed: int = 1, n: int = 96):
    """Keys half resident, half new, with duplicates and EMPTY lanes."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 1400, size=n).astype(np.int64)
    k[::11] = u64.EMPTY
    return torch.from_numpy(k), torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))


def _call(name, state, cfg, opt, keys, rows, **kw):
    if name == "find":
        return ops.find(state, cfg, keys, **kw)
    if name == "update_rows":
        uniq = torch.unique(keys[keys != u64.EMPTY])
        return ops.update_rows(state, cfg, uniq, rows[:uniq.shape[0]], opt, **kw)
    return getattr(ops, name)(state, cfg, keys, rows, **kw)


def _live(mode):
    if mode == "install":
        return trace.install(trace.Tracer())
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _spans(mode, ctx):
    return list(ctx.spans) if mode == "install" else trace.recorded()


# -- the off path --------------------------------------------------------------


@pytest.mark.parametrize("make", [trace.span, trace.op_span, trace.NOOP_TRACER.span],
                         ids=["span", "op_span", "noop_tracer"])
def test_off_returns_the_shared_noop_and_records_nothing(make):
    before = len(trace.recorded())
    sp = make("op.find")
    assert sp is trace.NOOP_SPAN and not sp
    with sp as entered:
        entered.count(lanes=1)
    emb, t = _table()
    keys, rows = _batch()
    for name in OPS:
        _call(name, t.state, t.cfg, emb.optimizer, keys, rows)
    assert len(trace.recorded()) == before


# -- live spans -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["install", "profiler"])
def test_live_spans_record_parents_and_op_calls(mode):
    emb, t = _table()
    keys, _ = _batch()
    t0 = time.time_ns()
    with _live(mode) as ctx:
        assert trace.span("x") is not trace.NOOP_SPAN
        t, _rows = emb.lookup_train(t, keys)
    spans = [s for s in _spans(mode, ctx) if s.start_ns >= t0]
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    assert set(CLOSURE) | {"hash", "op.find_or_insert", "op.readback", "embedding.lookup_train",
                           "embedding.default_rows"} <= set(names)
    (root,) = [s for s in spans if s.name == "embedding.lookup_train"]
    (op,) = [s for s in spans if s.name == "op.find_or_insert"]
    assert root.parent is None and root.op is None and op.op == op.id
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s is not root:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
        if s.name.startswith("closure.") or s.name == "op.readback":
            assert s.parent == op.id and s.op == op.id
    assert by_id[[s for s in spans if s.name == "hash"][0].parent].name == "closure.locate"
    assert op.counters()["launches"] == 0        # no custom kernel on the CPU
    assert trace.span("x") is trace.NOOP_SPAN


def test_tracer_export_is_on_the_profilers_clock():
    tr = trace.Tracer()
    t0 = time.time_ns() / 1e3
    with trace.install(tr):
        with trace.span("outer"):
            tr.instant("mark")
    tr.complete_abs("abs", time.perf_counter() - 0.001, time.perf_counter())
    t1 = time.time_ns() / 1e3
    evs = {e["name"]: e for e in tr.to_chrome()["traceEvents"]}
    assert set(evs) == {"outer", "mark", "abs"} and len(tr) == 3
    for e in evs.values():
        back = 1000 if e["name"] == "abs" else 0       # stamped 1 ms before it was given
        assert t0 - back - 100 <= e["ts"] <= t1 + 100
    assert evs["outer"]["args"] == {"id": evs["outer"]["args"]["id"], "parent": None, "op": None}


def test_a_span_brackets_a_profiler_range_on_its_clock():
    stamps = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.warm"):
            torch.ones(8).sum()
        for i in range(20):
            with trace.span("test.outer") as sp:
                with torch.profiler.record_function(f"test.inner{i}"):
                    torch.ones(1000).sum()
            stamps.append((sp.start_ns, sp.end_ns))
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("test.inner")}
    lead, tail = [], []
    for i, (a, b) in enumerate(stamps):
        e = evs[f"test.inner{i}"]
        lead.append(e.start_ns() - a)
        tail.append(b - (e.start_ns() + e.duration_ns()))
    assert min(lead) >= 0 and min(tail) >= 0
    assert statistics.median(lead) < 50_000 and statistics.median(tail) < 50_000


# -- counters --------------------------------------------------------------------


@pytest.mark.parametrize("dual", [1, 2])
@pytest.mark.parametrize("name", OPS)
def test_op_counters_equal_the_observers(name, dual):
    emb, t = _table(dual)
    keys, rows = _batch()
    sink = TelemetrySink()
    tr = trace.Tracer()
    with trace.install(tr):
        _call(name, t.state, t.cfg, emb.optimizer, keys, rows, telemetry=sink)
    (op,) = [s for s in tr.spans if s.name == f"op.{name}"]
    got = op.counters()
    want = sink.snapshot()[name]
    assert {c: got.get(c, 0) for c in COUNTERS} == {c: want[c] for c in COUNTERS}
    assert got["lanes"] > got["hits"] > 0
    if name in ("insert_or_assign", "find_or_insert", "ingest"):
        assert got["evicted"] + got["rejected"] > 0


@pytest.mark.parametrize("mode", ["install", "profiler"])
@pytest.mark.parametrize("name", OPS)
def test_outputs_and_planes_are_the_same_live_and_off(name, mode):
    emb, off = _table()
    _, on = _table()
    keys, rows = _batch()
    want = _call(name, off.state, off.cfg, emb.optimizer, keys, rows)
    with _live(mode):
        got = _call(name, on.state, on.cfg, emb.optimizer, keys, rows)
    for a, b in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(off.state.planes, on.state.planes):
        assert torch.equal(a, b)
    assert (off.state.clock, off.state.epoch) == (on.state.clock, on.state.epoch)


# -- what the package may not do ---------------------------------------------------


@pytest.mark.parametrize("word", ["record_function", "nvtx", "os.environ", "getenv"])
def test_no_profiler_range_and_no_switch_in_the_environment(word):
    files = [PORT / "obs" / "trace.py", PORT / "core" / "ops.py", PORT / "core" / "merge.py",
             PORT / "core" / "find.py", PORT / "embedding" / "dynamic.py"]
    if word in ("record_function", "nvtx"):
        files = sorted(PORT.rglob("*.py"))
    assert not [p for p in files if word in p.read_text()]
