"""The tier hierarchy's spans and counters (``repro_torch.core.tiered``) on
the CPU.

Held: the ``tier.*`` stage spans nest under their op's ``tier.<op>`` span,
which is also the parent of the hot tier's own op span; the op span's
counters equal the op's result and a recount from both tiers' key planes
before and after the call; and with tracing off every one of these spans
is the shared no-op and nothing is recorded.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tiered  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

OPS = ("find_or_insert", "insert_or_assign", "find")
STAGES = {"find_or_insert": ("tier.hot_probe", "tier.cold_probe", "tier.displaced",
                             "tier.demote"),
          "insert_or_assign": ("tier.displaced", "tier.demote"),
          "find": ("tier.cold_probe", "tier.demote")}
COUNTERS = ("lanes", "hot_hits", "cold_hits", "promoted", "demoted", "dropped")


def _table(dual: int = 2):
    """A hot tier of 2 buckets over a cold tier of 4, prefilled past both
    (1100 keys into 768 slots), with SGD rows."""
    emb = HKVEmbedding(capacity=4 * 128, dim=4, hot_capacity=2 * 128, buckets_per_key=dual,
                       optimizer=SparseOptimizer("sgd", lr=0.5), backend="plain")
    t = emb.create(device="cpu")
    rng = np.random.default_rng(0)
    for part in np.split(rng.permutation(np.arange(1, 1101)), 4):
        emb.ingest(t, torch.from_numpy(part))
    return emb, t


def _batch(n: int = 300):
    """Keys in either tier, in neither and new, with duplicates and EMPTY
    lanes."""
    rng = np.random.default_rng(1)
    k = rng.integers(1, 1500, size=n).astype(np.int64)
    k[::13] = u64.EMPTY
    return torch.from_numpy(k), torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))


def _call(name, t, keys, rows):
    if name == "find":
        return t.find(keys)
    if name == "find_or_insert":
        return t.find_or_insert(keys, rows)
    return t.insert_or_assign(keys, rows)


def _live(t) -> set:
    k = t.state.keys.reshape(-1)
    return set(k[k != u64.EMPTY].tolist())


@pytest.mark.parametrize("mode", ["install", "profiler"])
@pytest.mark.parametrize("name", OPS)
def test_tier_spans_nest_under_their_op_span(name, mode):
    emb, t = _table()
    keys, rows = _batch()
    tr = trace.Tracer()
    if mode == "install":
        with trace.install(tr):
            _call(name, t, keys, rows)
        spans = tr.spans
    else:
        t0 = time.time_ns()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _call(name, t, keys, rows)
        spans = [s for s in trace.recorded() if s.start_ns >= t0]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == f"tier.{name}"]
    assert root.op == root.id and root.parent is None
    inner = "op.find" if name == "find" else "op.find_or_insert" if name == "find_or_insert" \
        else None
    for stage in STAGES[name] + ((inner,) if inner else ()):
        found = [s for s in spans if s.name == stage]
        assert found, stage
        for s in found:
            assert s.parent == root.id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert s.op == (s.id if s.name.startswith("op.") else root.id)
    for s in spans:
        if s is not root:
            assert by_id[s.parent].start_ns <= s.start_ns and s.end_ns <= by_id[s.parent].end_ns
    # the cold tier's upsert closure runs inside tier.demote
    demotes = {s.id for s in spans if s.name == "tier.demote"}
    assert any(s.parent in demotes for s in spans if s.name.startswith("closure."))


@pytest.mark.parametrize("dual", [1, 2])
@pytest.mark.parametrize("name", OPS)
def test_tier_counters_equal_the_result_and_the_planes(name, dual):
    emb, t = _table(dual)
    keys, rows = _batch()
    hot0, cold0 = _live(t.hot), _live(t.cold)
    tr = trace.Tracer()
    with trace.install(tr):
        res = _call(name, t, keys, rows)
    (sp,) = [s for s in tr.spans if s.name == f"tier.{name}"]
    got = sp.counters()
    assert {c: got[c] for c in ("promoted", "demoted", "dropped")} == {
        "promoted": int(getattr(res, "promoted", 0)), "demoted": int(res.demoted),
        "dropped": int(res.dropped)}
    if name != "insert_or_assign":
        assert got["hot_hits"] == int(res.hot_hit.sum() if name == "find"
                                      else (res.found & (res.status == 1)).sum())
    # the recount from the key planes before and after the call
    hot1, cold1 = _live(t.hot), _live(t.cold)
    lanes = [k for k in keys.tolist() if k != u64.EMPTY]
    batch = set(lanes)
    cold_hit = {k for k in batch - hot0 if k in cold0} if name != "insert_or_assign" else set()
    rejected = set() if name == "find" else batch - hot0 - hot1 - cold_hit
    handed = (hot0 - hot1) | rejected
    refused = {k for k in handed if k not in cold0 and k not in cold1}
    want = {"lanes": len(lanes), "hot_hits": sum(k in hot0 for k in lanes),
            "cold_hits": sum(k in cold_hit for k in lanes),
            "promoted": len(cold_hit & hot1), "demoted": len(handed) - len(refused),
            "dropped": len((cold0 | handed) - cold1)}
    assert {c: got[c] for c in COUNTERS} == want
    assert want["hot_hits"] and want["demoted"] and (name == "insert_or_assign"
                                                      or want["promoted"])
    if name == "find_or_insert":
        assert want["dropped"]


def test_off_every_tier_span_is_the_shared_noop(monkeypatch):
    made = []

    def recording(make):
        def wrapped(name):
            sp = make(name)
            made.append((name, sp))
            return sp
        return wrapped

    monkeypatch.setattr(tiered, "span", recording(tiered.span))
    monkeypatch.setattr(tiered, "op_span", recording(tiered.op_span))
    emb, t = _table()
    keys, rows = _batch()
    before = len(trace.recorded())
    for name in OPS:
        _call(name, t, keys, rows)
    names = {n for n, _ in made}
    assert names == {f"tier.{n}" for n in OPS} | {s for v in STAGES.values() for s in v}
    assert all(sp is trace.NOOP_SPAN for _, sp in made)
    assert len(trace.recorded()) == before
