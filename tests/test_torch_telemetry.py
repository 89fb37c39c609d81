"""The port's op telemetry channel against the JAX package's.

Mirrors ``tests/test_obs.py``'s telemetry cases.  The same numpy keys and
values, made from a seed, go through the JAX package's ops (backend 'jnp')
with a ``repro.obs.TelemetrySink`` and through the port's on the CPU with a
``repro_torch.obs.TelemetrySink``, starting from one state (carried across
by ``repro_torch.convert``).  Held bit for bit: every counter of every op
record, in both bucket modes, flat and tiered; every op result and the
drained state with the sink on and off; the probe curve over λ; the
registry's Prometheus text; and the sinks of ``ingest_delta`` and
``OnlineTrainer``.  A sink adds no kernel launch (the ops are routed to the
kernel stages, which run their plain versions on the CPU, and the calls
counted), and ``telemetry=None`` does not even import the observers.
"""

import inspect
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.core.predicates import SweepPredicate as JPred  # noqa: E402
from repro.core.tiered import TieredHKVTable as JTiered  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JOpt  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import TelemetrySink as JSink  # noqa: E402
import repro.serving as jserve  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serving as pserve  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core import roles  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.core.predicates import SweepPredicate as PPred  # noqa: E402
from repro_torch.embedding.sparse_opt import SparseOptimizer as POpt  # noqa: E402
from repro_torch.obs import MetricsRegistry as PRegistry  # noqa: E402
from repro_torch.obs import OpTelemetry, TelemetrySink  # noqa: E402
from repro_torch.obs import telemetry as obs_telemetry  # noqa: E402

DIM = 8
CAP = 8 * 128
N = 64


def _filled(rng, dual, n, cap=CAP, dim=DIM):
    """A JAX state filled with n random keys (by the port, which the other
    tests hold equal to the JAX package's upsert), and its keys."""
    cfg = jtable.HKVConfig(capacity=cap, dim=dim, buckets_per_key=dual)
    keys = rng.integers(1, 2**50, size=n).astype(np.uint64)
    t = repro_torch.HKVTable.create(_pcfg(cfg), device="cpu")
    t.insert_or_assign(keys, torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)))
    arrays = convert.state_to_arrays(t.state)
    return cfg, jtable.HKVState(**{f: jnp.asarray(arrays[f]) for f in convert.FIELDS}), keys


def _pcfg(cfg):
    return ptable.HKVConfig(capacity=cfg.capacity, dim=cfg.dim,
                            buckets_per_key=cfg.buckets_per_key)


def _same(a, b, ctx):
    """Bit-identity of two port results (tensors, states, NamedTuples)."""
    if isinstance(a, ptable.HKVState):
        for x, y in zip(a.planes, b.planes):
            assert torch.equal(x, y), ctx
        assert (a.clock, a.epoch) == (b.clock, b.epoch), ctx
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), ctx
    elif isinstance(a, tuple):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{ctx}[{i}]")
    else:
        assert a == b, ctx


def _cases(cfg, pcfg, k, vals, rng):
    """op name -> (JAX call, port call); each takes (state, sink)."""
    kj, kp = ju64.from_uint64(k), pu64.from_numpy_u64(k)
    vj, vp = jnp.asarray(vals), torch.from_numpy(vals)
    scores = rng.integers(0, 2**40, size=len(k)).astype(np.uint64)
    sj, sp = ju64.from_uint64(scores), pu64.from_numpy_u64(scores)
    optj, optp = JOpt("sgd", lr=0.5), POpt("sgd", lr=0.5)
    predj, predp = JPred.score_at_least(1), PPred.score_at_least(1)
    return {
        "find": (lambda s, t: jops.find(s, cfg, kj, telemetry=t),
                 lambda s, t: pops.find(s, pcfg, kp, telemetry=t)),
        "find_rows": (lambda s, t: jops.find_rows(s, cfg, kj, telemetry=t),
                      lambda s, t: pops.find_rows(s, pcfg, kp, telemetry=t)),
        "find_ptr": (lambda s, t: jops.find_ptr(s, cfg, kj, telemetry=t),
                     lambda s, t: pops.find_ptr(s, pcfg, kp, telemetry=t)),
        "contains": (lambda s, t: jops.contains(s, cfg, kj, telemetry=t),
                     lambda s, t: pops.contains(s, pcfg, kp, telemetry=t)),
        "insert_or_assign": (
            lambda s, t: jops.insert_or_assign(s, cfg, kj, vj, telemetry=t),
            lambda s, t: pops.insert_or_assign(s, pcfg, kp, vp, telemetry=t)),
        "insert_and_evict": (
            lambda s, t: jops.insert_and_evict(s, cfg, kj, vj, telemetry=t),
            lambda s, t: pops.insert_and_evict(s, pcfg, kp, vp, telemetry=t)),
        "find_or_insert": (
            lambda s, t: jops.find_or_insert(s, cfg, kj, vj, telemetry=t),
            lambda s, t: pops.find_or_insert(s, pcfg, kp, vp, telemetry=t)),
        "ingest": (lambda s, t: jops.ingest(s, cfg, kj, vj, telemetry=t),
                   lambda s, t: pops.ingest(s, pcfg, kp, vp, telemetry=t)),
        "accum_or_assign": (
            lambda s, t: jops.accum_or_assign(s, cfg, kj, vj, telemetry=t),
            lambda s, t: pops.accum_or_assign(s, pcfg, kp, vp, telemetry=t)),
        "update_rows": (
            lambda s, t: jops.update_rows(s, cfg, kj, vj, optj, telemetry=t),
            lambda s, t: pops.update_rows(s, pcfg, kp, vp, optp, telemetry=t)),
        "assign": (lambda s, t: jops.assign(s, cfg, kj, vj, telemetry=t),
                   lambda s, t: pops.assign(s, pcfg, kp, vp, telemetry=t)),
        "assign_add": (lambda s, t: jops.assign_add(s, cfg, kj, vj, telemetry=t),
                       lambda s, t: pops.assign_add(s, pcfg, kp, vp, telemetry=t)),
        "assign_scores": (
            lambda s, t: jops.assign_scores(s, cfg, kj, sj, telemetry=t),
            lambda s, t: pops.assign_scores(s, pcfg, kp, sp, telemetry=t)),
        "erase": (lambda s, t: jops.erase(s, cfg, kj, telemetry=t),
                  lambda s, t: pops.erase(s, pcfg, kp, telemetry=t)),
        "erase_if": (lambda s, t: jops.erase_if(s, cfg, predj, telemetry=t),
                     lambda s, t: pops.erase_if(s, pcfg, predp, telemetry=t)),
        "evict_if": (lambda s, t: jops.evict_if(s, cfg, predj, 16, telemetry=t),
                     lambda s, t: pops.evict_if(s, pcfg, predp, 16, telemetry=t)),
    }


# =============================================================================
# bit identity with the sink on and off; every counter equal to JAX's
# =============================================================================


@pytest.mark.parametrize("dual", [1, 2])
def test_every_op_bit_identical_and_counted_as_jax(dual):
    rng = np.random.default_rng(11)
    cfg, state, resident = _filled(rng, dual, 400)
    pcfg = _pcfg(cfg)
    hits = rng.choice(resident, size=N - 16)
    misses = rng.integers(2**50, 2**60, size=12).astype(np.uint64)
    k = np.concatenate([hits, misses, np.full(4, ju64.EMPTY_KEY, np.uint64)])
    vals = rng.normal(size=(N, DIM)).astype(np.float32)
    for name, (run_j, run_p) in _cases(cfg, pcfg, k, vals, rng).items():
        sink_j, sink_p = JSink(), TelemetrySink()
        run_j(state, sink_j)
        on, off = (convert.state_from_arrays(state, "cpu") for _ in range(2))
        got_on, got_off = run_p(on, sink_p), run_p(off, None)
        _same(got_on, got_off, f"{name} (dual={dual}) result")
        _same(on, off, f"{name} (dual={dual}) state")
        assert sink_p.calls == sink_j.calls == {name: 1}, name
        assert sink_p.snapshot() == sink_j.snapshot(), name
        if name in ("erase_if", "evict_if"):     # sweeps: no key lanes
            assert sink_p.total().to_dict()["probed_buckets"] == cfg.num_buckets
        else:
            assert sink_p.total().to_dict()["lanes"] == N - 4, name
        assert sink_p.by_op[name].rates() == sink_j.by_op[name].rates(), name


def test_telemetry_counters_are_correct():
    """Fresh inserts are misses and inserted; a re-find hits everything."""
    rng = np.random.default_rng(5)
    t = repro_torch.HKVTable.create(capacity=CAP, dim=4, buckets_per_key=2, device="cpu")
    keys = rng.integers(1, 2**40, size=64).astype(np.uint64)
    sink = TelemetrySink()
    t.insert_or_assign(keys, torch.zeros(64, 4), telemetry=sink)
    up = sink.by_op["insert_or_assign"].to_dict()
    assert up["lanes"] == 64 and up["updated"] == 0
    assert up["inserted"] + up["evicted"] + up["rejected"] == 64
    assert up["probed_buckets"] >= 64 and up["second_probe"] == 64
    t.find(keys, telemetry=sink)
    fd = sink.by_op["find"].to_dict()
    assert fd["hits"] == 64 and fd["misses"] == 0
    rates = sink.by_op["find"].rates()
    assert rates["hit_rate"] == 1.0 and 1.0 <= rates["probes_per_query"] <= 2.0


def test_handle_methods_record_as_jax():
    """HKVTable's keyed methods forward the sink, batch after batch."""
    from repro.core import HKVTable as JTable

    rng = np.random.default_rng(3)
    jt = JTable.create(capacity=4 * 128, dim=4, buckets_per_key=2, backend="jnp")
    pt = repro_torch.HKVTable.create(capacity=4 * 128, dim=4, buckets_per_key=2, device="cpu")
    sj, sp = JSink(), TelemetrySink()
    for _ in range(2):
        k = rng.integers(0, 1500, size=300).astype(np.uint64)
        k[:5] = ju64.EMPTY_KEY
        v = rng.normal(size=(300, 4)).astype(np.float32)
        jt = jt.insert_or_assign(k, jnp.asarray(v), telemetry=sj).table
        pt.insert_or_assign(k, torch.from_numpy(v), telemetry=sp)
        jt = jt.insert_and_evict(k, jnp.asarray(v), telemetry=sj).table
        pt.insert_and_evict(k, torch.from_numpy(v), telemetry=sp)
        jt.find(k, telemetry=sj), jt.find_rows(k, telemetry=sj)
        pt.find(k, telemetry=sp), pt.find_rows(k, telemetry=sp)
        jt.find_ptr(k, telemetry=sj), jt.contains(k, telemetry=sj)
        pt.find_ptr(k, telemetry=sp), pt.contains(k, telemetry=sp)
        jt = jt.find_or_insert(k, jnp.asarray(v), telemetry=sj).table
        pt.find_or_insert(k, torch.from_numpy(v), telemetry=sp)
        jt = jt.ingest(k, jnp.asarray(v), telemetry=sj).table
        pt.ingest(k, torch.from_numpy(v), telemetry=sp)
        jt = jt.accum_or_assign(k, jnp.asarray(v), telemetry=sj).table
        pt.accum_or_assign(k, torch.from_numpy(v), telemetry=sp)
        jt = jt.assign(k, jnp.asarray(v), telemetry=sj).assign_add(k, jnp.asarray(v),
                                                                     telemetry=sj)
        pt.assign(k, torch.from_numpy(v), telemetry=sp).assign_add(k, torch.from_numpy(v),
                                                                   telemetry=sp)
        jt = jt.assign_scores(k, k, telemetry=sj)
        pt.assign_scores(k, k, telemetry=sp)
        jt = jt.erase(k[:50], telemetry=sj)
        pt.erase(k[:50], telemetry=sp)
        jt = jt.erase_if(JPred.key_in_range(0, 100), telemetry=sj).table
        pt.erase_if(PPred.key_in_range(0, 100), telemetry=sp)
        jt = jt.evict_if(JPred.always(), 8, telemetry=sj).table
        pt.evict_if(PPred.always(), 8, telemetry=sp)
    assert sp.snapshot() == sj.snapshot()
    assert sp.calls == sj.calls
    assert sp.total().to_dict() == {f: int(np.asarray(v)) for f, v in
                                    zip(OpTelemetry._fields, sj.total())}


# =============================================================================
# tiered motion
# =============================================================================


def test_tiered_telemetry_records_tier_motion_as_jax():
    kw = dict(hot_capacity=2 * 128, cold_capacity=8 * 128, dim=4, slots_per_bucket=8)
    jt = JTiered.create(cold_value_tier="hbm", **kw)
    pt = repro_torch.TieredHKVTable.create(device="cpu", **kw)
    sj, sp = JSink(), TelemetrySink()
    keys = np.arange(1, 400, dtype=np.uint64)
    vals = np.ones((len(keys), 4), np.float32)
    rj = jt.insert_or_assign(keys, jnp.asarray(vals), telemetry=sj)
    rp = pt.insert_or_assign(keys, torch.from_numpy(vals), telemetry=sp)
    assert "insert_and_evict" in sp.by_op and "tier" in sp.by_op
    assert sp.by_op["tier"].to_dict()["demoted"] == int(rp.demoted) == int(rj.demoted)
    rng = np.random.default_rng(8)
    jt = rj.table
    for step in range(2):
        q = rng.integers(1, 600, size=64).astype(np.uint64)
        jt = jt.find(q, promote=True, telemetry=sj).table
        pt.find(q, promote=True, telemetry=sp)
        jt = jt.find_or_insert(q, jnp.ones((64, 4)), telemetry=sj).table
        pt.find_or_insert(q, torch.ones(64, 4), telemetry=sp)
        jt = jt.ingest(q[::-1].copy(), jnp.ones((64, 4)), telemetry=sj).table
        pt.ingest(q[::-1].copy(), torch.ones(64, 4), telemetry=sp)
        jt.contains(q, telemetry=sj), pt.contains(q, telemetry=sp)
        jt = jt.erase(q[:4], telemetry=sj)
        pt.erase(q[:4], telemetry=sp)
    jt = jt.erase_if(JPred.key_in_range(0, 20), telemetry=sj).table
    pt.erase_if(PPred.key_in_range(0, 20), telemetry=sp)
    jt = jt.evict_if(JPred.always(), 8, telemetry=sj).table
    pt.evict_if(PPred.always(), 8, telemetry=sp)
    assert sp.snapshot() == sj.snapshot()
    assert sp.calls == sj.calls
    assert sp.by_op["tier"].to_dict()["promoted"] > 0


# =============================================================================
# no launch added with a sink, and none of the observers without one
# =============================================================================

_WRAPPERS = ("find_scan", "digest_scan", "gather_rows", "scatter_rows", "upsert_probe",
             "claim_scan", "sweep_match", "update_scan")


def _count_kernel_calls(monkeypatch):
    """Route the ops to their kernel stages on the CPU (whose wrappers run
    the plain versions there) and count the wrapper calls."""
    from repro_torch.kernels import ops as kops

    counts = dict.fromkeys(_WRAPPERS, 0)
    for name in _WRAPPERS:
        orig = getattr(kops, name)

        def counting(*a, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(kops, name, counting)
    monkeypatch.setattr(pops, "uses_kernels", lambda backend, device: True)
    return counts


@pytest.mark.parametrize("dual", [1, 2])
def test_a_sink_adds_no_kernel_launch(monkeypatch, dual):
    rng = np.random.default_rng(3)
    cfg, state, resident = _filled(rng, dual, 300)
    pcfg = _pcfg(cfg)
    k = np.concatenate([resident[:48], rng.integers(2**50, 2**60, size=16).astype(np.uint64)])
    vals = rng.normal(size=(N, DIM)).astype(np.float32)
    counts = _count_kernel_calls(monkeypatch)
    routes = {}
    for name, (_j, run_p) in _cases(cfg, pcfg, k, vals, rng).items():
        got = []
        for sink in (None, TelemetrySink()):
            for c in counts:
                counts[c] = 0
            run_p(convert.state_from_arrays(state, "cpu"), sink)
            got.append({c: n for c, n in counts.items() if n})
        assert got[0] == got[1], f"{name}: {got[0]} without a sink, {got[1]} with one"
        routes[name] = got[0]
    assert routes["find"] == {"find_scan": 1}
    assert routes["find_ptr"] == routes["contains"] == {"digest_scan": 1}
    assert routes["update_rows"] == {"update_scan": 1}
    assert routes["erase_if"] == routes["evict_if"] == {"sweep_match": 1}


def test_telemetry_none_imports_no_observer():
    code = (
        "import sys, numpy as np, repro_torch\n"
        "t = repro_torch.HKVTable.create(capacity=256, dim=4, device='cpu')\n"
        "k = np.arange(1, 65, dtype=np.uint64)\n"
        "t.insert_or_assign(k, np.ones((64, 4), np.float32)); t.find(k); t.erase(k)\n"
        "assert 'repro_torch.obs.telemetry' not in sys.modules\n"
        "from repro_torch.obs import TelemetrySink\n"
        "t.find(k, telemetry=TelemetrySink())\n"
        "assert 'repro_torch.obs.telemetry' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": "src", "PATH": ""}, cwd=_root())
    assert r.returncode == 0, r.stderr


def _root():
    import pathlib

    return str(pathlib.Path(__file__).resolve().parent.parent)


# =============================================================================
# the λ-stability claim, read from the counters
# =============================================================================


def test_probe_counter_flat_across_load_factor_as_jax():
    cfg = jtable.HKVConfig(capacity=32 * 128, dim=4, buckets_per_key=2)
    probes = {}
    for lam in (0.25, 0.5, 0.75, 0.95):
        rng = np.random.default_rng(17)   # the same stream at every λ
        _cfg, state, resident = _filled(rng, 2, int(lam * cfg.capacity), cap=cfg.capacity, dim=4)
        q = rng.choice(resident, size=512)
        sj, sp = JSink(), TelemetrySink()
        jops.find(state, cfg, ju64.from_uint64(q), telemetry=sj)
        pops.find(convert.state_from_arrays(state, "cpu"), _pcfg(cfg), pu64.from_numpy_u64(q),
                  telemetry=sp)
        assert sp.snapshot() == sj.snapshot(), lam
        probes[lam] = sp.by_op["find"].rates()["probes_per_query"]
    lo, hi = min(probes.values()), max(probes.values())
    assert (hi - lo) / lo < 0.05, f"probe curve not λ-flat: {probes}"


# =============================================================================
# the registry, the serving path's sinks
# =============================================================================


def test_observe_telemetry_prometheus_text_equals_jax():
    rng = np.random.default_rng(21)
    cfg, state, resident = _filled(rng, 2, 500)
    k = np.concatenate([resident[:40], rng.integers(2**50, 2**60, size=24).astype(np.uint64)])
    vals = rng.normal(size=(N, DIM)).astype(np.float32)
    cases = _cases(cfg, _pcfg(cfg), k, vals, rng)
    sj, sp = JSink(), TelemetrySink()
    pstate = convert.state_from_arrays(state, "cpu")
    for name in ("find", "insert_or_assign", "find_or_insert", "erase"):
        run_j, run_p = cases[name]
        out = run_j(state, sj)
        state = out if isinstance(out, jtable.HKVState) else getattr(out, "state", state)
        run_p(pstate, sp)
    rj, rp = JRegistry(), PRegistry()
    rj.observe_telemetry(sj)
    rp.observe_telemetry(sp)
    assert rp.prometheus() == rj.prometheus()
    assert rp.get("hkv_op_find_calls") == 1.0


def test_ingest_delta_and_trainer_with_a_sink_as_jax():
    from repro.core import HKVTable as JTable

    rng = np.random.default_rng(4)
    keys = rng.integers(1, 2**40, size=300).astype(np.uint64)
    vals = rng.normal(size=(300, 4)).astype(np.float32)
    src_j = JTable.create(capacity=4 * 128, dim=4).insert_or_assign(keys, jnp.asarray(vals)).table
    src_p = repro_torch.HKVTable.create(capacity=4 * 128, dim=4, device="cpu")
    src_p.insert_or_assign(keys, torch.from_numpy(vals))
    sj, sp = JSink(), TelemetrySink()
    dj = jserve.publisher.export_delta(src_j)
    dp = pserve.export_delta(src_p)
    tj = jserve.publisher.ingest_delta(JTable.create(capacity=2 * 128, dim=4), dj, batch=128,
                                       telemetry=sj)
    tp = pserve.ingest_delta(repro_torch.HKVTable.create(capacity=2 * 128, dim=4, device="cpu"),
                             dp, batch=128, telemetry=sp)
    assert sp.snapshot()["ingest"]["lanes"] == len(keys)
    # the reference pads its last chunk with EMPTY lanes (no counter moves)
    assert sp.snapshot() == sj.snapshot()
    assert sp.calls["ingest"] == sj.calls["ingest"] == 3
    np.testing.assert_array_equal(convert.state_to_arrays(tp.state)["key_lo"],
                                  np.asarray(tj.state.key_lo))
    trj = jserve.OnlineTrainer(publisher=jserve.TablePublisher(src_j), telemetry=JSink())
    trp = pserve.OnlineTrainer(publisher=pserve.TablePublisher(src_p), telemetry=TelemetrySink())
    for _ in range(3):
        k = rng.integers(1, 2**40, size=64).astype(np.uint64)
        k[:16] = keys[:16]
        g = rng.normal(size=(64, 4)).astype(np.float32)
        trj.train_step(k, jnp.asarray(g))
        trp.train_step(k, torch.from_numpy(g))
    assert trp.telemetry.snapshot() == trj.telemetry.snapshot()
    assert trp.telemetry.calls == {"find_or_insert": 3}


# =============================================================================
# the seam's contract, the counter width, the building blocks
# =============================================================================


def _public_ops():
    return {name: fn for name, fn in vars(pops).items()
            if callable(fn) and not name.startswith("_") and roles.role_of(fn) is not None}


def test_every_role_annotated_op_has_the_seam_or_an_exemption():
    from repro.core import roles as jroles

    ops = _public_ops()
    assert set(ops) == {n for n, f in vars(jops).items()
                        if callable(f) and not n.startswith("_") and jroles.role_of(f)}
    for name, fn in ops.items():
        p = inspect.signature(fn).parameters.get("telemetry")
        seam = p is not None and p.default is None and p.kind is p.KEYWORD_ONLY
        if name in pops.TELEMETRY_EXEMPT:
            assert not seam, f"{name} is exempt but has grown the seam"
        else:
            assert seam, f"{name} has no keyword-only telemetry=None"
    assert set(pops.TELEMETRY_EXEMPT) <= set(ops), "an exemption names no op"
    assert all(pops.TELEMETRY_EXEMPT.values())


def test_roles_match_the_reference():
    from repro.core import roles as jroles

    for name, fn in _public_ops().items():
        assert roles.role_of(fn) == jroles.role_of(getattr(jops, name)), name
    with pytest.raises(ValueError, match="unknown op role"):
        roles.role("writer")


def test_counters_are_int64_past_two_to_the_31():
    """The reference's int32 counters wrap where a sink sums past 2**31
    (a few finds of 2**20 keys at 128 slots); the port's do not."""
    sink = TelemetrySink()
    rec = OpTelemetry.of(lanes=2**20, probed_buckets=2**21, probed_slots=2**28)
    for _ in range(12):
        sink.record("find", rec)
    d = sink.snapshot()["find"]
    assert d["probed_slots"] == 12 * 2**28 > 2**31
    assert all(v.dtype == torch.int64 for v in sink.by_op["find"])
    assert sink.by_op["find"].rates()["probes_per_query"] == 2.0
    host = obs_telemetry.host_telemetry(sink.total())
    assert int(host.probed_slots) == 12 * 2**28 and host.probed_slots.dtype == np.int64


def test_op_telemetry_algebra_and_sink():
    a = OpTelemetry.of(lanes=4, hits=3, probed_buckets=8)
    b = OpTelemetry.of(lanes=2, misses=2, probed_buckets=2)
    m = a.merge(b).to_dict()
    assert m["lanes"] == 6 and m["hits"] == 3 and m["probed_buckets"] == 10
    assert all(v == 0 for v in OpTelemetry.zero().to_dict().values())
    r = OpTelemetry.zero().rates()
    assert r["probes_per_query"] == 0.0 and r["hit_rate"] == 0.0
    assert len(OpTelemetry._fields) == 15
    sink = TelemetrySink()
    assert bool(sink)
    sink.record("find", OpTelemetry.of(lanes=4, hits=2))
    sink.record("find", OpTelemetry.of(lanes=4, hits=4))
    sink.record("erase", OpTelemetry.of(lanes=1, swept=1))
    assert sink.calls == {"find": 2, "erase": 1}
    assert sink.snapshot()["find"]["hits"] == 6
    tot = sink.total().to_dict()
    assert tot["lanes"] == 9 and tot["swept"] == 1
    motion = obs_telemetry.tier_motion(promoted=torch.tensor(3), demoted=2).to_dict()
    assert (motion["promoted"], motion["demoted"], motion["dropped"]) == (3, 2, 0)


def test_probe_counters_chunking_is_exact(monkeypatch):
    rng = np.random.default_rng(9)
    cfg, state, resident = _filled(rng, 2, 700)
    q = pu64.from_numpy_u64(np.concatenate([rng.choice(resident, 200),
                                            rng.integers(2**50, 2**60, 56).astype(np.uint64)]))
    pstate, pcfg = convert.state_from_arrays(state, "cpu"), _pcfg(cfg)
    whole = {k: int(v) for k, v in obs_telemetry.probe_counters(pstate, pcfg, q).items()}
    monkeypatch.setattr(obs_telemetry, "CHUNK", 7)
    chunked = {k: int(v) for k, v in obs_telemetry.probe_counters(pstate, pcfg, q).items()}
    assert chunked == whole
    # without the digest filter whole key rows are gathered, KEY_CHUNK lanes at a time
    nd = ptable.HKVConfig(capacity=pcfg.capacity, dim=pcfg.dim, buckets_per_key=2,
                          use_digest=False)
    whole = {k: int(v) for k, v in obs_telemetry.probe_counters(pstate, nd, q).items()}
    monkeypatch.setattr(obs_telemetry, "KEY_CHUNK", 5)
    chunked = {k: int(v) for k, v in obs_telemetry.probe_counters(pstate, nd, q).items()}
    assert chunked == whole
    sj, sp = JSink(), TelemetrySink()
    jops.find(state, jtable.HKVConfig(capacity=cfg.capacity, dim=cfg.dim, buckets_per_key=2,
                                      use_digest=False),
              ju64.from_uint64(q.numpy().view(np.uint64)), telemetry=sj)
    pops.find(pstate, nd, q, telemetry=sp)
    assert sp.snapshot() == sj.snapshot()


# =============================================================================
# The sharded table: one whole-mesh record an op, the shards' sum
# =============================================================================


def test_psum_telemetry_sums_shard_records():
    a = OpTelemetry.of(lanes=3, hits=2, probed_buckets=5, updated=1)
    b = OpTelemetry.of(lanes=4, misses=4, probed_buckets=7, rejected=2)
    got = obs_telemetry.psum_telemetry([a, b, OpTelemetry.zero()])
    assert got.to_dict() == a.merge(b).to_dict()
    assert all(v.dtype == torch.int64 for v in got)
    assert obs_telemetry.psum_telemetry([]).to_dict() == OpTelemetry.zero().to_dict()


def test_sharded_records_match_the_reference_on_one_shard():
    """insert_or_assign, find and find_or_insert on a 1-shard mesh record
    `sharded_insert_or_assign`, `sharded_find` and
    `sharded_find_or_insert` equal to the reference's (the (2, 4) mesh's
    records are held in test_torch_sharding.py), and their results are the
    same with the sink on and off."""
    import jax

    from repro.core import U64
    from repro.distributed.table_sharding import ShardedHKVTable as JSharded

    @jax.jit
    def j_ops(t, kh, kl, v, qh, ql):
        s = JSink()
        r = t.insert_or_assign(U64(kh, kl), v, telemetry=s)
        f = r.table.find(U64(qh, ql), telemetry=s)
        o = f.table.find_or_insert(U64(qh, ql), telemetry=s)
        return r.status, f.values, o.values, o.found, s.by_op

    rng = np.random.default_rng(21)
    keys = rng.integers(1, 2**63, size=4 * N).astype(np.uint64)
    q = np.concatenate([keys[:2 * N], rng.integers(1, 2**63, size=2 * N).astype(np.uint64)])
    vals = rng.normal(size=(4 * N, DIM)).astype(np.float32)
    planes = lambda k: (jnp.asarray((k >> np.uint64(32)).astype(np.uint32)),  # noqa: E731
                        jnp.asarray((k & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    jt = JSharded.create(jax.make_mesh((1,), ("d",)), capacity=2 * 128, dim=DIM)
    st, fv, ov, of, by_op = j_ops(jt, *planes(keys), jnp.asarray(vals), *planes(q))
    mesh = repro_torch.make_mesh((1,), ("d",), device="cpu")
    runs = []
    for sink in (TelemetrySink(), None):
        pt = repro_torch.ShardedHKVTable.create(mesh, capacity=2 * 128, dim=DIM)
        r = pt.insert_or_assign(keys, torch.from_numpy(vals), telemetry=sink)
        f = pt.find(q, telemetry=sink)
        o = pt.find_or_insert(q, telemetry=sink)
        runs.append((r.status, f.values, o.values, o.found, sink))
    for (got, want) in zip(runs[0][:4], (st, fv, ov, of)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(runs[0][:4], runs[1][:4]):
        assert torch.equal(a, b)
    sink = runs[0][4]
    assert set(sink.by_op) == set(by_op) == {"sharded_insert_or_assign", "sharded_find",
                                             "sharded_find_or_insert"}
    for op, tel in by_op.items():
        assert sink.by_op[op].to_dict() == {k: int(v) for k, v in tel._asdict().items()}, op
    assert sink.by_op["sharded_insert_or_assign"].to_dict()["rejected"] > 0
