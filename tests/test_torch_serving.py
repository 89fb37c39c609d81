"""The port's serving path (``repro_torch.serving``) against the JAX
package's, on the scenarios of ``tests/test_online_engine.py``.

Every scenario runs once through each package, on the same numpy keys made
from a seed; the port's tables live on the CPU.  Held bit for bit: each
request's values and found flags, each wave report but its host latency
(size, hits, hot hits, reactive demotions, table version), the sources'
offer counters, and the drained state of the table each engine serves
(every plane of every tier, the clock and the epoch).  The JAX side's cold
tier is 'hbm' wherever the port's is the default 'hmem': jax 0.9.0 refuses
the 'hmem' placement on the JAX package's sweep and training paths on the
CPU, and no result depends on the placement.  Stamped tables, which the
reference makes with `base.assign(...)`, are `base.snapshot().assign(...)`
in the port, whose tables change in place.
"""

import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serving as jserve  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serving as pserve  # noqa: E402
from repro_torch.serving import publisher as ppub  # noqa: E402

DIM = 4
WAVE = 32
PAD = 128                                  # the one prefill batch shape
FLAT = dict(capacity=4 * 128, dim=DIM)
TIER = dict(hot_capacity=128, cold_capacity=2 * 128, dim=DIM)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


class Jax:
    serving = jserve

    def flat(self, **kw):
        return jcore.HKVTable.create(**kw)

    def tiered(self, **kw):
        kw.setdefault("cold_value_tier", "hbm")   # see the module docstring
        return jcore.TieredHKVTable.create(**kw)

    def rows(self, x):
        return jnp.asarray(np.asarray(x, np.float32))

    def copy(self, t):
        return t

    def full_row(self, v, dim=DIM):
        return lambda k: jnp.full((k.hi.shape[0], dim), v, jnp.float32)

    def states(self, t):
        tiers = [t.hot, t.cold] if hasattr(t, "hot") else [t]
        return [{f: np.asarray(getattr(x.state, f)) for f in convert.FIELDS} for x in tiers]


class Port:
    serving = pserve

    def flat(self, **kw):
        return repro_torch.HKVTable.create(device="cpu", **kw)

    def tiered(self, **kw):
        return repro_torch.TieredHKVTable.create(device="cpu", **kw)

    def rows(self, x):
        return torch.as_tensor(np.asarray(x, np.float32))

    def copy(self, t):
        return t.snapshot()

    def full_row(self, v, dim=DIM):
        return lambda k: torch.full((k.shape[0], dim), v)

    def states(self, t):
        tiers = [t.hot, t.cold] if hasattr(t, "hot") else [t]
        return [convert.state_to_arrays(x.state) for x in tiers]


JAX, PORT = Jax(), Port()


def same_states(states_j, states_p, ctx):
    for i, (sj, sp) in enumerate(zip(states_j, states_p)):
        for f in convert.FIELDS:
            np.testing.assert_array_equal(sp[f], sj[f], err_msg=f"{ctx}: tier {i} {f}")


def same_tables(tj, tp, ctx):
    same_states(JAX.states(tj), PORT.states(tp), ctx)


def drained(pkg, eng):
    """Record the served table's state now: a later engine may change the
    port's table in place."""
    eng.drained = pkg.states(eng.source.snapshot()[1])
    return eng


def report_fields(rep):
    return tuple(v for k, v in rep._asdict().items() if k != "latency_s")


def same_engines(ej, ep, ctx):
    """Per-request results, wave reports, counters and the served table."""
    rj = {r.rid: r for r in ej.completed}
    rp = {r.rid: r for r in ep.completed}
    assert rj.keys() == rp.keys(), ctx
    for rid in rj:
        np.testing.assert_array_equal(rp[rid].found, rj[rid].found, err_msg=f"{ctx}: rid {rid}")
        np.testing.assert_array_equal(rp[rid].values, rj[rid].values,
                                      err_msg=f"{ctx}: rid {rid}")
        assert rp[rid].done and rj[rid].done
    assert [report_fields(r) for r in ep.reports] == [report_fields(r) for r in ej.reports], ctx
    for attr in ("offered", "rejected_offers", "published"):
        assert getattr(ep.source, attr, None) == getattr(ej.source, attr, None), (ctx, attr)
    assert ep.source.snapshot()[0] == ej.source.snapshot()[0], ctx
    same_states(ej.drained, ep.drained, ctx)
    mj, mp = ej.metrics(), ep.metrics()
    for f in ("waves", "keys", "hits", "hit_rate", "hot_rate", "reactive_demotions",
              "demotions_per_wave", "requests"):
        assert getattr(mp, f) == getattr(mj, f), (ctx, f)


def put(pkg, t, keys, vals, custom_scores=None):
    """insert_or_assign padded with EMPTY lanes to one batch shape, so that
    the JAX package compiles its upsert once a table configuration."""
    n = len(keys)
    k = np.full(PAD, EMPTY, np.uint64)
    k[:n] = keys
    v = np.zeros((PAD, np.shape(vals)[1]), np.float32)
    v[:n] = vals
    cs = None
    if custom_scores is not None:
        cs = np.zeros(PAD, np.uint64)
        cs[:n] = custom_scores
    return t.insert_or_assign(k, pkg.rows(v), custom_scores=cs).table


def both(scenario, *args, **kw):
    """Run `scenario(pkg, ...)` through both packages."""
    return scenario(JAX, *args, **kw), scenario(PORT, *args, **kw)


def cold_resident(pkg, keys):
    """A hierarchy whose `keys` live ONLY in the cold tier."""
    t = pkg.tiered(**TIER)
    cold = put(pkg, t.cold, keys, np.ones((len(keys), DIM)),
               custom_scores=np.arange(1, len(keys) + 1, dtype=np.uint64))
    return t.with_tiers(t.hot, cold)


# =============================================================================
# test_online_engine.py::TestMissPolicyMatrix
# =============================================================================

KEYS16 = np.arange(1, 17, dtype=np.uint64)


def serve_once(pkg, table, policy, promote, keys=KEYS16, **kw):
    eng = pkg.serving.OnlineEmbeddingEngine(table, wave_size=WAVE, miss_policy=policy,
                                            promote=promote, **kw)
    eng.submit(pkg.serving.EmbeddingRequest(rid=0, keys=keys.copy()))
    eng.run_until_drained()
    return drained(pkg, eng)


@pytest.mark.parametrize("case", ["readonly_pure_reader", "readonly_promote",
                                  "readonly_misses_stay_out", "admit_twice",
                                  "admit_custom_default_row"])
def test_miss_policy_matrix(case):
    def scenario(pkg):
        if case == "readonly_pure_reader":
            t = cold_resident(pkg, KEYS16)
            return [serve_once(pkg, t, "readonly", False)], t
        if case == "readonly_promote":
            t = cold_resident(pkg, KEYS16)
            return [serve_once(pkg, t, "readonly", True)], t
        if case == "admit_custom_default_row":
            t = pkg.flat(**FLAT)
            return [serve_once(pkg, t, "admit", None, default_row=pkg.full_row(2.5))], t
        policy = "readonly" if case == "readonly_misses_stay_out" else "admit"
        t = pkg.tiered(**TIER)
        e1 = serve_once(pkg, t, policy, policy == "readonly")
        return [e1, serve_once(pkg, e1.source.table, policy, policy == "readonly")], t

    (ej, tj), (ep, tp) = both(scenario)
    for i, (a, b) in enumerate(zip(ej, ep)):
        same_engines(a, b, f"{case} engine {i}")
    req = [e.completed[0] for e in ep]
    if case == "readonly_pure_reader":
        assert req[0].found.all() and ep[0].source.table is tp and ep[0].source.offered == 0
        assert not tp.hot.contains(KEYS16).any()
    elif case == "readonly_promote":
        assert req[0].found.all() and ep[0].source.offered == 1
        assert ep[0].source.table.hot.contains(KEYS16).all()
    elif case == "readonly_misses_stay_out":
        assert not req[0].found.any() and not req[1].found.any()
        assert np.all(req[0].values == 0.0)
    elif case == "admit_twice":
        assert not req[0].found.any() and req[1].found.all()
        np.testing.assert_array_equal(req[1].values, req[0].values)
    else:
        assert np.all(req[0].values == 2.5)
        assert np.all(ep[0].source.table.find(KEYS16).values.numpy() == 2.5)


# =============================================================================
# TestWavePacking and TestRequestShapes
# =============================================================================


def test_large_request_spans_waves_and_small_ones_pack():
    keys = np.arange(1, 101, dtype=np.uint64)

    def scenario(pkg):
        t = put(pkg, pkg.flat(**FLAT), keys, np.tile(keys.astype(np.float32)[:, None], (1, DIM)))
        eng = pkg.serving.OnlineEmbeddingEngine(t, wave_size=WAVE, miss_policy="readonly")
        eng.submit(pkg.serving.EmbeddingRequest(rid=0, keys=keys))
        for i in range(3):
            eng.submit(pkg.serving.EmbeddingRequest(rid=i + 1, keys=np.array([i + 1], np.uint64)))
        eng.run_until_drained()
        return drained(pkg, eng)

    ej, ep = both(scenario)
    same_engines(ej, ep, "packing")
    m = ep.metrics()
    assert m.keys == 103 and m.hits == 103 and m.waves == 4
    assert m.kv_per_s > 0 and m.p99_latency_s >= m.p50_latency_s
    big = ep.completed[[r.rid for r in ep.completed].index(0)]
    assert big.values.dtype == np.float32 and big.values.shape == (100, DIM)
    np.testing.assert_array_equal(big.values[:, 0], keys.astype(np.float32))


@pytest.mark.parametrize("policy", ["readonly", "admit"])
@pytest.mark.parametrize("admission", ["wave", "continuous"])
def test_spanning_and_empty_requests(policy, admission):
    keys = np.arange(1, 101, dtype=np.uint64)
    present = keys[::2]

    def scenario(pkg):
        t = put(pkg, pkg.flat(**FLAT), present,
                np.tile(present.astype(np.float32)[:, None], (1, DIM)))
        eng = pkg.serving.OnlineEmbeddingEngine(t, wave_size=WAVE, miss_policy=policy,
                                                admission=admission)
        eng.submit(pkg.serving.EmbeddingRequest(rid=0, keys=keys))
        eng.submit(pkg.serving.EmbeddingRequest(rid=1, keys=np.zeros(0, np.uint64)))
        eng.run_until_drained()
        return drained(pkg, eng)

    ej, ep = both(scenario)
    same_engines(ej, ep, f"{policy}/{admission}")
    assert ep.idle
    done = {r.rid: r for r in ep.completed}
    assert done[1].values.shape == (0, DIM) and done[1].found.shape == (0,)
    np.testing.assert_array_equal(done[0].found, np.isin(keys, present))
    assert ep.metrics().keys == 100
    if policy == "admit":
        assert ep.source.table.contains(keys).all()


@pytest.mark.parametrize("admission", ["wave", "continuous"])
def test_zero_length_only_completes_without_a_launch(admission):
    for pkg in (JAX, PORT):
        eng = pkg.serving.OnlineEmbeddingEngine(pkg.flat(**FLAT), wave_size=WAVE,
                                                admission=admission)
        req = pkg.serving.EmbeddingRequest(rid=0, keys=np.zeros(0, np.uint64))
        eng.submit(req)
        eng.run_until_drained()
        assert req.done and req.values.shape == (0, DIM) and req.found.shape == (0,)
        assert not eng.reports and eng.idle


# =============================================================================
# TestContinuousAdmission: per-request results against wave mode
# =============================================================================


def test_continuous_admission_matches_wave_mode_and_the_reference():
    rng = np.random.default_rng(9)
    reqs = [rng.integers(1, 3 * 512, size=rng.integers(1, 80)).astype(np.uint64)
            for _ in range(12)]

    def scenario(pkg, admission):
        eng = pkg.serving.OnlineEmbeddingEngine(
            pkg.flat(buckets_per_key=2, **FLAT), wave_size=WAVE,
            miss_policy="admit", admission=admission)
        for i, k in enumerate(reqs):
            eng.submit(pkg.serving.EmbeddingRequest(rid=i, keys=k.copy()))
        eng.run_until_drained()
        return drained(pkg, eng)

    # identical FIFO packing: identical waves, so the reference's wave mode
    # is the reference for both of the port's modes
    jw = scenario(JAX, "wave")
    for admission in ("wave", "continuous"):
        same_engines(jw, scenario(PORT, admission), f"port {admission} vs jax wave")


def test_submit_dispatches_filled_waves_and_poll_reaps():
    t = PORT.flat(**FLAT)
    eng = pserve.OnlineEmbeddingEngine(t, wave_size=WAVE, miss_policy="admit",
                                       admission="continuous")
    eng.submit(pserve.EmbeddingRequest(rid=0, keys=np.arange(1, 101, dtype=np.uint64)))
    assert len(eng._flights) == 3 and eng._stage_used == 4 and not eng.idle
    assert eng.depth_at_dispatch == [0, 1, 2]
    rep = eng.poll()                        # a CPU wave is ready when it returns
    assert rep is not None and not eng._flights and len(eng.reports) == 3
    assert eng.poll() is None and eng._stage_used == 4
    eng.run_until_drained()
    assert eng.completed[0].done and len(eng.reports) == 4 and eng.idle
    m = eng.metrics()
    r = eng.completed[0]
    assert m.requests == 1 and r.t_submit <= r.t_admit <= r.t_done
    assert abs(r.total_latency_s - (r.queue_wait_s + r.service_s)) < 1e-9
    req = pserve.EmbeddingRequest(rid=1, keys=np.arange(1, 17, dtype=np.uint64))
    req.t_submit = 123.456
    eng.submit(req)
    eng.run_until_drained()
    assert req.t_submit == 123.456 and req.found.all()


# =============================================================================
# TestPublisherAtomicity and TestStaticSource
# =============================================================================


def test_static_source_and_publisher_compare_and_swap():
    keys = np.arange(1, 5, dtype=np.uint64)

    def scenario(pkg):
        t = pkg.flat(**FLAT)
        out = []
        for make in (pkg.serving.StaticSource, pkg.serving.TablePublisher):
            s = make(t)
            v0, t0 = s.snapshot()
            assert v0 == 0 and t0 is t
            t1 = put(pkg, pkg.copy(t), keys, np.ones((4, DIM)))
            if isinstance(s, pkg.serving.TablePublisher):
                assert s.publish(t1) == 1       # the trainer wins races
            else:
                assert s.offer(v0, t1)
            stale = put(pkg, pkg.copy(t), keys, np.full((4, DIM), 9.0))
            assert not s.offer(v0, stale)       # stale: rejected
            assert s.table is t1 and s.snapshot()[0] == 1
            v, _ = s.snapshot()
            assert s.offer(v, stale) and s.snapshot()[0] == 2
            out.append((s.offered, s.rejected_offers, getattr(s, "published", None),
                        pkg.states(s.table)))
        return out

    got_j, got_p = both(scenario)
    for j, p in zip(got_j, got_p):
        assert j[:3] == p[:3]
        same_states(j[3], p[3], "the source's table")


def test_reader_never_observes_a_half_published_table():
    """Stamped tables (version i holds value i in every row), made with
    snapshot(); racing reader threads must see one stamp per find, equal
    to the version they read."""
    keys = np.arange(1, 33, dtype=np.uint64)
    base = PORT.flat(**FLAT)
    base.insert_or_assign(keys, torch.zeros((len(keys), DIM)))
    stamped = [base] + [base.snapshot().assign(keys, torch.full((len(keys), DIM), float(i)))
                        for i in range(1, 12)]
    pub = pserve.TablePublisher(stamped[0])
    stop, torn = threading.Event(), []

    def reader():
        while not stop.is_set():
            version, t = pub.snapshot()
            uniq = np.unique(t.find(keys).values.numpy())
            if len(uniq) != 1 or int(uniq[0]) != version:
                torn.append((version, uniq))

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    for i in range(1, 12):
        assert pub.publish(stamped[i]) == i
    stop.set()
    for th in threads:
        th.join()
    assert not torn, torn[:3]
    assert pub.version == 11


def test_engine_waves_never_mix_versions():
    keys = np.arange(1, 17, dtype=np.uint64)

    def scenario(pkg):
        base = put(pkg, pkg.flat(**FLAT), keys, np.zeros((16, DIM)))
        pub = pkg.serving.TablePublisher(base)
        eng = pkg.serving.OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="readonly")
        for i in range(5):
            eng.submit(pkg.serving.EmbeddingRequest(rid=i, keys=keys.copy()))
            eng.step()
            pub.publish(put(pkg, pkg.copy(base), keys, np.full((16, DIM), float(i + 1))))
        return drained(pkg, eng)

    ej, ep = both(scenario)
    same_engines(ej, ep, "stamped")
    for i, (req, rep) in enumerate(zip(ep.completed, ep.reports)):
        stamps = np.unique(req.values)
        assert len(stamps) == 1 and int(stamps[0]) == rep.table_version == i


# =============================================================================
# TestTrainerAndDelta
# =============================================================================


def test_trainer_updates_are_visible_to_the_engine():
    keys = np.arange(1, WAVE + 1, dtype=np.uint64)

    def scenario(pkg):
        pub = pkg.serving.TablePublisher(pkg.flat(**FLAT))
        tr = pkg.serving.OnlineTrainer(publisher=pub, publish_every=1, lr=0.5)
        for _ in range(3):
            tr.train_step(keys, np.ones((len(keys), DIM), np.float32))
        eng = pkg.serving.OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="readonly")
        eng.submit(pkg.serving.EmbeddingRequest(rid=0, keys=keys))
        eng.run_until_drained()
        return drained(pkg, eng), tr

    (ej, tj), (ep, tp) = both(scenario)
    same_engines(ej, ep, "trainer")
    same_tables(tj.table, tp.table, "trainer's own table")
    req = ep.completed[0]
    assert req.found.all() and np.all(req.values == -1.5)   # 3 steps * lr .5 * grad 1


def test_trainer_double_buffer():
    """The trainer's table is never the served object; after a publish it
    trains on a copy of what it published, in the planes of the table
    served before, so two tables alternate; the engine's admissions on the
    served table are dropped at the next publish, as the reference drops
    them; and a wave serves exactly what was published."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(1, 2**64 - 1, size=WAVE, dtype=np.uint64) for _ in range(6)]

    def scenario(pkg):
        t = pkg.tiered(**TIER)
        pub = pkg.serving.TablePublisher(t)
        tr = pkg.serving.OnlineTrainer(publisher=pub, publish_every=2, lr=0.25)
        eng = pkg.serving.OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="admit")
        served = []
        for i, kb in enumerate(batches):
            eng.submit(pkg.serving.EmbeddingRequest(rid=i, keys=kb))
            eng.step()
            tr.train_step(batches[(i + 3) % 6], np.full((WAVE, DIM), 0.5, np.float32))
            served.append(pub.table)
        return drained(pkg, eng), tr, served

    (ej, tj, _), (ep, tp, served) = both(scenario)
    same_engines(ej, ep, "double buffer")
    same_tables(tj.table, tp.table, "trainer's table")
    assert ep.source.published == 3
    ptrs = [s.hot.state.keys.data_ptr() for s in served]
    assert tp.table.hot.state.keys.data_ptr() not in (ptrs[-1],)
    assert len(set(ptrs)) == 2                      # two tables alternate
    assert tp.table.cold.state.values.data_ptr() != served[-1].cold.state.values.data_ptr()


def test_trainer_never_writes_a_table_a_reader_thread_holds():
    """A reader on another thread holds the table it snapshotted; the
    trainer's publishes leave it as it was (the trainer goes on on a fresh
    snapshot taken before the swap, not in the old table's planes), and
    that thread's admitting waves never reach the trainer's table.  A
    trainer refuses to be built while another thread reads."""
    rng = np.random.default_rng(7)
    keys = rng.integers(1, 2**64 - 1, size=WAVE, dtype=np.uint64)
    fresh = rng.integers(1, 2**64 - 1, size=WAVE, dtype=np.uint64)
    base = PORT.tiered(**TIER)
    base.insert_or_assign(keys, torch.ones((WAVE, DIM)))
    pub = pserve.TablePublisher(base)
    tr = pserve.OnlineTrainer(publisher=pub, publish_every=1, lr=0.5)
    held, ready, published, waved = [], threading.Event(), threading.Event(), threading.Event()

    def reader():
        version, t = pub.snapshot()
        held.append((version, t, t.find(keys, promote=False).values.clone()))
        ready.set()
        assert published.wait(60)
        held.append(t.find(keys, promote=False).values.clone())
        eng = pserve.OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="admit")
        eng.submit(pserve.EmbeddingRequest(rid=0, keys=fresh))
        eng.run_until_drained()
        waved.set()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        assert ready.wait(60)
        assert not pub.only_reader()
        with pytest.raises(RuntimeError, match="another thread"):
            pserve.OnlineTrainer(publisher=pub)
        version, t, before = held[0]
        for _ in range(3):
            tr.train_step(keys, np.ones((WAVE, DIM), np.float32))
            assert tr.table is not pub.table
            for mine, served in ((tr.table.hot, t.hot), (tr.table.cold, t.cold)):
                assert mine.state.values.data_ptr() != served.state.values.data_ptr()
    finally:
        published.set()
    assert waved.wait(60)
    th.join()
    assert version == 0 and pub.version == 4
    torch.testing.assert_close(held[1], before, rtol=0, atol=0)
    assert torch.equal(before, torch.ones((WAVE, DIM)))
    assert pub.table.contains(fresh).all()            # the wave admitted them
    assert not tr.table.contains(fresh).any()         # the trainer never saw them
    np.testing.assert_array_equal(
        tr.table.find(keys, promote=False).values.numpy(), np.full((WAVE, DIM), -0.5))


def test_trainer_refuses_telemetry():
    """The trainer and ingest_delta refused a sink until the op telemetry
    channel was ported; they now thread it to their admission ops
    (held against the JAX package in tests/test_torch_telemetry.py)."""
    from repro_torch.obs import TelemetrySink

    pub = pserve.TablePublisher(PORT.flat(capacity=128, dim=DIM))
    sink = TelemetrySink()
    tr = pserve.OnlineTrainer(publisher=pub, telemetry=sink)
    tr.train_step(np.arange(1, 9, dtype=np.uint64), torch.ones(8, DIM))
    assert sink.calls == {"find_or_insert": 1} and sink.snapshot()["find_or_insert"]["lanes"] == 8
    pserve.ingest_delta(PORT.flat(capacity=128, dim=DIM), pserve.export_delta(tr.table),
                        telemetry=sink)
    assert sink.snapshot()["ingest"]["lanes"] == 8


@pytest.mark.parametrize("src", ["flat", "tiered"])
def test_export_ingest_delta_roundtrip(src):
    keys = np.arange(1, PAD + 1, dtype=np.uint64)
    keys[::3] |= np.uint64(1 << 63)              # keys at or above 2**63 too
    vals = np.tile(np.arange(1, PAD + 1, dtype=np.float32)[:, None], (1, DIM))

    def scenario(pkg):
        t = pkg.flat(**FLAT) if src == "flat" else pkg.tiered(**TIER)
        t = put(pkg, t, keys, vals)
        if src == "tiered":     # past the hot tier: some keys live cold only
            t = put(pkg, t, keys + np.uint64(PAD), vals)
        delta = pkg.serving.export_delta(t, chunk_buckets=1)
        return delta, pkg.serving.ingest_delta(pkg.flat(**FLAT), delta, batch=WAVE)

    (dj, tj), (dp, tp) = both(scenario)
    for f in ("keys", "values", "scores"):
        assert getattr(dp, f).dtype == getattr(dj, f).dtype
        np.testing.assert_array_equal(getattr(dp, f), getattr(dj, f), err_msg=f)
    assert dp.count == (PAD if src == "flat" else 2 * PAD)
    same_tables(tj, tp, "ingested")
    f = tp.find(keys)
    assert f.found.all()
    np.testing.assert_array_equal(f.values.numpy(), vals)


def test_delta_carry_scores_into_custom_policy():
    keys = np.arange(1, 17, dtype=np.uint64)
    scores = keys * np.uint64(10)

    def scenario(pkg):
        t = put(pkg, pkg.flat(score_policy="custom", **FLAT), keys, np.ones((16, DIM)),
                custom_scores=scores)
        delta = pkg.serving.export_delta(t)
        dst = pkg.serving.ingest_delta(pkg.flat(score_policy="custom", **FLAT), delta,
                                       batch=WAVE, carry_scores=True)
        tiered = pkg.serving.ingest_delta(pkg.tiered(score_policy="custom", **TIER), delta,
                                          batch=WAVE, carry_scores=True)
        return delta, dst, tiered, pkg.serving.export_delta(tiered)

    (dj, fj, tj, ej), (dp, fp, tp, ep) = both(scenario)
    np.testing.assert_array_equal(dp.scores, dj.scores)
    np.testing.assert_array_equal(np.sort(dp.scores), np.sort(scores))
    same_tables(fj, fp, "flat custom")
    same_tables(tj, tp, "tiered custom")
    np.testing.assert_array_equal(ep.scores, ej.scores)
    np.testing.assert_array_equal(np.sort(ep.scores), np.sort(scores))
    assert tp.contains(keys).all()


# =============================================================================
# TestAuxColumnContract and TestWaveFnRebuild
# =============================================================================

KEYS32 = np.arange(1, 33, dtype=np.uint64)


@pytest.mark.parametrize("kind", ["flat", "tiered", "flat_readonly"])
def test_dim_wide_rows_on_aux_tables(kind):
    def scenario(pkg):
        if kind == "tiered":
            t = pkg.tiered(aux_value_dim=1, **TIER)
        else:
            t = pkg.flat(aux_value_dim=1, **FLAT)
        if kind == "flat_readonly":
            t = t.find_or_insert(KEYS32, pkg.rows(np.ones((32, DIM)))).table
            return [serve_once(pkg, t, "readonly", None, keys=KEYS32)]
        e1 = serve_once(pkg, t, "admit", None, keys=KEYS32)
        return [e1, serve_once(pkg, e1.source.table, "admit", None, keys=KEYS32)]

    ej, ep = both(scenario)
    for i, (a, b) in enumerate(zip(ej, ep)):
        same_engines(a, b, f"{kind} engine {i}")
    for e in ep:
        assert e.completed[0].values.shape == (32, DIM)
    assert ep[-1].completed[0].found.all()
    total = getattr(ep[-1].source.table, "hot", ep[-1].source.table)
    assert total.cfg.total_value_dim == DIM + 1


def test_wave_function_rebuilds_on_a_signature_change():
    def scenario(pkg):
        flat = put(pkg, pkg.flat(**FLAT), KEYS16, np.ones((16, DIM)))
        pub = pkg.serving.TablePublisher(flat)
        eng = pkg.serving.OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="readonly",
                                                promote=True)
        eng.submit(pkg.serving.EmbeddingRequest(rid=0, keys=KEYS16.copy()))
        eng.step()
        offered = [pub.offered]
        pub.publish(cold_resident(pkg, KEYS16))        # flat -> tiered
        eng.submit(pkg.serving.EmbeddingRequest(rid=1, keys=KEYS16.copy()))
        eng.step()
        offered.append(pub.offered)
        pub.publish(put(pkg, pkg.flat(capacity=4 * 128, dim=2 * DIM), KEYS16,
                        np.full((16, 2 * DIM), 3.0)))                  # dim change
        eng.submit(pkg.serving.EmbeddingRequest(rid=2, keys=KEYS16.copy()))
        eng.step()
        return drained(pkg, eng), offered

    (ej, oj), (ep, op) = both(scenario)
    same_engines(ej, ep, "rebuild")
    assert op == oj == [0, 1]                  # flat + promote is a pure read
    r = {q.rid: q for q in ep.completed}
    assert r[1].found.all() and np.all(r[1].values == 1.0)
    assert r[2].values.shape == (16, 2 * DIM) and np.all(r[2].values == 3.0)


def test_engine_refuses_tables_it_does_not_serve():
    eng = pserve.OnlineEmbeddingEngine(ppub.StaticSource(object()), wave_size=4)
    eng.submit(pserve.EmbeddingRequest(rid=0, keys=np.arange(1, 3, dtype=np.uint64)))
    with pytest.raises(NotImplementedError, match="ShardedHKVTable; not object"):
        eng.step()


# =============================================================================
# The engine over a sharded table (a 1-shard mesh)
# =============================================================================


@functools.lru_cache(maxsize=None)
def _jax_sharded_ops():
    """The reference's sharded handle with the ops its engine calls, and
    the prefill, jitted: its engine calls them eagerly, and eager
    shard_map compiles on every call (tens of seconds on the CPU)."""
    import dataclasses

    import jax

    from repro.distributed import table_sharding as jts

    foi = jax.jit(lambda t, kh, kl: (lambda r: (r.table, r.values, r.found, r.overflow))(
        t.find_or_insert(jcore.U64(kh, kl))))
    find = jax.jit(lambda t, kh, kl: (lambda r: (r.table, r.values, r.found, r.overflow))(
        t.find(jcore.U64(kh, kl), promote=False)))
    put = jax.jit(lambda t, kh, kl, v: t.insert_or_assign(jcore.U64(kh, kl), v).table)

    @dataclasses.dataclass(frozen=True)
    class JitSharded(jts.ShardedHKVTable):
        def _base(self):
            return jts.ShardedHKVTable(state=self.state, semb=self.semb, mesh=self.mesh)

        def find_or_insert(self, keys, *, telemetry=None):
            t, v, f, o = foi(self._base(), keys.hi, keys.lo)
            return jts.ShardedFindOrInsert(table=self.with_state(t.state), values=v, found=f,
                                           overflow=o)

        def find(self, keys, *, promote=True, telemetry=None):
            assert not promote            # flat shards: a promotion is a pure read
            t, v, f, o = find(self._base(), keys.hi, keys.lo)
            return jts.ShardedFind(values=v, found=f, overflow=o, table=self.with_state(t.state))

    def make(keys, vals):
        t = jts.ShardedHKVTable.create(jax.make_mesh((1,), ("d",)), capacity=4 * 128, dim=DIM)
        t = put(t, *_planes(keys), jnp.asarray(vals))
        return JitSharded(state=t.state, semb=t.semb, mesh=t.mesh)

    return make


def _planes(keys):
    keys = np.asarray(keys, np.uint64)
    return (jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("admission", ["wave", "continuous"])
@pytest.mark.parametrize("policy", ["admit", "readonly"])
def test_engine_over_a_sharded_table_matches_the_reference(policy, admission):
    """Admission runs the owners' find_or_insert (their own init rows), a
    readonly wave the pure-reader find; per-request values and found
    flags, wave reports, counters and the drained shards as the
    reference's."""
    rng = np.random.default_rng(7)
    resident = rng.integers(1, 2**63, size=PAD).astype(np.uint64)
    vals = rng.normal(size=(PAD, DIM)).astype(np.float32)
    reqs = [np.concatenate([resident[i * 20:(i + 1) * 20],
                            rng.integers(1, 2**63, size=15 + 7 * i).astype(np.uint64)])
            for i in range(4)]
    reqs[2][:5] = reqs[0][20:25]                       # keys admitted by request 0

    def scenario(pkg):
        if pkg is JAX:
            t = _jax_sharded_ops()(resident, vals)
        else:
            t = repro_torch.ShardedHKVTable.create(
                repro_torch.make_mesh((1,), ("d",), device="cpu"), capacity=4 * 128, dim=DIM)
            t.insert_or_assign(resident, torch.from_numpy(vals))
        eng = pkg.serving.OnlineEmbeddingEngine(t, wave_size=WAVE, miss_policy=policy,
                                                admission=admission)
        for rid, keys in enumerate(reqs):
            eng.submit(pkg.serving.EmbeddingRequest(rid=rid, keys=keys.copy()))
        eng.run_until_drained()
        served = eng.source.snapshot()[1]
        eng.drained = ([{f: np.asarray(getattr(served.state, f)) for f in convert.FIELDS}]
                       if pkg is JAX else [convert.sharded_state_to_arrays(served.state)])
        return eng

    ej, ep = both(scenario)
    same_engines(ej, ep, f"sharded {policy} {admission}")
    found = np.concatenate([r.found for r in sorted(ep.completed, key=lambda r: r.rid)])
    assert found.any() and not found.all()
    if policy == "admit":
        assert ep.completed[2].found[:5].all() and ep.source.offered > 0
    else:
        assert ep.source.offered == 0
