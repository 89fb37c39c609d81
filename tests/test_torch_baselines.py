"""The port's dictionary baselines (``repro_torch.baselines``) against the
JAX package's (``repro.baselines``).

The same numpy keys and values, made from a seed, go through
`OpenAddressingTable`, `BucketedP2CTable` and the `DictKVTable` handle of
both packages, the port's on the CPU.  Held bit for bit after every op:
the drained state (keys and values, carried across by
``repro_torch.convert``), `ok`, `probes`, found flags and values, sweep
masks, swept counts, rank rows and eviction streams, stats, exports.
Batches hold EMPTY padding and repeated keys (the raw insert resolves a
repeated key's value by the batch's last writer, as the reference's scatter
does on the CPU); open addressing's erase leaves tombstones; capacities
that are not powers of two take the modulus.  The last three tests are
``tests/test_baselines.py``'s, on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.baselines import dict_tables as J  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.core.predicates import SweepPredicate as JPred  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.baselines import (BucketedP2CTable, DictKVTable,  # noqa: E402
                                   OpenAddressingTable)
from repro_torch.baselines import dict_tables as P  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.core.predicates import SweepPredicate as PPred  # noqa: E402

DIM = 2
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def _same_state(sj, sp, ctx):
    got = convert.dict_state_to_arrays(sp)
    for f in ("key_hi", "key_lo", "values"):
        _eq(got[f], getattr(sj, f), f"{ctx}: {f}")


def _keys(rng, n, space=3000):
    k = rng.integers(0, space, size=n).astype(np.uint64)
    k[rng.integers(0, n, size=3)] = EMPTY
    k[:4] = k[4:8]                         # repeated keys in the batch
    return k


IMPLS = [
    ("oa", J.OpenAddressingTable, OpenAddressingTable, convert.oa_state_from_arrays, 512),
    ("oa", J.OpenAddressingTable, OpenAddressingTable, convert.oa_state_from_arrays, 500),
    ("p2c", J.BucketedP2CTable, BucketedP2CTable, convert.p2c_state_from_arrays, 512),
    ("p2c", J.BucketedP2CTable, BucketedP2CTable, convert.p2c_state_from_arrays, 496),
]


@pytest.mark.parametrize("kind,jcls,pcls,to_port,cap", IMPLS,
                         ids=[f"{i[0]}-{i[4]}" for i in IMPLS])
def test_impl_ops_match_jax(kind, jcls, pcls, to_port, cap):
    rng = np.random.default_rng(cap)
    tj, tp = jcls(capacity=cap, dim=DIM), pcls(capacity=cap, dim=DIM)
    sj, sp = tj.create(), tp.create("cpu")
    _same_state(sj, sp, "create")
    for step in range(3):
        ctx = f"{kind} cap {cap} step {step}"
        k = _keys(rng, 260)
        v = rng.normal(size=(260, DIM)).astype(np.float32)
        rj = tj.insert(sj, ju64.from_uint64(k), jnp.asarray(v))
        rp = tp.insert(sp, pu64.from_numpy_u64(k), torch.from_numpy(v))
        sj = rj.state
        _same_state(sj, sp, f"{ctx} insert")
        _eq(rp.ok, rj.ok, f"{ctx} insert ok")
        _eq(rp.probes, rj.probes, f"{ctx} insert probes")
        q = _keys(rng, 128)
        fj, fp = tj.find(sj, ju64.from_uint64(q)), tp.find(sp, pu64.from_numpy_u64(q))
        for f in ("values", "found", "probes"):
            _eq(getattr(fp, f), getattr(fj, f), f"{ctx} find {f}")
        a = _keys(rng, 64)
        av = rng.normal(size=(64, DIM)).astype(np.float32)
        sj = tj.assign(sj, ju64.from_uint64(a), jnp.asarray(av))
        tp.assign(sp, pu64.from_numpy_u64(a), torch.from_numpy(av))
        _same_state(sj, sp, f"{ctx} assign")
        e = _keys(rng, 64)
        sj = tj.erase(sj, ju64.from_uint64(e))
        tp.erase(sp, pu64.from_numpy_u64(e))
        _same_state(sj, sp, f"{ctx} erase")
    if kind == "oa":
        assert (convert.dict_state_to_arrays(sp)["key_lo"] == 0xFFFFFFFE).any(), "no tombstone"
    lo, hi = 200, 1400
    mj = tj.sweep_mask(sj, JPred.key_in_range(lo, hi))
    mp = tp.sweep_mask(sp, PPred.key_in_range(lo, hi))
    _eq(mp, mj, f"{kind} sweep_mask")
    rows_j, lane_j = tj.rank_rows(sj, mj, 40)
    rows_p, lane_p = tp.rank_rows(sp, mp, 40)
    _eq(lane_p, lane_j, f"{kind} rank_rows lanes")
    # the rank order is ascending key; the raw inserts above placed some
    # repeated keys twice (in both packages), and the reference's unstable
    # sort orders such a tie either way: the keys in rank order and the
    # set of rows are held
    lane = lane_p.numpy()
    rows_p, rows_j = rows_p.numpy()[lane], np.asarray(rows_j)[np.asarray(lane_j)]
    flat = convert.dict_state_to_arrays(sp)
    _eq(flat["key_lo"].reshape(-1)[rows_p], flat["key_lo"].reshape(-1)[rows_j],
        f"{kind} rank_rows keys")
    _eq(np.sort(rows_p), np.sort(rows_j), f"{kind} rank_rows rows")
    sj = tj.erase_mask(sj, mj)
    tp.erase_mask(sp, mp)
    _same_state(sj, sp, f"{kind} erase_mask")
    # a JAX state carried across takes the same ops
    sp2 = to_port(sj, "cpu")
    _same_state(sj, sp2, f"{kind} carried across")


def _handles(kind, cap):
    if kind == "oa":
        return J.DictKVTable.open_addressing(cap, DIM), DictKVTable.open_addressing(
            cap, DIM, device="cpu")
    return J.DictKVTable.bucketed_p2c(cap, DIM), DictKVTable.bucketed_p2c(cap, DIM, device="cpu")


def _stream_eq(sj, sp, ctx):
    got = convert.stream_to_arrays(sp)
    for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
        _eq(got[f], getattr(sj, f), f"{ctx}: {f}")


@pytest.mark.parametrize("kind,cap", [("oa", 512), ("p2c", 496)])
def test_dict_handle_matches_jax(kind, cap):
    rng = np.random.default_rng(7)
    tj, tp = _handles(kind, cap)
    for step in range(2):
        ctx = f"{kind} step {step}"
        k = _keys(rng, 300)
        v = rng.normal(size=(300, DIM)).astype(np.float32)
        rj = tj.insert_or_assign(k, jnp.asarray(v))
        rp = tp.insert_or_assign(k, torch.from_numpy(v))
        tj = rj.table
        assert rp.table is tp
        _same_state(tj.state, tp.state, f"{ctx} insert_or_assign")
        _eq(rp.ok, rj.ok, f"{ctx} ok")
        _eq(rp.probes, rj.probes, f"{ctx} probes")
        q = _keys(rng, 128)
        init = rng.normal(size=(128, DIM)).astype(np.float32)
        fj = tj.find_or_insert(q, jnp.asarray(init))
        fp = tp.find_or_insert(q, torch.from_numpy(init))
        tj = fj.table
        for f in ("values", "found", "ok", "probes"):
            _eq(getattr(fp, f), getattr(fj, f), f"{ctx} find_or_insert {f}")
        _same_state(tj.state, tp.state, f"{ctx} find_or_insert")
        a = _keys(rng, 64)
        av = rng.normal(size=(64, DIM)).astype(np.float32)
        tj = tj.assign(a, jnp.asarray(av))
        tp.assign(a, torch.from_numpy(av))
        tj = tj.erase(a[::2].copy())
        tp.erase(a[::2].copy())
        _same_state(tj.state, tp.state, f"{ctx} assign, erase")
        _eq(tp.contains(q), tj.contains(q), f"{ctx} contains")
        f1, f2 = tj.find(q), tp.find(q)
        _eq(f2.values, f1.values, f"{ctx} find values")
        assert tp.size() == int(tj.size())
        # the reference divides in float32
        assert np.float32(tp.size()) / np.float32(tp.capacity) == np.float32(tj.load_factor())
    sw_j = tj.erase_if(JPred.key_in_range(0, 900))
    sw_p = tp.erase_if(PPred.key_in_range(0, 900))
    tj = sw_j.table
    assert int(sw_p.swept) == int(sw_j.swept) > 0
    _same_state(tj.state, tp.state, f"{kind} erase_if")
    ev_j = tj.evict_if(JPred.always(), 24)
    ev_p = tp.evict_if(PPred.always(), 24)
    tj = ev_j.table
    assert int(ev_p.count) == int(ev_j.count) == 24
    _stream_eq(ev_j.evicted, ev_p.evicted, f"{kind} evict_if stream")
    _same_state(tj.state, tp.state, f"{kind} evict_if")
    st_j, st_p = tj.stats(), tp.stats()
    assert int(st_p.size) == int(st_j.size)
    _eq(st_p.occupancy_hist, st_j.occupancy_hist, f"{kind} stats hist")
    assert tp.num_buckets == tj.num_buckets
    for b in range(tp.num_buckets):
        ej, ep = tj.export_batch(b, 1), tp.export_batch(b, 1)
        got = convert.export_to_arrays(ep)
        for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
            _eq(got[f], getattr(ej, f), f"{kind} export bucket {b} {f}")
    tj, tp = tj.clear(), tp.clear()
    assert tp.size() == int(tj.size()) == 0
    _same_state(tj.state, tp.state, f"{kind} clear")


def test_raw_insert_resolves_repeated_keys_by_the_last_writer():
    k = np.array([5, 9, 5, 5, 9, 11], np.uint64)
    v = np.arange(12, dtype=np.float32).reshape(6, 2)
    for jcls, pcls in ((J.OpenAddressingTable, OpenAddressingTable),
                       (J.BucketedP2CTable, BucketedP2CTable)):
        tj, tp = jcls(capacity=256, dim=2), pcls(capacity=256, dim=2)
        sj = tj.insert(tj.create(), ju64.from_uint64(k[:1]), jnp.zeros((1, 2))).state
        sp = tp.insert(tp.create("cpu"), pu64.from_numpy_u64(k[:1]), torch.zeros(1, 2)).state
        sj = tj.insert(sj, ju64.from_uint64(k), jnp.asarray(v)).state   # 5 hits, written thrice
        tp.insert(sp, pu64.from_numpy_u64(k), torch.from_numpy(v))
        _same_state(sj, sp, jcls.__name__)
        f = tp.find(sp, pu64.from_numpy_u64(np.array([5], np.uint64)))
        np.testing.assert_array_equal(f.values.numpy(), v[3:4])


def test_create_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DictKVTable.open_addressing(256, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BucketedP2CTable(capacity=256, dim=2).create()
    assert P.TOMB == -2


# =============================================================================
# tests/test_baselines.py's cases on the port
# =============================================================================


@pytest.mark.parametrize("cls", [OpenAddressingTable, BucketedP2CTable])
def test_dictionary_semantics_fail_at_capacity(cls):
    """Dictionary tables cannot absorb more keys than capacity: inserts
    FAIL rather than evict."""
    rng = np.random.default_rng(1)
    t = cls(capacity=512, dim=1)
    keys = rng.permutation(10_000_000)[: 2 * 512].astype(np.uint64)
    rep = t.insert(t.create("cpu"), pu64.from_numpy_u64(keys), torch.zeros(1024, 1))
    ok = rep.ok.numpy()
    assert ok.sum() < 1024 and ok.sum() <= 512


def test_open_addressing_probe_growth():
    """Probe distance grows super-linearly with λ (HKV's stays flat)."""
    rng = np.random.default_rng(2)
    t = OpenAddressingTable(capacity=4096, dim=1)
    st = t.create("cpu")
    probes_at, inserted = {}, []
    for lam in (0.25, 0.5, 0.85, 0.95):
        target = int(lam * 4096)
        while len(inserted) < target:
            k = rng.permutation(10_000_000)[: target - len(inserted)].astype(np.uint64)
            rep = t.insert(st, pu64.from_numpy_u64(k), torch.zeros(len(k), 1))
            inserted.extend(k[rep.ok.numpy()].tolist())
        sample = np.array(inserted, np.uint64)[rng.integers(0, len(inserted), size=256)]
        probes_at[lam] = float(t.find(st, pu64.from_numpy_u64(sample)).probes.double().mean())
    assert probes_at[0.95] > probes_at[0.5] > 0
    assert probes_at[0.95] > 2.0
    assert probes_at[0.25] < 1.5


def test_p2c_both_buckets_bounded_probes():
    rng = np.random.default_rng(3)
    t = BucketedP2CTable(capacity=1024, dim=2)
    keys = rng.permutation(10_000_000)[:900].astype(np.uint64)
    st = t.insert(t.create("cpu"), pu64.from_numpy_u64(keys), torch.zeros(900, 2)).state
    assert int(t.find(st, pu64.from_numpy_u64(keys)).probes.max()) <= 2


@pytest.mark.parametrize("kind", ["open_addressing", "bucketed_p2c"])
def test_engine_serves_a_dict_table_as_jax(kind):
    """The serving engine over a DictKVTable (admit policy): per-request
    values and found flags, wave reports and the served table equal the
    JAX package's engine's."""
    import repro.serving as jserve
    from repro_torch import serving as pserve

    rng = np.random.default_rng(19)
    engines = (jserve.OnlineEmbeddingEngine(getattr(J.DictKVTable, kind)(256, 4), wave_size=32),
               pserve.OnlineEmbeddingEngine(getattr(DictKVTable, kind)(256, 4, device="cpu"),
                                            wave_size=32))
    for rid in range(6):
        keys = rng.integers(0, 400, size=int(rng.integers(1, 40))).astype(np.uint64)
        for eng, req in zip(engines, (jserve.EmbeddingRequest, pserve.EmbeddingRequest)):
            eng.submit(req(rid=rid, keys=keys))
    for eng in engines:
        eng.run_until_drained()
    (ej, ep) = engines
    rj, rp = {r.rid: r for r in ej.completed}, {r.rid: r for r in ep.completed}
    assert rj.keys() == rp.keys() and len(rp) == 6
    for rid in rj:
        _eq(rp[rid].found, rj[rid].found, f"rid {rid} found")
        _eq(rp[rid].values, rj[rid].values, f"rid {rid} values")
    strip = lambda reps: [r._replace(latency_s=0.0) for r in reps]  # noqa: E731
    assert strip(ep.reports) == strip(ej.reports)
    _same_state(ej.source.snapshot()[1].state, ep.source.snapshot()[1].state, "served table")
