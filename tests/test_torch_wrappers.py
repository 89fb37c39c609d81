"""The port's kernel wrappers against the JAX package's:
``kernels.ops.find_many_kernel`` (``tests/test_find_kernel.py``'s
find_many cases), ``kernels.ops.assign_kernel`` (``tests/test_kernels.py``'s
assign case), ``find_kernel`` and ``find_composed_kernel``
(``test_find_kernel.py::test_fused_matches_old_composition``,
``test_kernels.py::test_find_kernel_end_to_end_matches_core_find``), and
``kernels.ops.ref``, the oracles under the reference's names.  The upsert
wrappers are held in ``tests/test_torch_upsert_kernel.py``.

On the CPU the port's wrappers run their kernels' plain versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
States are filled once by the port and carried to the JAX layout through
``repro_torch.convert``; bit for bit on every output.  (On the card the
kernels are held against the plain versions in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 9.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import merge as jmerge  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.kernels import ops as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.kernels import digest_scan, find_scan, gather, scatter, score_scan  # noqa: E402
from repro_torch.kernels import update_scan  # noqa: E402
from repro_torch.kernels import ops as pk  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _filled(rng, cap, dim, n, dual):
    """(JAX state, port state, resident keys): one table filled by the port."""
    t = repro_torch.HKVTable.create(capacity=cap, dim=dim, buckets_per_key=2 if dual else 1,
                                    device="cpu")
    keys = rng.integers(1, 2**50, size=n).astype(np.uint64)
    t.insert_or_assign(keys, torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)))
    arrays = convert.state_to_arrays(t.state)
    return jtable.HKVState(**{f: jnp.asarray(arrays[f]) for f in convert.FIELDS}), t.state, keys


def _queries(rng, resident, n_hit, n_miss, n_pad):
    q = np.concatenate([rng.choice(resident, size=n_hit),
                        rng.integers(2**50, 2**60, size=n_miss).astype(np.uint64),
                        np.full(n_pad, EMPTY, np.uint64)])
    rng.shuffle(q)
    return q


def _fused_eq(jr, pr, ctx):
    """A port FusedFind against the JAX one (whose EMPTY lanes carry the
    kernel's raw bucket and slot; found, values and scores are masked in
    both, see ROADMAP queue 3)."""
    found = np.asarray(jr.found)
    np.testing.assert_array_equal(pr.found.numpy(), found, err_msg=f"{ctx}: found")
    np.testing.assert_array_equal(pr.values.numpy(), np.asarray(jr.values),
                                  err_msg=f"{ctx}: values")
    score = (np.asarray(jr.score_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        jr.score_lo).astype(np.uint64)
    np.testing.assert_array_equal(pr.scores.numpy().view(np.uint64), score,
                                  err_msg=f"{ctx}: scores")
    for f in ("bucket", "slot"):
        np.testing.assert_array_equal(getattr(pr, f).numpy()[found],
                                      np.asarray(getattr(jr, f))[found], err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("dual", [False, True])
def test_find_many_matches_jax_and_per_table_finds(dual):
    rng = np.random.default_rng(29)
    cfg_p = ptable.HKVConfig(capacity=2 * 128, dim=8, buckets_per_key=2 if dual else 1)
    cfg_j = jtable.HKVConfig(capacity=2 * 128, dim=8, buckets_per_key=2 if dual else 1)
    jstates, pstates, keysets = [], [], []
    for _ in range(3):
        js, ps, resident = _filled(rng, 2 * 128, 8, 250, dual)
        jstates.append(js)
        pstates.append(ps)
        keysets.append(_queries(rng, resident, 40, 10, 5))
    jm = jk.find_many_kernel(jstates, cfg_j, [ju64.from_uint64(k) for k in keysets],
                             interpret=True)
    pm = pk.find_many_kernel(pstates, cfg_p, [pu64.from_numpy_u64(k) for k in keysets])
    assert len(pm) == len(jm) == 3
    for t, (ps, k) in enumerate(zip(pstates, keysets)):
        _fused_eq(jm[t], pm[t], f"dual={dual} table {t}")
        solo = pk.find_fused_kernel(ps, cfg_p, pu64.from_numpy_u64(k))
        for f in solo._fields:
            assert torch.equal(getattr(pm[t], f), getattr(solo, f)), f"table {t} {f}"


def test_find_many_is_one_find_scan_call(monkeypatch):
    rng = np.random.default_rng(31)
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=4)
    states, keysets = [], []
    for _ in range(4):
        _js, ps, resident = _filled(rng, 2 * 128, 4, 150, False)
        states.append(ps)
        keysets.append(pu64.from_numpy_u64(resident[:32]))
    calls = {"many": 0, "one": 0}
    many, one = pk.find_scan_many, pk.find_scan

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(pk, "find_scan_many", count("many", many))
    monkeypatch.setattr(pk, "find_scan", count("one", one))
    out = pk.find_many_kernel(states, cfg, keysets)
    assert calls == {"many": 1, "one": 0}          # 4 tables, ONE call
    assert all(bool(r.found.all()) for r in out)


def test_find_many_validation():
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=4)
    cfg_h = ptable.HKVConfig(capacity=2 * 128, dim=4, value_tier="hmem")
    k = pu64.from_numpy_u64(np.asarray([1], np.uint64))
    assert pk.find_many_kernel([], cfg, []) == []
    with pytest.raises(ValueError, match="hbm"):
        pk.find_many_kernel([ptable.create(cfg_h, "cpu")], cfg_h, [k])
    other = ptable.create(ptable.HKVConfig(capacity=4 * 128, dim=4), "cpu")
    with pytest.raises(ValueError, match="geometry"):
        pk.find_many_kernel([ptable.create(cfg, "cpu"), other], cfg, [k, k])


def test_find_scan_many_plain_is_per_table_find_scan():
    rng = np.random.default_rng(5)
    cfg = ptable.HKVConfig(capacity=4 * 128, dim=4, buckets_per_key=2)
    states, keys = [], []
    for c in (17, 0, 40):                          # an empty table's segment too
        _js, ps, resident = _filled(rng, 4 * 128, 4, 300, True)
        states.append(ps)
        keys.append(pu64.from_numpy_u64(_queries(rng, resident, c // 2, c - c // 2, 0)))
    probes = [pk.find_mod.probe_keys(cfg, k) for k in keys]
    out = find_scan.find_scan_many(
        [(s.digests, s.keys, s.scores, s.values) for s in states],
        torch.cat([p.bucket1 for p in probes]), torch.cat([p.bucket2 for p in probes]),
        torch.cat([p.digest for p in probes]), torch.cat(keys), [k.numel() for k in keys])
    start = 0
    for s, p, k in zip(states, probes, keys):
        want = find_scan.find_scan_plain(s.digests, s.keys, s.scores, s.values, p.bucket1,
                                         p.bucket2, p.digest, k)
        for g, w in zip(out, want):
            assert torch.equal(g[start:start + k.numel()], w)
        start += k.numel()


@pytest.mark.parametrize("dual", [False, True])
def test_assign_kernel_matches_jax(dual):
    rng = np.random.default_rng(13)
    cap, dim, aux = 4 * 128, 8, 2
    t = repro_torch.HKVTable.create(capacity=cap, dim=dim, aux_value_dim=aux,
                                    buckets_per_key=2 if dual else 1, device="cpu")
    keys = rng.permutation(10_000)[:128].astype(np.uint64)     # unique
    t.insert_or_assign(keys, torch.from_numpy(rng.normal(size=(128, dim + aux))
                                              .astype(np.float32)))
    arrays = convert.state_to_arrays(t.state)
    cfg_j = jtable.HKVConfig(capacity=cap, dim=dim, aux_value_dim=aux,
                             buckets_per_key=2 if dual else 1)
    js = jtable.HKVState(**{f: jnp.asarray(arrays[f]) for f in convert.FIELDS})
    q = np.concatenate([keys[:100], rng.integers(2**50, 2**60, size=20).astype(np.uint64),
                        np.full(8, EMPTY, np.uint64)])
    upd = rng.normal(size=(128, dim)).astype(np.float32)
    for add in (False, True):
        got = pk.assign_kernel(convert.state_from_arrays(arrays, "cpu"), t.cfg,
                               pu64.from_numpy_u64(q), torch.from_numpy(upd), add=add)
        want = jk.assign_kernel(js, cfg_j, ju64.from_uint64(q), jnp.asarray(upd), add=add,
                                interpret=True)
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
        plain = pk.assign_plain(convert.state_from_arrays(arrays, "cpu"), t.cfg,
                                pu64.from_numpy_u64(q), torch.from_numpy(upd), add=add)
        assert torch.equal(plain.values, got.values)
    # the wrapper zero-pads the aux columns (set), where the core assign
    # keeps them: the reference wrapper's convention
    core = jops.assign(js, cfg_j, ju64.from_uint64(q), jnp.asarray(upd))
    got = pk.assign_kernel(convert.state_from_arrays(arrays, "cpu"), t.cfg,
                           pu64.from_numpy_u64(q), torch.from_numpy(upd))
    hit = t.find_ptr(q[:100]).row.numpy()
    np.testing.assert_array_equal(got.values.numpy()[hit, :dim], np.asarray(core.values)[hit, :dim])
    assert not got.values.numpy()[hit, dim:].any()
    assert np.asarray(core.values)[hit, dim:].any()


# -- find_kernel and find_composed_kernel ------------------------------------


def _query_batch(rng, resident, n_hit, n_miss, n_pad, dup_frac=0.25):
    """test_find_kernel.py's batch: hits with duplicates, wide-key misses,
    EMPTY padding."""
    hits = rng.choice(resident, size=n_hit)
    ndup = int(n_hit * dup_frac)
    hits[rng.integers(0, n_hit, size=ndup)] = rng.choice(hits, size=ndup)
    q = np.concatenate([hits, rng.integers(2**50, 2**60, size=n_miss).astype(np.uint64),
                        np.full(n_pad, EMPTY, np.uint64)])
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("variant", ["tlp", "pipeline"])
def test_fused_matches_old_composition(variant, dual):
    """find_kernel (one find_scan) and find_composed_kernel (locate_kernel
    and gather_rows) against each other and against the JAX wrappers of
    each TPU schedule, bit for bit."""
    rng = np.random.default_rng(41 + dual)
    cap, dim = 2 * 128, 16
    js, ps, resident = _filled(rng, cap, dim, 300, dual)
    cfg_j = jtable.HKVConfig(capacity=cap, dim=dim, buckets_per_key=2 if dual else 1)
    q = _query_batch(rng, resident, 80, 30, 18)
    k = pu64.from_numpy_u64(q)
    v_new, f_new = pk.find_kernel(ps, _cfg(cap, dim, dual), k)
    v_old, f_old = pk.find_composed_kernel(ps, _cfg(cap, dim, dual), k)
    assert torch.equal(v_new, v_old) and torch.equal(f_new, f_old)
    assert v_new.shape == (q.size, dim) and f_new.any() and not f_new.all()
    for fn in (jk.find_kernel, jk.find_composed_kernel):
        jv, jf = fn(js, cfg_j, ju64.from_uint64(q), variant=variant, interpret=True)
        np.testing.assert_array_equal(f_new.numpy(), np.asarray(jf), err_msg=fn.__name__)
        np.testing.assert_array_equal(v_new.numpy(), np.asarray(jv), err_msg=fn.__name__)


def _cfg(cap, dim, dual, **kw):
    return ptable.HKVConfig(capacity=cap, dim=dim, buckets_per_key=2 if dual else 1, **kw)


def test_find_kernel_end_to_end_matches_core_find():
    """test_kernels.py's end-to-end case: a table at λ 0.9 (aux columns
    too, which the wrapper cuts), queried with keys mostly absent."""
    rng = np.random.default_rng(11)
    cap, dim = 8 * 128, 16
    cfg_j = jtable.HKVConfig(capacity=cap, dim=dim, aux_value_dim=1)
    cfg_p = ptable.HKVConfig(capacity=cap, dim=dim, aux_value_dim=1)
    fill = rng.integers(0, 2**50, size=int(0.9 * cap)).astype(np.uint64)
    rows = rng.normal(size=(fill.size, dim + 1)).astype(np.float32)
    js = jmerge.upsert(jtable.create(cfg_j), cfg_j, ju64.from_uint64(fill), jnp.asarray(rows)).state
    ps = ptable.create(cfg_p, "cpu")
    pops.insert_or_assign(ps, cfg_p, pu64.from_numpy_u64(fill), torch.from_numpy(rows))
    q = np.concatenate([rng.choice(fill, size=32),
                        rng.integers(0, 2**50, size=96).astype(np.uint64)])
    jv, jf = jk.find_kernel(js, cfg_j, ju64.from_uint64(q), interpret=True)
    pv, pf = pk.find_kernel(ps, cfg_p, pu64.from_numpy_u64(q))
    core = pops.find(ps, cfg_p, pu64.from_numpy_u64(q))
    jcore = jops.find(js, cfg_j, ju64.from_uint64(q))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert torch.equal(pv, core.values) and torch.equal(pf, core.found)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jcore.values))
    assert 32 <= int(pf.sum()) < q.size


@pytest.mark.parametrize("tier", ["hbm", "hmem"])
def test_find_wrappers_on_each_tier(tier):
    """On 'hmem' find_kernel follows find_fused_kernel's locate and gather;
    both wrappers equal the 'hbm' table's."""
    rng = np.random.default_rng(3)
    cap, dim = 4 * 128, 8
    t = repro_torch.HKVTable.create(capacity=cap, dim=dim, buckets_per_key=2,
                                    value_tier=tier, device="cpu")
    ref_t = repro_torch.HKVTable.create(capacity=cap, dim=dim, buckets_per_key=2, device="cpu")
    keys = rng.integers(1, 2**50, size=600).astype(np.uint64)
    vals = torch.from_numpy(rng.normal(size=(600, dim)).astype(np.float32))
    t.insert_or_assign(keys, vals)
    ref_t.insert_or_assign(keys, vals)
    k = pu64.from_numpy_u64(_query_batch(rng, keys, 60, 20, 4))
    want = pk.find_kernel(ref_t.state, ref_t.cfg, k)
    for fn in (pk.find_kernel, pk.find_composed_kernel):
        got = fn(t.state, t.cfg, k)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), fn.__name__


# -- kernels.ops.ref ---------------------------------------------------------

REF_NAMES = {"digest_scan_ref": digest_scan.digest_scan_plain,
             "find_scan_ref": find_scan.find_scan_plain,
             "update_scan_ref": update_scan.update_scan_plain,
             "gather_rows_ref": gather.gather_rows_plain,
             "scatter_rows_ref": scatter.scatter_rows_plain,
             "bucket_stats_ref": score_scan.bucket_stats_plain}


@pytest.mark.parametrize("name", sorted(REF_NAMES))
def test_ref_name_is_the_plain_version(name):
    assert getattr(pk.ref, name) is REF_NAMES[name]
    assert hasattr(jref, name) and name in pk.ref.__all__


def test_ref_names_are_the_reference_oracles():
    ref_names = {n for n in dir(jref) if n.endswith("_ref")}
    assert ref_names == set(REF_NAMES) == set(pk.ref.__all__)


def _oracle_state(seed):
    rng = np.random.default_rng(seed)
    js, ps, resident = _filled(rng, 4 * 128, 4, 450, True)
    return rng, js, ps, resident


def _hilo(x):
    hi, lo = convert._split(x)
    return jnp.asarray(hi), jnp.asarray(lo)


def test_ref_oracles_match_the_jax_oracles():
    """Each bound plain version against the JAX oracle of its name on the
    same inputs, through the conventions ``kernels/ref.py`` names."""
    rng, js, ps, resident = _oracle_state(7)
    cfg = _cfg(4 * 128, 4, True)
    q = _queries(rng, resident, 40, 20, 0)
    k = pu64.from_numpy_u64(q)
    p = pk.find_mod.probe_keys(cfg, k)
    qhi, qlo = _hilo(k)
    qd = jnp.asarray(p.digest.numpy().astype(np.uint32))
    b1, b2 = jnp.asarray(p.bucket1.numpy().astype(np.int32)), jnp.asarray(
        p.bucket2.numpy().astype(np.int32))
    for b, jb in ((p.bucket1, b1), (p.bucket2, b2)):
        got = pk.ref.digest_scan_ref(ps.digests, ps.keys, b, p.digest, k)
        want = jref.digest_scan_ref(js.digests, js.key_hi, js.key_lo, jb, qd, qhi, qlo)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = pk.ref.find_scan_ref(ps.digests, ps.keys, ps.scores, ps.values, p.bucket1, p.bucket2,
                               p.digest, k)
    want = jref.find_scan_ref(js.digests, js.key_hi, js.key_lo, js.score_hi, js.score_lo,
                              js.values, b1, b2, qd, qhi, qlo)
    for i, j in ((0, 0), (1, 1), (2, 2), (4, 5)):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[j]), err_msg=f"output {i}")
    np.testing.assert_array_equal(got[3].numpy().view(np.uint64),
                                  (np.asarray(want[3]).astype(np.uint64) << np.uint64(32))
                                  | np.asarray(want[4]).astype(np.uint64))
    rows = torch.from_numpy(rng.permutation(ps.values.shape[0])[:64].astype(np.int64))
    mask = torch.from_numpy(rng.integers(0, 2, size=64).astype(bool))
    got = pk.ref.gather_rows_ref(ps.values, rows, mask)
    want = jref.gather_rows_ref(js.values, jnp.asarray(rows.numpy().astype(np.int32)),
                                jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    upd = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    for add in (False, True):
        plane = ps.values.clone()
        assert pk.ref.scatter_rows_ref(plane, rows, upd, mask, add) is None
        want = jref.scatter_rows_ref(js.values, jnp.asarray(rows.numpy().astype(np.int32)),
                                     jnp.asarray(upd.numpy()), jnp.asarray(mask.numpy()), add)
        np.testing.assert_array_equal(plane.numpy(), np.asarray(want), err_msg=f"add={add}")
    occ, low, slot = pk.ref.bucket_stats_ref(ps.keys, ps.scores)
    jocc, jhi, jlo, jslot = jref.bucket_stats_ref(js.key_hi, js.key_lo, js.score_hi, js.score_lo)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(low.numpy().view(np.uint64),
                                  (np.asarray(jhi).astype(np.uint64) << np.uint64(32))
                                  | np.asarray(jlo).astype(np.uint64))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
