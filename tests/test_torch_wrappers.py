"""The port's last two kernel wrappers against the JAX package's:
``kernels.ops.find_many_kernel`` (``tests/test_find_kernel.py``'s
find_many cases) and ``kernels.ops.assign_kernel``
(``tests/test_kernels.py``'s assign case).

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

from repro.core import ops as jops  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.kernels import ops as jk  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.kernels import find_scan  # noqa: E402
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
