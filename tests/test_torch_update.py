"""The port's updater path against the JAX package: update_scan's plain
version, update_rows (fused, composed, with score touches, at a shared
locate) and OpSession.

The same numpy-made tables and batches go through both packages; states
cross with `repro_torch.convert`.  The JAX side runs its jnp reference
(`kernels.ref.update_scan_ref`, `core.ops.update_rows(backend='jnp')`), and
the Pallas kernel in interpret mode where its own tests run it.

Tolerance: `found` and every integer plane are exact, and so are the
values for sgd, sgdm and adagrad (both packages round each operation once,
in the same order).  rowwise_adagrad's row mean is a reduction, summed by
XLA in its own order and by the port in a fixed halving tree, so there the
values agree within a relative 1e-6: each row's largest difference against
its largest magnitude, and the refreshed accumulator column elementwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import find as jfind  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.core.api import HKVTable as JaxTable  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JaxOpt  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import update_scan as jupd  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import find as pfind  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core.table import HKVConfig  # noqa: E402
from repro_torch.embedding.sparse_opt import SparseOptimizer, tree_row_sum  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import update_scan as pupd  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
OPTIMIZERS = ("sgd", "sgdm", "rowwise_adagrad", "adagrad")
DIM = 8
RTOL = 1e-6


def _cfgs(opt_name, dual, capacity=4 * 128, use_digest=True, lr=0.05, dim=DIM):
    kw = dict(capacity=capacity, dim=dim, buckets_per_key=2 if dual else 1,
              aux_value_dim=JaxOpt(opt_name).aux_dim(dim), use_digest=use_digest)
    return (JaxOpt(opt_name, lr=lr), jtable.HKVConfig(**kw),
            SparseOptimizer(opt_name, lr=lr), HKVConfig(**kw))


def _filled(rng, jcfg, n_fill):
    """A JAX state past λ = 1 (so some keys are rejected and dual mode has
    secondary-bucket residents), with non-negative aux columns (adagrad's
    accumulators stay in sqrt's domain); and the port's copy."""
    keys = rng.integers(1, 2**50, size=n_fill).astype(np.uint64)
    keys[::7] |= np.uint64(1 << 63)
    v = jcfg.dim + jcfg.aux_value_dim
    vals = jnp.asarray(np.abs(rng.normal(size=(n_fill, v))), jnp.float32)
    state = jtable.create(jcfg)
    for i in range(0, n_fill, 50):   # batches, so dual mode fills both candidates
        state = jmerge.upsert(state, jcfg, ju64.from_uint64(keys[i:i + 50]), vals[i:i + 50]).state
    return state, convert.state_from_arrays(state, device="cpu")


def _resident(jstate):
    live = ~ju64.empty_lanes(jstate.key_hi, jstate.key_lo)
    words = ((np.asarray(jstate.key_hi).astype(np.uint64) << np.uint64(32))
             | np.asarray(jstate.key_lo).astype(np.uint64))
    return words[np.asarray(live)]


def _queries(rng, resident, n_hit=96, n_miss=40, n_pad=12):
    """Unique resident keys, unique never-inserted keys and EMPTY padding."""
    hits = rng.choice(resident, size=n_hit, replace=False)
    misses = np.unique(rng.integers(2**50, 2**60, size=2 * n_miss).astype(np.uint64))[:n_miss]
    q = np.concatenate([hits, misses, np.full(n_pad, EMPTY)])
    rng.shuffle(q)
    return q


def _grads(rng, n, dim=DIM):
    return rng.normal(size=(n, dim)).astype(np.float32)


def assert_values(got, want, opt_name, dim, ctx):
    """Exact, or for rowwise_adagrad within RTOL (see the module note)."""
    got, want = np.asarray(got), np.asarray(want)
    if opt_name != "rowwise_adagrad":
        np.testing.assert_array_equal(got, want, err_msg=ctx)
        return
    diff = np.abs(got - want).max(axis=1)
    scale = np.abs(want).max(axis=1)
    assert (diff <= RTOL * scale).all(), f"{ctx}: row error {np.max(diff / np.maximum(scale, 1e-30))}"
    acc_w, acc_g = want[:, dim], got[:, dim]
    assert (np.abs(acc_g - acc_w) <= RTOL * np.abs(acc_w)).all(), f"{ctx}: accumulator"


def assert_state(jstate, pstate, opt_name, ctx, dim=DIM):
    got = convert.state_to_arrays(pstate)
    for f in convert.FIELDS:
        if f != "values":
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jstate, f)),
                                          err_msg=f"{ctx}: {f}")
    assert_values(got["values"], jstate.values, opt_name, dim, f"{ctx}: values")


def _probe_args(pcfg, pstate, q):
    k = repro_torch.normalize_keys(q)
    p = pfind.probe_keys(pcfg, k)
    return (pstate.digests, pstate.keys, pstate.values, p.bucket1, p.bucket2, p.digest, k,
            p.valid)


def _jax_probe_args(jcfg, jstate, q):
    k = ju64.from_uint64(q)
    p = jfind.probe_keys(jcfg, k)
    b2 = p.bucket2 if jcfg.buckets_per_key == 2 else p.bucket1
    return (jstate.digests, jstate.key_hi, jstate.key_lo, jstate.values, p.bucket1, b2,
            p.digest.astype(jnp.uint32), k.hi, k.lo, p.valid.astype(jnp.int32))


# =============================================================================
# update_scan's plain version against the reference's
# =============================================================================


@pytest.mark.parametrize("use_digest", [True, False], ids=["digest", "nodigest"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_update_scan_plain_matches_ref(opt_name, dual, use_digest):
    """Hits (some in the secondary bucket), misses of a full table, EMPTY
    padding: found exact, the hit rows updated, every other row as it was."""
    rng = np.random.default_rng(11 + 3 * dual + use_digest)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, dual, use_digest=use_digest)
    jstate, pstate = _filled(rng, jcfg, 700)
    q = _queries(rng, _resident(jstate))
    g = _grads(rng, q.size)
    want_found, want_values = jref.update_scan_ref(*_jax_probe_args(jcfg, jstate, q),
                                                   jnp.asarray(g), jopt, DIM,
                                                   use_digest=use_digest)
    found = pupd.update_scan(*_probe_args(pcfg, pstate, q), torch.from_numpy(g), popt, DIM,
                             use_digest=use_digest)
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    assert 0 < int(found.sum()) < q.size
    assert_values(pstate.values.numpy(), want_values, opt_name, DIM, "values")
    if dual:   # the batch reached rows in both candidate buckets
        k = repro_torch.normalize_keys(q)
        loc = pfind.locate(pstate, pcfg, k)
        assert bool((loc.found & (loc.bucket != pfind.probe_keys(pcfg, k).bucket1)).any())


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_update_scan_plain_matches_the_interpret_kernel(opt_name):
    """The Pallas kernel itself (tlp schedule, interpret mode) on a small
    batch: equal to the port's plain version bit for bit."""
    rng = np.random.default_rng(21)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, True, capacity=2 * 128)
    jstate, pstate = _filled(rng, jcfg, 300)
    q = _queries(rng, _resident(jstate), n_hit=24, n_miss=6, n_pad=2)
    g = _grads(rng, q.size)
    want_found, want_values = jupd.update_scan_tlp(*_jax_probe_args(jcfg, jstate, q),
                                                   jnp.asarray(g), opt=jopt, dim=DIM,
                                                   interpret=True)
    found = pupd.update_scan(*_probe_args(pcfg, pstate, q), torch.from_numpy(g), popt, DIM)
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    np.testing.assert_array_equal(pstate.values.numpy(), np.asarray(want_values))


def test_miss_and_padding_lanes_write_nothing():
    """Under full rejection, misses with huge gradients and EMPTY lanes
    (which would match free slots without the gate) leave the plane as it
    was, bit for bit, with the digest filter off."""
    rng = np.random.default_rng(5)
    _jopt, jcfg, popt, pcfg = _cfgs("adagrad", True, capacity=2 * 128, use_digest=False)
    jstate, pstate = _filled(rng, jcfg, 400)
    before = pstate.values.clone()
    q = np.concatenate([np.unique(rng.integers(2**50, 2**60, size=40).astype(np.uint64)),
                        np.full(8, EMPTY)])
    g = (_grads(rng, q.size) * 1e6).astype(np.float32)
    found = pupd.update_scan(*_probe_args(pcfg, pstate, q), torch.from_numpy(g), popt, DIM,
                             use_digest=False)
    assert not bool(found.any()) and torch.equal(pstate.values, before)


# rows wider than the 256 columns the first kernel held; qwen2-0.5b's
# d_model is 896
WIDE_DIMS = (257, 512, 896)


@pytest.mark.parametrize("dim", WIDE_DIMS)
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_wide_rows_match_the_reference(opt_name, dim):
    """Dims 257, 512 and 896 (a dual table past λ 1.0, hits, misses and
    padding): update_scan's plain version against the reference's
    update_scan_ref and its Pallas kernel (tlp, interpret mode); and
    update_rows (plain, the fused stage, the composed stage) against the
    reference's jnp update_rows.  Bit-identical, rowwise_adagrad within
    RTOL."""
    rng = np.random.default_rng(dim + OPTIMIZERS.index(opt_name))
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, True, capacity=2 * 128, dim=dim)
    jstate, pstate = _filled(rng, jcfg, 300)
    q = _queries(rng, _resident(jstate), n_hit=24, n_miss=6, n_pad=2)
    g = _grads(rng, q.size, dim)
    found = pupd.update_scan(*_probe_args(pcfg, pstate, q), torch.from_numpy(g), popt, dim)
    args = (*_jax_probe_args(jcfg, jstate, q), jnp.asarray(g))
    for name, (want_found, want_values) in (
            ("update_scan_ref", jref.update_scan_ref(*args, jopt, dim)),
            ("update_scan_tlp", jupd.update_scan_tlp(*args, opt=jopt, dim=dim, interpret=True))):
        np.testing.assert_array_equal(found.numpy(), np.asarray(want_found), err_msg=name)
        assert_values(pstate.values.numpy(), want_values, opt_name, dim, name)
    assert 0 < int(found.sum()) < q.size

    want = _jax_update(jstate, jcfg, q, g, jopt)
    k = repro_torch.normalize_keys(q)
    for name, run in (
            ("plain", lambda s: pops.update_rows(s, pcfg, k, torch.from_numpy(g), popt,
                                                 backend="plain").found),
            ("fused", lambda s: kops.update_rows_kernel(s, pcfg, k, torch.from_numpy(g),
                                                        popt).found),
            ("composed", lambda s: kops.update_composed_kernel(s, pcfg, k, torch.from_numpy(g),
                                                               popt).found)):
        pstate = convert.state_from_arrays(jstate, device="cpu")
        np.testing.assert_array_equal(run(pstate).numpy(), np.asarray(want.found), err_msg=name)
        assert_state(want.state, pstate, opt_name, name, dim)


@pytest.mark.parametrize("d", [1, 5, 8, 32, 33, 64, 100, 257, 896])
def test_tree_row_sum_is_the_halving_tree(d):
    """The fixed order of rowwise_adagrad's mean: pad to a power of two,
    then column i plus column i + h, h halving (the kernel's butterfly)."""
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(50, d)).astype(np.float32))
    p = 1 << max(d - 1, 0).bit_length()
    cols = [x[:, i] for i in range(d)] + [torch.zeros(50)] * (p - d)
    while len(cols) > 1:
        h = len(cols) // 2
        cols = [cols[i] + cols[i + h] for i in range(h)]
    assert torch.equal(tree_row_sum(x), cols[0])


def _kernel_order_sum(x: torch.Tensor) -> list:
    """rowwise_adagrad's row sum in the order of the CUDA update_scan (a
    group of 8 lanes a row, lane g owning columns g, g+8, ...): each lane
    takes its columns in bit-reversed order of their tile index through a
    stack of pending pair sums, then a xor butterfly (4, 2, 1) across the
    group.  Every add rounds in x's dtype.  Returns the 8 lanes' sums."""
    n, d = x.shape
    levels = 0
    while (8 << levels) < d:
        levels += 1
    zero = x.new_zeros(n)
    lanes = []
    for g in range(8):
        stack = [None] * (levels + 1)
        for j in range(1 << levels):
            k = int(format(j, f"0{levels}b")[::-1], 2) if levels else 0
            v = x[:, g + 8 * k] if g + 8 * k < d else zero
            lvl = 0
            while (j >> lvl) & 1:
                v = stack[lvl] + v
                lvl += 1
            stack[lvl] = v
        lanes.append(stack[levels])
    for off in (4, 2, 1):
        lanes = [lanes[g] + lanes[g ^ off] for g in range(8)]
    return lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 3, 8, 9, 32, 33, 100, 257, 896])
def test_kernel_lane_order_is_the_halving_tree(d, dtype):
    """The kernel's summation order (lane-local bit-reversed pair sums, then
    the group butterfly, which adds exact zeros below 8 columns) is
    tree_row_sum's halving tree, bit for bit in every lane, at both
    dtypes."""
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(64, d)).astype(np.float32))
    sq = (x * x).to(dtype)
    want = tree_row_sum(sq)
    for g, got in enumerate(_kernel_order_sum(sq)):
        assert torch.equal(got, want), f"lane {g}"


def test_optimizer_roots_are_correctly_rounded():
    """The optimizers' square root is the correctly rounded float32 root
    (numpy's, XLA's and the kernel's __fsqrt_rn), which torch's vectorized
    float32 sqrt is not on every input."""
    from repro_torch.embedding.sparse_opt import _sqrt

    rng = np.random.default_rng(9)
    x = (np.abs(rng.normal(size=200_000)) * 10.0 ** rng.integers(-8, 8, size=200_000))
    x = x.astype(np.float32)
    np.testing.assert_array_equal(_sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))


# =============================================================================
# update_rows through the op engine
# =============================================================================


def _jax_update(jstate, jcfg, q, g, jopt, **kw):
    return jops.update_rows(jstate, jcfg, ju64.from_uint64(q), jnp.asarray(g), jopt,
                            backend="jnp", **kw)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_update_rows_fused_and_composed_match_jax(opt_name, dual):
    """ops.update_rows (plain), the fused stage (update_rows_kernel) and
    the composed stage (locate, gather, optimizer, scatter) on the same
    table and batch: each equals the reference's jnp update_rows."""
    rng = np.random.default_rng(31 + dual)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, dual)
    jstate, _ = _filled(rng, jcfg, 650)
    q = _queries(rng, _resident(jstate))
    g = _grads(rng, q.size)
    want = _jax_update(jstate, jcfg, q, g, jopt)
    k = repro_torch.normalize_keys(q)
    for name, run in (
            ("plain", lambda s: pops.update_rows(s, pcfg, k, torch.from_numpy(g), popt,
                                                 backend="plain").found),
            ("fused", lambda s: kops.update_rows_kernel(s, pcfg, k, torch.from_numpy(g),
                                                        popt).found),
            ("composed", lambda s: kops.update_composed_kernel(s, pcfg, k, torch.from_numpy(g),
                                                               popt).found)):
        pstate = convert.state_from_arrays(jstate, device="cpu")
        found = run(pstate)
        np.testing.assert_array_equal(found.numpy(), np.asarray(want.found), err_msg=name)
        assert_state(want.state, pstate, opt_name, name)


@pytest.mark.parametrize("policy", ["lru", "lfu"])
@pytest.mark.parametrize("opt_name", ["sgdm", "rowwise_adagrad"])
def test_update_rows_with_scores_and_at_a_shared_locate(opt_name, policy):
    """update_scores=True (the composed route, scores touched per policy)
    and a caller's locate: state equal to the reference's, clock too."""
    rng = np.random.default_rng(41)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, True)
    jcfg = jtable.HKVConfig(**{**jcfg.__dict__, "score_policy": policy})
    pcfg = HKVConfig(**{**pcfg.__dict__, "score_policy": policy})
    jstate, _ = _filled(rng, jcfg, 650)
    q = _queries(rng, _resident(jstate))
    g = _grads(rng, q.size)
    k = repro_torch.normalize_keys(q)

    want = _jax_update(jstate, jcfg, q, g, jopt, update_scores=True)
    pstate = convert.state_from_arrays(jstate, device="cpu")
    got = pops.update_rows(pstate, pcfg, k, torch.from_numpy(g), popt, update_scores=True)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    assert_state(want.state, pstate, opt_name, "update_scores")

    jloc = jfind.locate(jstate, jcfg, ju64.from_uint64(q))
    want = _jax_update(jstate, jcfg, q, g, jopt, loc=jloc)
    pstate = convert.state_from_arrays(jstate, device="cpu")
    ploc = pops.find_ptr(pstate, pcfg, k)
    got = pops.update_rows(pstate, pcfg, k, torch.from_numpy(g), popt, loc=ploc)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    assert_state(want.state, pstate, opt_name, "shared loc")


# =============================================================================
# OpSession
# =============================================================================


def _record(s, ks, vals, gs, opt_mod, opt):
    """One op list for a session of either package."""
    k1, k2, k3, k4 = ks
    refs = [s.find(k1), s.find_rows(k1)]
    s.assign(k1, vals[0])
    refs += [s.contains(k2), s.update_rows(k1, lambda r: r * 0.5 + 1.0),
             s.update_rows(k3, opt_mod.RowUpdate(opt, gs[0])), s.find(k1)]
    refs.append(s.insert_or_assign(k2, vals[1]))
    refs += [s.find(k2), s.assign_add(k2, vals[2][:, :DIM]), s.update_rows(k2, opt_mod.RowUpdate(opt, gs[1]))]
    refs.append(s.find_or_insert(k3, vals[3]))
    refs.append(s.erase(k4))
    refs += [s.contains(k4), s.find_rows(k3)]
    return refs


def _same_result(jr, pr, ctx):
    """A session result of either package, field by field (64-bit words
    and JAX result tuples carried through convert)."""
    if hasattr(pr, "state") and hasattr(pr, "found") and not hasattr(pr, "rows"):
        np.testing.assert_array_equal(pr.found.numpy(), np.asarray(jr.found), err_msg=ctx)
        return
    if isinstance(pr, pops.FindRowsResult):
        np.testing.assert_array_equal(pr.rows.numpy(), np.asarray(jr.rows), err_msg=ctx)
        np.testing.assert_array_equal(pr.found.numpy(), np.asarray(jr.found), err_msg=ctx)
        np.testing.assert_array_equal(pr.row.numpy().astype(np.int32), np.asarray(jr.row))
        return
    if isinstance(pr, pops.FindResult):
        np.testing.assert_array_equal(pr.values.numpy(), np.asarray(jr.values), err_msg=ctx)
        np.testing.assert_array_equal(pr.found.numpy(), np.asarray(jr.found), err_msg=ctx)
        return
    if isinstance(pr, tuple):
        for i, (a, b) in enumerate(zip(jr, pr)):
            _same_result(a, b, f"{ctx}[{i}]")
        return
    if isinstance(pr, torch.Tensor):
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr), err_msg=ctx)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_session_plan_and_results_match_jax(opt_name):
    """The same op list in a session of each package: explain() text is
    the reference's, every ref and the committed state are equal, and
    equal to the ops issued one by one."""
    rng = np.random.default_rng(51)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, True)
    jstate, _ = _filled(rng, jcfg, 450)
    res = _resident(jstate)
    ks = [np.unique(rng.choice(res, size=64, replace=False)),
          rng.integers(1, 2**50, size=64).astype(np.uint64),
          np.unique(rng.choice(res, size=48, replace=False)),
          rng.choice(res, size=16, replace=False)]
    ks[1][:20] = ks[0][:20]
    v = pcfg.total_value_dim
    # non-negative rows: an assigned aux column is an adagrad accumulator
    vals = [np.abs(rng.normal(size=(len(k), v))).astype(np.float32)
            for k in (ks[0], ks[1], ks[1], ks[2])]
    g, g2 = _grads(rng, len(ks[2])), _grads(rng, len(ks[1]))

    js = JaxTable.wrap(jstate, jcfg, backend="jnp").session()
    jrefs = _record(js, ks, [jnp.asarray(x) for x in vals], (jnp.asarray(g), jnp.asarray(g2)),
                    jops, jopt)
    jt = js.commit()
    pt = repro_torch.HKVTable.wrap(convert.state_from_arrays(jstate, device="cpu"), pcfg)
    ps = pt.session()
    prefs = _record(ps, ks, [torch.from_numpy(x) for x in vals],
                    (torch.from_numpy(g), torch.from_numpy(g2)), pops, popt)
    assert ps.commit() is pt
    assert ps.explain() == js.explain()
    assert "probes: 9 fused vs 15 unfused" in ps.explain()
    for i, (a, b) in enumerate(zip(jrefs, prefs)):
        _same_result(a.get(), b.get(), f"ref {i} ({b.op})")
    assert_state(jt.state, pt.state, opt_name, "session")

    # the same ops issued one by one give the same state
    pu = repro_torch.HKVTable.wrap(convert.state_from_arrays(jstate, device="cpu"), pcfg)
    k1, k2, k3, k4 = ks   # numpy uint64: an int64 tensor would read wide keys as padding
    pu.assign(k1, torch.from_numpy(vals[0]))
    rows = pu.find_rows(k1)
    pu.assign(k1, rows.rows * 0.5 + 1.0)
    pops.update_rows(pu.state, pcfg, pu.keys(k3), torch.from_numpy(g), popt)
    pu.insert_or_assign(k2, torch.from_numpy(vals[1]))
    pu.assign_add(k2, torch.from_numpy(vals[2][:, :DIM]))
    pops.update_rows(pu.state, pcfg, pu.keys(k2), torch.from_numpy(g2), popt)
    pu.find_or_insert(k3, torch.from_numpy(vals[3]))
    pu.erase(k4)
    for name in ("keys", "digests", "scores", "values"):
        assert torch.equal(getattr(pu.state, name), getattr(pt.state, name)), name
    assert not bool(pt.state.values.isnan().any())


class TestLaunchBudget:
    """The whole gradient step is one update_scan launch, counted in
    `_build.launch_counts` with the kernel routing forced on the CPU (the
    wrappers then run their plain versions; each shim counts a launch)."""

    @pytest.fixture
    def counts(self, monkeypatch):
        monkeypatch.setattr(pops, "uses_kernels", lambda backend, device: backend == "auto")
        for name in ("update_scan", "digest_scan", "gather_rows", "scatter_rows", "find_scan"):
            orig = getattr(kops, name)

            def counting(*a, _orig=orig, _name=name, **kw):
                _build.launch_counts[_name] += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(kops, name, counting)
        _build.reset_counts()
        yield _build.launch_counts
        _build.reset_counts()

    @pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
    def test_fused_update_is_one_launch(self, counts, dual):
        rng = np.random.default_rng(3)
        _jopt, jcfg, popt, pcfg = _cfgs("rowwise_adagrad", dual)
        jstate, pstate = _filled(rng, jcfg, 300)
        k = repro_torch.normalize_keys(np.unique(_resident(jstate))[:64])
        g = torch.from_numpy(_grads(rng, 64))
        pops.update_rows(pstate, pcfg, k, g, popt)
        assert dict(counts) == {"update_scan": 1}
        _build.reset_counts()
        kops.update_composed_kernel(pstate, pcfg, k, g, popt)
        assert dict(counts) == {"digest_scan": 1, "gather_rows": 1, "scatter_rows": 1}

    def test_session_row_update_is_one_launch(self, counts):
        rng = np.random.default_rng(4)
        _jopt, jcfg, popt, pcfg = _cfgs("sgd", True)
        jstate, pstate = _filled(rng, jcfg, 300)
        k = np.unique(_resident(jstate))[:32]
        s = repro_torch.HKVTable.wrap(pstate, pcfg).session()
        s.update_rows(k, pops.RowUpdate(popt, torch.from_numpy(_grads(rng, 32))))
        s.commit()
        assert dict(counts) == {"update_scan": 1}

    def test_shared_locate_composes(self, counts):
        """A RowUpdate after a find of the same batch shares its locate:
        the find's one digest_scan launch (both candidate rows), then a
        gather_rows, the optimizer and a plain assign."""
        rng = np.random.default_rng(6)
        _jopt, jcfg, popt, pcfg = _cfgs("sgd", True)
        jstate, pstate = _filled(rng, jcfg, 300)
        k = np.unique(_resident(jstate))[:32]
        s = repro_torch.HKVTable.wrap(pstate, pcfg).session()
        s.contains(k)
        s.update_rows(k, pops.RowUpdate(popt, torch.from_numpy(_grads(rng, 32))))
        s.commit()
        assert dict(counts) == {"digest_scan": 1, "gather_rows": 1}

    @pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
    def test_hmem_tier_routes(self, counts, dual):
        """On the 'hmem' tier the reference routes its readers and updaters
        through the locate kernel: find is one digest_scan and one
        gather_rows (no find_scan), the gradient step the composed one."""
        rng = np.random.default_rng(7)
        _jopt, jcfg, popt, pcfg = _cfgs("rowwise_adagrad", dual)
        jstate, _ = _filled(rng, jcfg, 300)
        pcfg = HKVConfig(**{**pcfg.__dict__, "value_tier": "hmem"})
        pstate = convert.state_from_arrays(jstate, device="cpu", value_tier="hmem")
        k = repro_torch.normalize_keys(np.unique(_resident(jstate))[:64])
        pops.find(pstate, pcfg, k)
        assert dict(counts) == {"digest_scan": 1, "gather_rows": 1}
        _build.reset_counts()
        pops.update_rows(pstate, pcfg, k, torch.from_numpy(_grads(rng, 64)), popt)
        assert dict(counts) == {"digest_scan": 1, "gather_rows": 1, "scatter_rows": 1}


def test_kvtable_protocol_and_table_signature():
    """The port's handle satisfies the KVTable protocol, and its signature
    has the reference's shape: family, backend, dim, value width, policy."""
    from repro.core.api import table_signature as jax_signature

    _jopt, jcfg, _popt, pcfg = _cfgs("rowwise_adagrad", True)
    pt = repro_torch.HKVTable.create(pcfg, device="cpu", backend="plain")
    jt = JaxTable.create(jcfg, backend="jnp")
    assert isinstance(pt, repro_torch.KVTable)
    got, want = repro_torch.table_signature(pt), jax_signature(jt)
    assert got == ("HKVTable", "plain", DIM, DIM + 1, "lru")
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert repro_torch.table_signature(pt.with_backend("auto"))[1] == "auto"
