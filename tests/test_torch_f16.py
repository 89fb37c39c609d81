"""A float16 value plane through the port, against the JAX package.

The JAX package's value plane may be any dtype (`HKVConfig.value_dtype`),
and its Pallas kernels take a float16 one.  numpy has float16, so
`repro_torch.convert` carries a float16 plane both ways as it is, bit for
bit.  The cases that repeat `tests/test_torch_bf16.py`'s run its replay and
test bodies, which take the 2-byte dtype, on float16; the cases that file
lacks (the promotion of find_or_insert's rows across dtypes, the
embedding's training steps, the tier hierarchy, the kernel wrappers) are
parametrised over both 2-byte dtypes.

Tolerance, as in `tests/test_torch_bf16.py`'s module note:
- every integer output and plane is exact;
- values the ops copy (insert_or_assign, insert_and_evict and its
  eviction stream, find_or_insert and its readback, find, find_rows,
  assign, export_batch, lookup_train's rows) are bit-identical;
- values the ops compute (assign_add, accum_or_assign, update_rows,
  apply_grads) are held within F16_TOL elementwise: |got - want| <= 2^-9 *
  max(|want|, 1), two float16 ulps at magnitude 1 to 2 (BF16_TOL on a
  bfloat16 plane).  XLA on the CPU keeps float32 inside a fused float16 op
  and rounds a Python scalar to float16, where torch rounds each op's
  result to float16 and keeps a Python scalar in float32, so single
  roundings differ by an ulp, and an optimizer step rounds twice in a row
  (the step, then the row less the step), so two can add up.  The runs
  here reach 2^-9 relative, the bound itself, in update_rows' optimizer
  steps (the bfloat16 runs likewise reach BF16_TOL, in apply_grads).
  After a computed op the port continues from the reference's state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import normalize_keys as jax_keys  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.core.tiered import TieredHKVTable as JaxTiered  # noqa: E402
from repro.embedding.dynamic import HKVEmbedding as JaxEmbedding  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JaxOpt  # noqa: E402
from repro.kernels import ops as jk  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.core.tiered import TieredHKVTable  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.kernels import ops as pk  # noqa: E402

from test_torch_bf16 import (BF16, BF16_TOL, OPTIMIZERS, TORCH_DTYPE, HalfReplay,  # noqa: E402
                             assert_bits, assert_close, run_find_or_insert_promotes,
                             run_kernel_paths, run_op_sequence, run_rounding_points,
                             run_update_rows)

F16 = np.dtype(np.float16)
F16_TOL = 2.0 ** -9
# each 2-byte dtype's numpy dtype and its tolerance for computed values
HALF = {"bf16": (np.dtype(BF16), BF16_TOL), "f16": (F16, F16_TOL)}
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


# -- test_torch_bf16.py's cases on float16 -----------------------------------


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_f16_op_sequence_matches_jax(policy, dual):
    """Every op of the handle on a float16 table, past λ 1.0 (test_torch_bf16's
    sequence)."""
    run_op_sequence(HalfReplay(policy, dual, seed=500 + 2 * dual + (policy == "lfu"),
                               dtype=F16, tol=F16_TOL))


@pytest.mark.parametrize("dim", [8, 257])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_f16_update_rows_matches_jax(opt_name, dim):
    """update_rows on a float16 table: the plain path, the fused and the
    composed stages bit for bit each other, within F16_TOL of the
    reference."""
    run_update_rows(opt_name, dim, F16, F16_TOL)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_f16_kernel_paths_match_jax_kernels(dual):
    """The reference's Pallas kernels (interpret mode) on a float16 table:
    find, insert_and_evict's stream and find_or_insert's readback bit for
    bit."""
    run_kernel_paths(dual, F16)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_f16_find_or_insert_with_float32_init_matches_jax(dual):
    """float32 init rows on a float16 table: float32 rows, bit for bit the
    reference's, through the handle, core.ops and the kernel wrapper."""
    run_find_or_insert_promotes(dual, F16)


@pytest.mark.parametrize("dim", [8, 33, 257])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_f16_rounding_points_are_the_kernels(opt_name, dim):
    """update_scan's rounding formula (float32 arithmetic, rounded to
    float16 where the plain version's float16 ops round) equals
    SparseOptimizer.apply on a float16 row bit for bit."""
    run_rounding_points(opt_name, dim, torch.float16)


def test_f16_convert_round_trips():
    """float16 planes, batches and states cross both ways bit for bit (NaN,
    infinities, -0 and subnormals included)."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(256, 6)).astype(F16)
    a[:5, 0] = [np.nan, np.inf, -0.0, 6e-8, 65504]
    t = convert.values_from_numpy(a)
    assert t.dtype == torch.float16
    assert_bits(convert.values_to_numpy(t), a, "float16")
    assert_bits(convert.values_from_numpy(jnp.asarray(a)), a, "float16 from JAX")
    jt = JaxTable.create(backend="jnp", capacity=256, dim=4, aux_value_dim=2,
                         value_dtype=jnp.float16)
    keys = np.arange(1, 300, dtype=np.uint64)
    jt = jt.insert_or_assign(jax_keys(keys), jnp.asarray(rng.normal(size=(299, 4)).astype(F16))).table
    ps = convert.state_from_arrays(jt.state, device="cpu")
    assert ps.values.dtype == torch.float16
    back = convert.state_to_arrays(ps)
    for f in convert.FIELDS:
        if f == "values":
            assert back[f].dtype == F16
            assert_bits(back[f], jt.state.values, f)
        else:
            np.testing.assert_array_equal(back[f], np.asarray(getattr(jt.state, f)), err_msg=f)


# -- cases test_torch_bf16.py lacks, on both 2-byte dtypes ----------------------

DTYPES = {"f32": np.dtype(np.float32), **{k: v[0] for k, v in HALF.items()}}


@pytest.mark.parametrize("init", sorted(DTYPES))
@pytest.mark.parametrize("plane", ["bf16", "f16"])
def test_find_or_insert_rows_promote_as_jax(plane, init):
    """find_or_insert's rows on a bfloat16 or float16 table with init rows
    of each dtype: the dtype the reference's ``jnp.where`` promotes to
    (bfloat16 with float16 is float32) and its bits, hits and rejected
    lanes alike; the planes bit for bit."""
    pdt, idt = DTYPES[plane], DTYPES[init]
    rng = np.random.default_rng(11)
    kw = dict(capacity=128, dim=4, buckets_per_key=2)
    jt = JaxTable.create(backend="jnp", value_dtype=pdt, **kw)
    pt = repro_torch.HKVTable.create(device="cpu", value_dtype=TORCH_DTYPE[pdt], **kw)
    keys = rng.integers(1, 2**50, size=160).astype(np.uint64)
    vals = rng.normal(size=(160, 4)).astype(pdt)
    jt = jt.insert_or_assign(jax_keys(keys), jnp.asarray(vals)).table
    pt.insert_or_assign(keys, vals)
    mix = np.concatenate([keys[:40], rng.integers(2**50, 2**60, size=200).astype(np.uint64)])
    init_rows = rng.normal(size=(mix.size, 4)).astype(idt)
    jr = jt.find_or_insert(jax_keys(mix), jnp.asarray(init_rows))
    pr = pt.find_or_insert(mix, convert.values_from_numpy(init_rows))
    want = np.asarray(jr.values)
    got = convert.values_to_numpy(pr.values)
    assert got.dtype == want.dtype == np.result_type(jnp.promote_types(pdt, idt))
    assert_bits(got, want, f"{plane} plane, {init} init")
    status = pr.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jr.status))
    assert (status == 4).any() and pr.found.any()      # rejected lanes and hits
    assert_bits(convert.state_to_arrays(pt.state)["values"], jr.table.state.values, "plane")


EMB_CASES = [("bf16", "hbm"), ("f16", "hbm"), ("f16", "hmem")]


@pytest.mark.parametrize("dtype,tier", EMB_CASES, ids=[f"{d}-{t}" for d, t in EMB_CASES])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_half_embedding_train_steps_match_jax(opt_name, dtype, tier):
    """HKVEmbedding(value_dtype=...) steps of lookup_train and apply_grads
    over batches past the table's capacity: lookup_train's rows and
    lookup_serve bit for bit, the state's integer planes exact, the trained
    values within the tolerance (then taken over from the reference).  The
    port's 'hmem' plane is held against the reference's device-memory
    table, whose results do not depend on the tier."""
    ndt, tol = HALF[dtype]
    dim = 8
    kw = dict(capacity=2 * 128, dim=dim, buckets_per_key=2)
    jemb = JaxEmbedding(optimizer=JaxOpt(opt_name, lr=0.05), backend="jnp", value_dtype=ndt,
                        **kw)
    pemb = HKVEmbedding(optimizer=SparseOptimizer(opt_name, lr=0.05),
                        value_dtype=TORCH_DTYPE[ndt], value_tier=tier, **kw)
    jt, pt = jemb.create(), pemb.create(device="cpu")
    rng = np.random.default_rng(21 + OPTIMIZERS.index(opt_name))
    for step in range(3):
        toks = rng.integers(-3, 400, size=(48, 4)).astype(np.int32)
        toks[:, 3] = toks[:, 0]                      # repeated tokens in a batch
        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, prows = pemb.lookup_train(pt, torch.from_numpy(toks))
        ctx = f"{dtype} {tier} {opt_name} step {step}"
        assert prows.dtype == TORCH_DTYPE[ndt]
        assert_bits(prows, jrows, f"{ctx} rows")
        _state_eq(jt.state, pt.state, f"{ctx} lookup_train")
        grads = rng.normal(size=(48, 4, dim)).astype(np.float32)
        jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.asarray(grads))
        pt = pemb.apply_grads(pt, torch.from_numpy(toks), torch.from_numpy(grads))
        _state_eq(jt.state, pt.state, f"{ctx} apply_grads", ndt, tol)
        pt.state.values.copy_(convert.values_from_numpy(jt.state.values))
        serve = rng.integers(-1, 600, size=(30,)).astype(np.int32)
        assert_bits(pemb.lookup_serve(pt, torch.from_numpy(serve)),
                    jemb.lookup_serve(jt, jnp.asarray(serve)), f"{ctx} lookup_serve")


def _state_eq(js, ps, ctx, dtype=None, tol=None):
    """Integer planes exact; values bit for bit, or within `tol`."""
    got = convert.state_to_arrays(ps)
    for f in convert.FIELDS:
        if f != "values":
            np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)), err_msg=f"{ctx}: {f}")
        elif tol is None:
            assert_bits(got[f], js.values, f"{ctx}: values")
        else:
            assert_close(got[f], js.values, f"{ctx}: values", dtype, tol)


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_tiered_table_matches_jax(dtype):
    """A TieredHKVTable of a 2-byte dtype (hot tier in device memory, cold
    on 'hmem'): insert_or_assign past the hot tier, find_or_insert with
    the plane's init rows and with float32 ones, find with promotion;
    every output (its dtype too) and both tiers' planes bit for bit."""
    ndt = HALF[dtype][0]
    rng = np.random.default_rng(31)
    kw = dict(hot_capacity=2 * 128, cold_capacity=8 * 128, dim=4)
    jt = JaxTiered.create(value_dtype=ndt, **kw)
    pt = TieredHKVTable.create(device="cpu", value_dtype=TORCH_DTYPE[ndt], **kw)

    def same(pr, jr, fields, ctx):
        for f in fields:
            got, want = getattr(pr, f), getattr(jr, f)
            if f == "values":
                assert got.dtype == TORCH_DTYPE[ndt], ctx
                assert_bits(got, want, f"{ctx}: values")
            else:
                got = got.numpy() if isinstance(got, torch.Tensor) else got
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{ctx}: {f}")
        for tier in ("hot", "cold"):
            _state_eq(getattr(jr.table, tier).state, getattr(pt, tier).state, f"{ctx}: {tier}")

    seen = []
    for step in range(4):
        keys = rng.integers(1, 2**40, size=200).astype(np.uint64)
        seen.append(keys)
        vals = rng.normal(size=(200, 4)).astype(ndt)
        jr = jt.insert_or_assign(keys, jnp.asarray(vals))
        pr = pt.insert_or_assign(keys, vals)
        jt = jr.table
        same(pr, jr, ("status", "demoted", "dropped", "ok"), f"insert_or_assign {step}")
    mix = np.concatenate([keys[:60], rng.integers(2**40, 2**50, size=60).astype(np.uint64)])
    init = rng.normal(size=(mix.size, 4)).astype(ndt)
    jr = jt.find_or_insert(mix, jnp.asarray(init))
    pr = pt.find_or_insert(mix, init)
    jt = jr.table
    same(pr, jr, ("values", "found", "status", "promoted", "demoted", "dropped", "ok"),
         "find_or_insert")
    # float32 init rows: the hierarchy admits them padded to the plane's
    # dtype and returns that dtype, as the reference does
    mix = np.concatenate([seen[1][:60], rng.integers(2**50, 2**60, size=60).astype(np.uint64)])
    jr = jt.find_or_insert(mix, jnp.asarray(init.astype(np.float32) / 3))
    pr = pt.find_or_insert(mix, init.astype(np.float32) / 3)
    jt = jr.table
    same(pr, jr, ("values", "found", "status", "promoted", "demoted", "dropped", "ok"),
         "find_or_insert with float32 init rows")
    old = rng.choice(np.concatenate(seen[:2]), size=100)     # many demoted to the cold tier
    jr = jt.find(old)
    pr = pt.find(old)
    same(pr, jr, ("values", "found", "hot_hit", "promoted", "demoted", "dropped"), "find")
    assert int(pr.promoted) > 0


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_kernel_wrappers_match_jax(dtype, dual):
    """The kernel-backed wrappers (find_kernel, find_composed_kernel,
    upsert_kernel, insert_and_evict_kernel, find_or_insert_kernel) on a
    table of a 2-byte dtype against the reference's, its Pallas kernels in
    interpret mode, at its tests' small sizes: statuses, found flags,
    values, eviction streams and the state bit for bit after every batch."""
    ndt = HALF[dtype][0]
    rng = np.random.default_rng(51 + dual)
    kw = dict(capacity=2 * 128, dim=4, buckets_per_key=2 if dual else 1)
    cfg_j = jtable.HKVConfig(value_dtype=ndt, **kw)
    cfg_p = ptable.HKVConfig(value_dtype=TORCH_DTYPE[ndt], **kw)
    sj, sp = jtable.create(cfg_j), ptable.create(cfg_p, "cpu")
    for step in range(3):
        keys = rng.integers(0, 2**12, size=160).astype(np.uint64)
        keys[rng.integers(0, 160, size=8)] = EMPTY
        vals = rng.normal(size=(160, 4)).astype(ndt)
        jkeys, pkeys = ju64.from_uint64(keys), pu64.from_numpy_u64(keys)
        ctx = f"{dtype} step {step}"
        rj = jk.upsert_kernel(sj, cfg_j, jkeys, jnp.asarray(vals), interpret=True)
        rp = pk.upsert_kernel(sp, cfg_p, pkeys, convert.values_from_numpy(vals))
        sj = rj.state
        np.testing.assert_array_equal(rp.status.numpy(), np.asarray(rj.status), err_msg=ctx)
        _state_eq(sj, sp, f"{ctx} upsert_kernel")
        vals = rng.normal(size=(160, 4)).astype(ndt)
        rj = jk.insert_and_evict_kernel(sj, cfg_j, jkeys, jnp.asarray(vals), interpret=True)
        rp = pk.insert_and_evict_kernel(sp, cfg_p, pkeys, convert.values_from_numpy(vals))
        sj = rj.state
        np.testing.assert_array_equal(rp.status.numpy(), np.asarray(rj.status), err_msg=ctx)
        got = convert.stream_to_arrays(rp.evicted)
        for f in ("key_hi", "key_lo", "score_hi", "score_lo", "mask"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(rj.evicted, f)),
                                          err_msg=f"{ctx}: evicted.{f}")
        assert_bits(got["values"], rj.evicted.values, f"{ctx}: evicted.values")
        _state_eq(sj, sp, f"{ctx} insert_and_evict_kernel")
        init = rng.normal(size=(160, 4)).astype(ndt)
        sj, jv, jf, jst = jk.find_or_insert_kernel(sj, cfg_j, jkeys, jnp.asarray(init),
                                                   interpret=True)
        _, pv, pf, pst = pk.find_or_insert_kernel(sp, cfg_p, pkeys, convert.values_from_numpy(init))
        assert pv.dtype == TORCH_DTYPE[ndt]
        assert_bits(pv, jv, f"{ctx}: find_or_insert values")
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf), err_msg=ctx)
        np.testing.assert_array_equal(pst.numpy(), np.asarray(jst), err_msg=ctx)
        _state_eq(sj, sp, f"{ctx} find_or_insert_kernel")
        q = np.concatenate([keys[:80], rng.integers(2**50, 2**60, size=40).astype(np.uint64)])
        jq, pq = ju64.from_uint64(q), pu64.from_numpy_u64(q)
        v_new, f_new = pk.find_kernel(sp, cfg_p, pq)
        v_old, f_old = pk.find_composed_kernel(sp, cfg_p, pq)
        assert torch.equal(f_new, f_old) and v_new.dtype == v_old.dtype == TORCH_DTYPE[ndt]
        assert_bits(v_new, v_old, f"{ctx}: find_kernel against find_composed_kernel")
        for fn in (jk.find_kernel, jk.find_composed_kernel):
            jv, jf = fn(sj, cfg_j, jq, interpret=True)
            np.testing.assert_array_equal(f_new.numpy(), np.asarray(jf), err_msg=fn.__name__)
            assert_bits(v_new, jv, f"{ctx}: {fn.__name__}")
        assert f_new.any() and not f_new.all()
    assert int(sp.load_factor() * 100) == 100


def test_f16_eps_below_float16_is_zero_in_both():
    """rowwise_adagrad on float16 rows whose squared gradients underflow (a
    DLRM step's, ~1e-9): with the default eps (1e-10, 0 in float16) both
    packages divide by zero and the rows leave the finite range (the port
    gives -inf, the reference NaN: its ``p + (p - p)`` rounding pin turns
    an infinite product into NaN); with float16's smallest normal as eps
    both give the same finite rows."""
    rows = np.zeros((4, 33), F16)
    rows[:, :32] = 0.1
    g = np.full((4, 32), 3e-5, np.float32)
    for eps, finite in ((1e-10, False), (2.0 ** -14, True)):
        want = np.asarray(JaxOpt("rowwise_adagrad", lr=0.01, eps=eps).apply(
            jnp.asarray(rows), jnp.asarray(g), 32))
        got = SparseOptimizer("rowwise_adagrad", lr=0.01, eps=eps).apply(
            torch.from_numpy(rows), torch.from_numpy(g), 32)
        assert bool(torch.isfinite(got).all()) == finite == bool(np.isfinite(want).all())
        if finite:
            assert_bits(got, want, f"eps {eps}")
        else:
            assert bool(torch.isneginf(got[:, :32]).all()) and np.isnan(want[:, :32]).all()
