"""A bfloat16 value plane through the port, against the JAX package.

The JAX package's value plane may be any dtype (`HKVConfig.value_dtype`);
its bfloat16 is `ml_dtypes.bfloat16`, which `repro_torch.convert` carries
to `torch.bfloat16` and back through a uint16 view, bit for bit.  The same
seeded batches (rounded to bfloat16 once, in numpy) go through both
packages, with a full state drain after every op.

Tolerance:
- every integer output and plane (keys, digests, scores, statuses,
  found flags, locates, eviction masks) is exact;
- values the ops copy (insert_or_assign, insert_and_evict and its
  eviction stream, find_or_insert and its readback, find, find_rows,
  assign, export_batch) are bit-identical;
- values the ops compute (assign_add, accum_or_assign, update_rows) are
  held within BF16_TOL elementwise: |got - want| <= 2^-6 * max(|want|, 1),
  two bfloat16 ulps at magnitude 1 to 2.  XLA on the CPU keeps float32
  precision inside a fused bfloat16 op and rounds a Python scalar to
  bfloat16 (jnp's weak typing), where torch rounds each op's result to
  bfloat16 and keeps a Python scalar in float32, so single roundings
  differ by an ulp.  Rows the op did not compute stay bit-identical.  After
  a computed op the port continues from the reference's state, so that
  later copies are held bit for bit again.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import normalize_keys as jax_keys  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JaxOpt  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.embedding.sparse_opt import SparseOptimizer  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

from test_torch_ops import Replay, assert_locate_equal  # noqa: E402

BF16 = ml_dtypes.bfloat16
DIM, AUX = 4, 2
BF16_TOL = 2.0 ** -6


def _bits(x):
    """Value bits as uint16 (bfloat16) or uint32 (float32)."""
    x = convert.values_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def assert_bits(got, want, ctx):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=ctx)


def assert_close(got, want, ctx):
    """Within BF16_TOL (module note), and the same dtype."""
    got = convert.values_to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == BF16, ctx
    g, w = got.astype(np.float32), want.astype(np.float32)
    bad = np.abs(g - w) > BF16_TOL * np.maximum(np.abs(w), 1.0)
    assert not bad.any(), f"{ctx}: {int(bad.sum())} values past the tolerance, e.g. {g[bad][:4]} vs {w[bad][:4]}"


class Bf16Replay(Replay):
    """Test_torch_ops' replay on bfloat16 tables: the same key batches,
    value rows rounded to bfloat16."""

    def __init__(self, policy, dual, seed):
        self.policy, self.batch, self.capacity = policy, 192, 2 * 128
        self.rng = np.random.default_rng(seed)
        kw = dict(capacity=self.capacity, dim=DIM, buckets_per_key=2 if dual else 1,
                  score_policy=policy, aux_value_dim=AUX)
        self.jt = JaxTable.create(backend="jnp", value_dtype=jnp.bfloat16, **kw)
        self.pt = repro_torch.HKVTable.create(device="cpu", value_dtype=torch.bfloat16, **kw)

    def rows(self, width=DIM):
        return super().rows(width).astype(BF16)

    def check_state(self, ctx, computed=False):
        """The drained state: integer planes exact, values bit-identical
        (or, after a computed op, within BF16_TOL, and then taken over
        from the reference)."""
        got = convert.state_to_arrays(self.pt.state)
        for f in convert.FIELDS:
            if f != "values":
                np.testing.assert_array_equal(got[f], np.asarray(getattr(self.jt.state, f)),
                                              err_msg=f"{ctx}: state.{f}")
        if computed:
            assert_close(got["values"], self.jt.state.values, f"{ctx}: state.values")
            self.pt = repro_torch.HKVTable.wrap(
                convert.state_from_arrays(self.jt.state, device="cpu"), self.pt.cfg)
        else:
            assert_bits(got["values"], self.jt.state.values, f"{ctx}: state.values")

    def streams_equal(self, js, ps, ctx):
        got = convert.stream_to_arrays(ps)
        for f in ("key_hi", "key_lo", "score_hi", "score_lo", "mask"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)), err_msg=f"{ctx}: {f}")
        assert_bits(got["values"], js.values, f"{ctx}: evicted.values")


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_bf16_op_sequence_matches_jax(policy, dual):
    """insert_and_evict, find_or_insert (with its eviction stream), find,
    find_rows, find_ptr, contains, assign, assign_add, accum_or_assign,
    insert_or_assign and export_batch on a bfloat16 table, past λ 1.0."""
    r = Bf16Replay(policy, dual, seed=300 + 2 * dual + (policy == "lfu"))
    seen = set()
    for step in range(4):
        ctx = f"step {step}"
        keys = r.keys(step)
        vals = r.rows(DIM + AUX if step % 2 else DIM)
        jr = r.jt.insert_and_evict(jax_keys(keys), jnp.asarray(vals))
        pr = r.pt.insert_and_evict(keys, vals)
        r.jt = jr.table
        np.testing.assert_array_equal(pr.status.numpy(), np.asarray(jr.status), err_msg=ctx)
        r.streams_equal(jr.evicted, pr.evicted, ctx + " insert_and_evict")
        seen.update(pr.status.tolist())
        r.check_state(ctx + " insert_and_evict")

        mix = r.keys(step + 1)
        mix[: r.batch // 2] = keys[: r.batch // 2].astype(mix.dtype)
        init = r.rows()
        jr = r.jt.find_or_insert(jax_keys(mix), jnp.asarray(init), return_evicted=True)
        pr = r.pt.find_or_insert(mix, init, return_evicted=True)
        r.jt = jr.table
        assert pr.values.dtype == torch.bfloat16
        assert_bits(pr.values, jr.values, ctx + " find_or_insert values")
        for f in ("found", "status"):
            np.testing.assert_array_equal(getattr(pr, f).numpy(), np.asarray(getattr(jr, f)))
        r.streams_equal(jr.evicted, pr.evicted, ctx + " find_or_insert")
        r.check_state(ctx + " find_or_insert")

        jk = jax_keys(mix)
        jf, pf = r.jt.find(jk), r.pt.find(mix)
        assert_bits(pf.values, jf.values, ctx + " find")
        np.testing.assert_array_equal(pf.found.numpy(), np.asarray(jf.found))
        jf, pf = r.jt.find_rows(jk), r.pt.find_rows(mix)
        assert_bits(pf.rows, jf.rows, ctx + " find_rows")
        assert_locate_equal(r.jt.find_ptr(jk), r.pt.find_ptr(mix), ctx + " find_ptr")
        np.testing.assert_array_equal(r.pt.contains(mix).numpy(), np.asarray(r.jt.contains(jk)))

        upd = r.rows(DIM + AUX if step % 2 else DIM)
        r.jt = r.jt.assign(jk, jnp.asarray(upd))
        r.pt.assign(mix, upd)
        r.check_state(ctx + " assign")

        deltas = r.rows()
        r.jt = r.jt.assign_add(jk, jnp.asarray(deltas))
        r.pt.assign_add(mix, deltas)
        r.check_state(ctx + " assign_add", computed=True)

        k3, v3 = r.keys(step), r.rows()
        jr = r.jt.accum_or_assign(jax_keys(k3), jnp.asarray(v3))
        pr = r.pt.accum_or_assign(k3, v3)
        r.jt = jr.table
        np.testing.assert_array_equal(pr.status.numpy(), np.asarray(jr.status))
        r.check_state(ctx + " accum_or_assign", computed=True)

        k4, v4 = r.keys(step), r.rows()
        jr = r.jt.insert_or_assign(jax_keys(k4), jnp.asarray(v4))
        pr = r.pt.insert_or_assign(k4, v4)
        r.jt = jr.table
        np.testing.assert_array_equal(pr.status.numpy(), np.asarray(jr.status))
        r.check_state(ctx + " insert_or_assign")

        b = r.pt.num_buckets
        je, pe = r.jt.export_batch(0, b), r.pt.export_batch(0, b)
        got = convert.export_to_arrays(pe)
        for f in ("key_hi", "key_lo", "score_hi", "score_lo", "mask"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(je, f)), err_msg=f)
        assert_bits(got["values"], je.values, ctx + " export_batch")
    assert {pops.STATUS_EVICTED, pops.STATUS_REJECTED} & seen


def test_convert_round_trips():
    """bfloat16 and float32 planes, batches, streams and exports cross
    both ways bit for bit (NaN, infinities, -0 and subnormals included);
    the state's other fields are untouched."""
    rng = np.random.default_rng(1)
    f32 = rng.normal(size=(256, 6)).astype(np.float32)
    f32[:4, 0] = [np.nan, np.inf, -0.0, 1e-40]
    for a in (f32, f32.astype(BF16)):
        t = convert.values_from_numpy(a)
        assert t.dtype == (torch.bfloat16 if a.dtype == BF16 else torch.float32)
        assert_bits(convert.values_to_numpy(t), a, str(a.dtype))
        assert_bits(convert.values_from_numpy(jnp.asarray(a)), a, f"{a.dtype} from JAX")
    jt = JaxTable.create(backend="jnp", capacity=256, dim=DIM, aux_value_dim=AUX,
                         value_dtype=jnp.bfloat16)
    keys = np.arange(1, 300, dtype=np.uint64)
    jt = jt.insert_or_assign(jax_keys(keys), jnp.asarray(rng.normal(size=(299, DIM)).astype(BF16))).table
    ps = convert.state_from_arrays(jt.state, device="cpu")
    assert ps.values.dtype == torch.bfloat16
    back = convert.state_to_arrays(ps)
    for f in convert.FIELDS:
        if f == "values":
            assert back[f].dtype == BF16
            assert_bits(back[f], jt.state.values, f)
        else:
            np.testing.assert_array_equal(back[f], np.asarray(getattr(jt.state, f)), err_msg=f)


OPTIMIZERS = ("sgd", "sgdm", "rowwise_adagrad", "adagrad")


@pytest.mark.parametrize("dim", [8, 257])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_bf16_update_rows_matches_jax(opt_name, dim):
    """update_rows on a bfloat16 table (dual bucket, past λ 1.0): the plain
    path, the fused stage (update_scan's plain version) and the composed
    one are bit-identical to each other and within BF16_TOL of the
    reference's jnp update_rows; found exact, untrained rows bit-identical."""
    rng = np.random.default_rng(40 + dim + OPTIMIZERS.index(opt_name))
    v = dim + JaxOpt(opt_name).aux_dim(dim)
    kw = dict(capacity=2 * 128, dim=dim, buckets_per_key=2, aux_value_dim=v - dim)
    jt = JaxTable.create(backend="jnp", value_dtype=jnp.bfloat16, **kw)
    for i in range(6):   # past λ 1.0; non-negative rows (adagrad accumulators)
        keys = rng.integers(1, 2**50, size=64).astype(np.uint64)
        jt = jt.insert_or_assign(jax_keys(keys),
                                 jnp.asarray(np.abs(rng.normal(size=(64, v))).astype(BF16))).table
    live = convert.state_from_arrays(jt.state, device="cpu").keys.reshape(-1)
    resident = live[live != -1].numpy().view(np.uint64)
    q = np.concatenate([rng.choice(resident, size=48, replace=False),
                        rng.integers(2**50, 2**60, size=16).astype(np.uint64),
                        np.full(4, np.uint64(2**64 - 1))])
    g = rng.normal(size=(q.size, dim)).astype(np.float32)
    jres = jops.update_rows(jt.state, jt.cfg, jax_keys(q), jnp.asarray(g),
                            JaxOpt(opt_name, lr=0.05), backend="jnp")
    before = convert.state_to_arrays(convert.state_from_arrays(jt.state, device="cpu"))["values"]
    trained = np.any(_bits(jres.state.values) != _bits(before), axis=1)
    opt = SparseOptimizer(opt_name, lr=0.05)
    pcfg = repro_torch.HKVTable.create(device="cpu", value_dtype=torch.bfloat16, **kw).cfg
    k = repro_torch.normalize_keys(q)
    results = {}
    for name, run in (
            ("plain", lambda s: pops.update_rows(s, pcfg, k, torch.from_numpy(g), opt,
                                                 backend="plain").found),
            ("fused", lambda s: kops.update_rows_kernel(s, pcfg, k, torch.from_numpy(g), opt).found),
            ("composed", lambda s: kops.update_composed_kernel(s, pcfg, k, torch.from_numpy(g),
                                                               opt).found)):
        ps = convert.state_from_arrays(jt.state, device="cpu")
        found = run(ps)
        np.testing.assert_array_equal(found.numpy(), np.asarray(jres.found), err_msg=name)
        got = convert.values_to_numpy(ps.values)
        assert_bits(got[~trained], np.asarray(jres.state.values)[~trained], f"{name}: untrained rows")
        assert_close(got, jres.state.values, f"{name}: values")
        results[name] = got
    assert 0 < int(found.sum()) < q.size and trained.any()
    for name in ("fused", "composed"):
        assert_bits(results[name], results["plain"], f"{name} against plain")


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_bf16_kernel_paths_match_jax_kernels(dual):
    """The reference's Pallas kernels (interpret mode) on a bfloat16 table,
    against the port: find (find_scan), insert_and_evict's stream and
    find_or_insert's readback (gather_rows); values bit-identical."""
    r = Bf16Replay("lfu", dual, seed=90 + dual)
    r.capacity, r.batch = 4 * 128, 64
    kw = dict(capacity=r.capacity, dim=DIM, buckets_per_key=2 if dual else 1,
              score_policy="lfu", aux_value_dim=AUX)
    r.jt = JaxTable.create(backend="jnp", value_dtype=jnp.bfloat16, **kw)
    r.pt = repro_torch.HKVTable.create(device="cpu", value_dtype=torch.bfloat16, **kw)
    for step in range(12):
        keys, vals = r.keys(step, unique=True), r.rows()
        r.jt = r.jt.insert_or_assign(jax_keys(keys), jnp.asarray(vals)).table
        r.pt.insert_or_assign(keys, vals)
    r.check_state("filled")
    r.jt = r.jt.with_backend("kernel")
    keys = r.keys(1)
    jf, pf = r.jt.find(jax_keys(keys)), r.pt.find(keys)
    assert_bits(pf.values, jf.values, "find")
    np.testing.assert_array_equal(pf.found.numpy(), np.asarray(jf.found))
    assert bool(pf.found.any())
    vals = r.rows()
    jr = r.jt.insert_and_evict(jax_keys(keys), jnp.asarray(vals))
    pr = r.pt.insert_and_evict(keys, vals)
    r.jt = jr.table
    np.testing.assert_array_equal(pr.status.numpy(), np.asarray(jr.status))
    r.streams_equal(jr.evicted, pr.evicted, "insert_and_evict")
    assert bool(pr.evicted.mask.any())
    r.check_state("insert_and_evict")
    mix = r.keys(2)
    mix[:20] = keys[:20]
    init = r.rows()
    jr = r.jt.find_or_insert(jax_keys(mix), jnp.asarray(init), return_evicted=True)
    pr = r.pt.find_or_insert(mix, init, return_evicted=True)
    r.jt = jr.table
    assert_bits(pr.values, jr.values, "find_or_insert values")
    r.streams_equal(jr.evicted, pr.evicted, "find_or_insert")
    r.check_state("find_or_insert")


@pytest.mark.parametrize("dim", [8, 33, 257])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_bf16_rounding_points_are_the_kernels(opt_name, dim):
    """The CUDA update_scan at bfloat16 computes each operation in float32
    and rounds to bfloat16 where the plain version's bfloat16 ops round,
    with lr, eps and momentum as float32 in products and sums and lr and
    dim rounded to bfloat16 where _div fills a tensor with them.  That
    formula, written out here in float32 with explicit roundings (the
    kernel runs only on the card), equals SparseOptimizer.apply on a
    bfloat16 row bit for bit."""
    from repro_torch.embedding.sparse_opt import tree_row_sum

    rng = np.random.default_rng(dim + OPTIMIZERS.index(opt_name))
    opt = SparseOptimizer(opt_name, lr=0.0137, momentum=0.9, eps=1e-10)
    v = dim + opt.aux_dim(dim)
    rows = torch.from_numpy(np.abs(rng.normal(size=(512, v))).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(512, dim)).astype(np.float32)).to(torch.bfloat16)
    want = opt.apply(rows, g, dim).to(torch.bfloat16)

    def rnd(x):
        return x.to(torch.bfloat16).float()

    def sqrt(x):   # __fsqrt_rn: the correctly rounded float32 root
        return torch.sqrt(x.double()).float()

    lr, eps, mom = (float(np.float32(a)) for a in (opt.lr, opt.eps, opt.momentum))
    e, aux, gf = rows[:, :dim].float(), rows[:, dim:].float(), g.float()
    if opt_name == "sgd":
        out = [rnd(e - rnd(lr * gf))]
    elif opt_name == "sgdm":
        m = rnd(rnd(mom * aux) + gf)
        out = [rnd(e - rnd(lr * m)), m]
    elif opt_name == "adagrad":
        acc = rnd(aux + rnd(gf * gf))
        den = rnd(rnd(sqrt(acc)) + eps)
        out = [rnd(e - rnd(torch.div(rnd(lr * gf), den))), acc]
    else:
        s = tree_row_sum(rnd(gf * gf).to(torch.bfloat16)).float()
        mean = rnd(torch.div(s, rnd(torch.tensor(float(dim)))))
        acc = rnd(aux[:, 0] + mean)
        den = rnd(rnd(sqrt(acc)) + eps)
        step = rnd(torch.div(rnd(torch.tensor(lr)), den))
        out = [rnd(e - rnd(step[:, None] * gf)), acc[:, None]]
    assert_bits(torch.cat(out, dim=1).to(torch.bfloat16), want, opt_name)
