"""The port's embedding layer against the JAX package: HKVEmbedding's key
and init derivation, lookup_train, lookup_serve and apply_grads (fed the
same gradients, made with numpy), DenseEmbedding, the DLRM configs and the
Zipfian key generator.

Tolerance: exact for every key, digest, score and init row, and for the
values under sgd, sgdm and adagrad, duplicated tokens included (both
packages sum a token's gradients in batch order on the CPU).  Under
rowwise_adagrad the row mean is a reduction taken in different orders,
so each step's values agree within a relative 1e-6 (see
test_torch_update.py), and the port's state is re-synced from the
reference's after each step so that the difference does not compound.
`DenseEmbedding.attend` is a matrix product, summed in different orders:
rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import hkv_dlrm as jconfigs  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.embedding.dense import DenseEmbedding as JaxDense  # noqa: E402
from repro.embedding.dynamic import HKVEmbedding as JaxEmbedding  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JaxOpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import hkv_dlrm as pconfigs  # noqa: E402
from repro_torch.data import synthetic as psynth  # noqa: E402
from repro_torch.embedding import DenseEmbedding, HKVEmbedding, SparseOptimizer  # noqa: E402

from test_torch_update import assert_state  # noqa: E402

OPTIMIZERS = ("sgd", "sgdm", "rowwise_adagrad", "adagrad")
DIM = 8


def _pair(opt_name, dual=True, capacity=2 * 128, lr=0.05):
    kw = dict(capacity=capacity, dim=DIM, buckets_per_key=2 if dual else 1)
    return (JaxEmbedding(optimizer=JaxOpt(opt_name, lr=lr), backend="jnp", **kw),
            HKVEmbedding(optimizer=SparseOptimizer(opt_name, lr=lr), **kw))


def _words(k):
    return ((np.asarray(k.hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(k.lo).astype(np.uint64)).view(np.int64)


def test_keys_of_and_default_rows_match():
    jemb, pemb = _pair("sgd")
    rng = np.random.default_rng(0)
    toks = rng.integers(-5, 2**31 - 1, size=(40, 3)).astype(np.int32)
    toks[0, :3] = [-1, 0, 2**31 - 1]
    jk = jemb.keys_of(jnp.asarray(toks))
    pk = pemb.keys_of(torch.from_numpy(toks))
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    np.testing.assert_array_equal(pemb.default_rows(pk).numpy(),
                                  np.asarray(jemb.default_rows(jk)))
    # int64 ids keep their low 32 bits, as the reference's uint32 cast does
    wide = np.array([2**40 + 7, 2**33, -3, 5], np.int64)
    want = np.where(wide < 0, -1, wide.astype(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(pemb.keys_of(torch.from_numpy(wide)).numpy(), want)
    # default rows of wide and EMPTY keys too
    keys = rng.integers(0, 2**64 - 1, size=64, dtype=np.uint64)
    keys[:2] = np.uint64(2**64 - 1)
    np.testing.assert_array_equal(
        pemb.default_rows(torch.from_numpy(keys.view(np.int64))).numpy(),
        np.asarray(jemb.default_rows(ju64.from_uint64(keys))))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("opt_name", OPTIMIZERS)
def test_train_steps_match_jax(opt_name, dual):
    """Steps of lookup_train, then apply_grads with the same gradients,
    over batches with repeated tokens, padding and more distinct tokens
    than slots (eviction and rejection): rows, the whole state, and
    lookup_serve on seen and unseen tokens."""
    jemb, pemb = _pair(opt_name, dual)
    jt, pt = jemb.create(), pemb.create(device="cpu")
    rng = np.random.default_rng(7 + dual)
    for step in range(4):
        toks = rng.integers(-3, 400, size=(48, 4)).astype(np.int32)
        toks[:, 3] = toks[:, 0]                      # repeated tokens in a batch
        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, prows = pemb.lookup_train(pt, torch.from_numpy(toks))
        ctx = f"{opt_name} step {step}"
        np.testing.assert_array_equal(prows.numpy(), np.asarray(jrows), err_msg=f"{ctx} rows")
        assert_state(jt.state, pt.state, "sgd", f"{ctx} lookup_train")
        grads = rng.normal(size=(48, 4, DIM)).astype(np.float32)
        jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.asarray(grads))
        assert pemb.apply_grads(pt, torch.from_numpy(toks), torch.from_numpy(grads)) is pt
        assert_state(jt.state, pt.state, opt_name, f"{ctx} apply_grads")
        if opt_name == "rowwise_adagrad":   # the difference must not compound
            pt.state.values.copy_(torch.from_numpy(np.array(jt.state.values)))
        serve = rng.integers(-1, 600, size=(30,)).astype(np.int32)
        np.testing.assert_array_equal(pemb.lookup_serve(pt, torch.from_numpy(serve)).numpy(),
                                      np.asarray(jemb.lookup_serve(jt, jnp.asarray(serve))),
                                      err_msg=f"{ctx} lookup_serve")


def test_apply_grads_trains_each_token_once():
    """One token in every lane: its row takes one sgd step with the batch's
    summed gradient, as the reference's."""
    jemb, pemb = _pair("sgd", lr=0.5)
    jt, pt = jemb.create(), pemb.create(device="cpu")
    toks = np.full((64,), 7, np.int32)
    jt, _ = jemb.lookup_train(jt, jnp.asarray(toks))
    pt, before = pemb.lookup_train(pt, torch.from_numpy(toks))
    grads = np.ones((64, DIM), np.float32)
    jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.asarray(grads))
    pemb.apply_grads(pt, torch.from_numpy(toks), torch.from_numpy(grads))
    after = pemb.lookup_serve(pt, torch.tensor([7]))
    np.testing.assert_array_equal(after.numpy(), np.asarray(jemb.lookup_serve(jt, jnp.asarray([7]))))
    torch.testing.assert_close(after[0], before[0] - 0.5 * 64.0, rtol=1e-5, atol=0)


def test_ingest_matches_jax():
    jemb, pemb = _pair("adagrad")
    jt, pt = jemb.create(), pemb.create(device="cpu")
    toks = np.random.default_rng(3).integers(-1, 900, size=300).astype(np.int32)
    jt = jemb.ingest(jt, jnp.asarray(toks))
    assert pemb.ingest(pt, torch.from_numpy(toks)) is pt
    assert_state(jt.state, pt.state, "adagrad", "ingest")


def test_state_carries_aux_columns():
    """convert carries V = dim + aux both ways: a rowwise_adagrad table's
    accumulator column survives the round trip."""
    jemb, pemb = _pair("rowwise_adagrad")
    jt = jemb.create()
    toks = jnp.asarray(np.arange(100, dtype=np.int32))
    jt, _ = jemb.lookup_train(jt, toks)
    jt = jemb.apply_grads(jt, toks, jnp.ones((100, DIM), jnp.float32))
    pt = pemb.wrap(convert.state_from_arrays(jt.state, device="cpu"))
    assert pt.state.values.shape[1] == DIM + 1 and bool((pt.state.values[:, DIM] > 0).any())
    back = convert.state_to_arrays(pt.state)
    np.testing.assert_array_equal(back["values"], np.asarray(jt.state.values))


def test_tiered_embedding_is_refused():
    """HKVEmbedding(hot_capacity=...) was refused until the tier hierarchy
    was ported; it now builds a TieredHKVTable that trains as the
    reference's does: three steps of lookup_train and apply_grads (sgdm,
    duplicated tokens, padding, more distinct tokens than the hot tier
    holds), the rows and both tiers' states exact after each step.  The
    port's cold tier is 'hmem'; the reference's keeps its values in device
    memory here (its 'hmem' placement on the CPU mixes memory spaces in one
    JAX op on this path, which some JAX versions refuse; no result depends
    on the placement)."""
    kw = dict(capacity=4 * 128, dim=DIM, hot_capacity=128)
    jemb = JaxEmbedding(optimizer=JaxOpt("sgdm", lr=0.05), backend="jnp",
                        cold_value_tier="hbm", **kw)
    pemb = HKVEmbedding(optimizer=SparseOptimizer("sgdm", lr=0.05), **kw)
    jt, pt = jemb.create(), pemb.create(device="cpu")
    rng = np.random.default_rng(12)
    for step in range(3):
        toks = rng.integers(-1, 400, size=(4, 50)).astype(np.int32)
        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, rows = pemb.lookup_train(pt, torch.from_numpy(toks))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"step {step}")
        g = rng.normal(size=rows.shape).astype(np.float32)
        jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.asarray(g))
        pemb.apply_grads(pt, torch.from_numpy(toks), torch.from_numpy(g))
        for tier in ("hot", "cold"):
            assert_state(getattr(jt, tier).state, getattr(pt, tier).state, "sgdm",
                         f"step {step} {tier}")
    assert pt.cold.size() > 0 and pt.cold.cfg.value_tier == "hmem"


def test_dense_embedding_matches_jax():
    rng = np.random.default_rng(1)
    jd = JaxDense(vocab=50, dim=DIM)
    params = {"table": jnp.asarray(rng.normal(size=(50, DIM)), jnp.float32)}
    pd = DenseEmbedding(50, DIM, device="cpu", generator=torch.Generator().manual_seed(0))
    pd.load_state_dict({"table": torch.from_numpy(np.array(params["table"]))})
    toks = rng.integers(0, 50, size=(6, 7))
    np.testing.assert_array_equal(pd.lookup(torch.from_numpy(toks)).detach().numpy(),
                                  np.asarray(jd.lookup(params, jnp.asarray(toks))))
    x = rng.normal(size=(5, DIM)).astype(np.float32)
    np.testing.assert_allclose(pd.attend(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jd.attend(params, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    w = DenseEmbedding(1000, 16, device="cpu", generator=torch.Generator().manual_seed(0)).table
    assert abs(float(w.detach().std()) - 0.25) < 0.02


@pytest.mark.parametrize("alpha", [0.99, 1.0, 1.2])
def test_zipf_keys_match_bit_for_bit(alpha):
    a = psynth.zipf_keys(np.random.default_rng(5), 5000, alpha, 10**6)
    b = jsynth.zipf_keys(np.random.default_rng(5), 5000, alpha, 10**6)
    assert a.dtype == np.uint64
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(psynth.zipf_ranks(np.random.default_rng(2), 100, alpha, 50),
                                  jsynth.zipf_ranks(np.random.default_rng(2), 100, alpha, 50))


def test_dlrm_configs_match():
    for name, jc in jconfigs.PAPER_CONFIGS.items():
        pc = pconfigs.PAPER_CONFIGS[name]
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        pe, je = pc.embedding(), jc.embedding()
        for f in ("capacity", "dim", "buckets_per_key", "score_policy", "value_tier"):
            assert getattr(pe, f) == getattr(je, f)
        assert dataclasses.asdict(pe.optimizer) == dataclasses.asdict(je.optimizer)
        assert dataclasses.asdict(pconfigs.scaled(pc, 2**13)) == \
            dataclasses.asdict(jconfigs.scaled(jc, 2**13))
    b = pconfigs.PAPER_CONFIGS["B"].embedding().config()
    assert (b.capacity, b.dim, b.total_value_dim, b.buckets_per_key, b.score_policy) == \
        (2**27, 32, 33, 2, "lru")
