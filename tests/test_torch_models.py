"""The port's model zoo primitives against the JAX package's, on the CPU:
``repro_torch.models.ssm`` (the chunked GLA, its step and its sequential
oracle), ``models.moe`` (capacity, the sort dispatch and combine, the aux
losses), ``models.common``'s M-RoPE and sinusoidal positions, and
``models.blocks``' training path for the mamba2, mlstm and slstm kinds and
the attention block with a MoE FFN and with M-RoPE.

Parameters are drawn by the reference and carried across with
``convert.lm_params_from_jax``; inputs are made with numpy.  The JAX side's
gradients are jitted (eager dispatch compiles op by op, ten times slower).

Tolerances, with their reasons: XLA and torch sum the products and
reductions in other orders, so outputs are held within a relative 2e-6 of
their largest magnitude and gradients within 2e-5 of each leaf's largest
magnitude (``tests/test_torch_lm.py``'s bounds); the MoE's combine with
top_k = 3 adds three gated rows to a token in index order on both sides,
but from the sorted dispatch order, so it stays within the same bounds.
The chunked GLA against the sequential oracle (another algorithm) is held
at 1e-4, as ``tests/test_models.py:119`` holds the reference's.  With
top_k = 1 the router's gradient through the gate is float32 rounding alone
(the gate is g / g): held within an absolute 5e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.models import blocks, common, moe, ssm  # noqa: E402

OUT_RTOL = 2e-6
GRAD_RTOL = 2e-5
ORACLE_TOL = 1e-4
TOP1_ROUTER_ATOL = 5e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, ctx):
    got, want = _np(got).astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, ctx
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), f"{ctx}: {err}"


def _dropped_close(aux, jaux):
    """The dropped fraction, 1 - a mean of 0/1 flags: XLA's jitted mean
    rounds it within an ulp of 1 (2^-24) where the exact value is 0."""
    np.testing.assert_allclose(float(aux["dropped_frac"]), float(jaux["dropped_frac"]), rtol=0,
                               atol=2.0 ** -23)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _gla_inputs(seed, b=2, s=37, h=3, n=8, p=5):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, h, n)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, s, h, p)).astype(np.float32)
    log_a = (-np.abs(rng.normal(size=(b, s, h))) * 0.2).astype(np.float32)
    return q, k, v, log_a


# =============================================================================
# ssm
# =============================================================================


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_gla_equals_the_reference_and_the_oracle(chunk):
    """Outputs, final state and the gradients of q, k, v and log_a (an
    uneven S = 37: the last chunk padded with log a = 0)."""
    q, k, v, log_a = _gla_inputs(4)
    rng = np.random.default_rng(5)
    dy = rng.normal(size=v.shape).astype(np.float32)
    ds = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)

    jf = lambda *a: jssm.chunked_gla(*a, chunk=chunk)  # noqa: E731
    (jy, jst), jgrads = jax.jit(lambda *a: (lambda o, vjp: (o, vjp((jnp.asarray(dy),
                                                                   jnp.asarray(ds)))))(
        *jax.vjp(jf, *a)))(*(jnp.asarray(x) for x in (q, k, v, log_a)))

    ins = [_t(x).requires_grad_() for x in (q, k, v, log_a)]
    y, st = ssm.chunked_gla(*ins, chunk=chunk)
    grads = torch.autograd.grad((y, st), ins, (_t(dy), _t(ds)))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, jy, OUT_RTOL, "y")
    _close(st, jst, OUT_RTOL, "state")
    for name, g, jg in zip(("dq", "dk", "dv", "dlog_a"), grads, jgrads):
        _close(g, jg, GRAD_RTOL, name)

    y_ref, st_ref = ssm.gla_reference(*(_t(x) for x in (q, k, v, log_a)))
    jy_ref, jst_ref = jssm.gla_reference(*(jnp.asarray(x) for x in (q, k, v, log_a)))
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=ORACLE_TOL, atol=ORACLE_TOL)
    np.testing.assert_allclose(_np(st), _np(st_ref), rtol=ORACLE_TOL, atol=ORACLE_TOL)
    _close(y_ref, jy_ref, OUT_RTOL, "oracle y")
    _close(st_ref, jst_ref, OUT_RTOL, "oracle state")


def test_chunked_gla_initial_state_and_bfloat16():
    """A carried initial state against the reference; and bfloat16
    operands, whose products stay float32 (y in bfloat16, the state
    float32).  XLA's CPU backend refuses a BF16 x BF16 = F32 dot, so the
    bfloat16 run is held against the port's float32 run on the same
    bfloat16-rounded operands: the scores, the decayed q and k and the
    state round to bfloat16 before their products, within a few of its
    ulps."""
    q, k, v, log_a = _gla_inputs(6, s=20)
    s0 = np.random.default_rng(7).normal(size=(2, 3, 8, 5)).astype(np.float32)
    jy, jst = jssm.chunked_gla(*(jnp.asarray(x) for x in (q, k, v, log_a)), chunk=8,
                               initial_state=jnp.asarray(s0))
    y, st = ssm.chunked_gla(*(_t(x) for x in (q, k, v, log_a)), chunk=8, initial_state=_t(s0))
    _close(y, jy, OUT_RTOL, "y")
    _close(st, jst, OUT_RTOL, "state")
    tb = [_t(x).to(torch.bfloat16) for x in (q, k, v)]
    y, st = ssm.chunked_gla(*tb, _t(log_a), chunk=8)
    y32, st32 = ssm.chunked_gla(*(x.float() for x in tb), _t(log_a), chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(y.float(), y32, 4 * 2.0 ** -8, "bf16 y")
    _close(st, st32, 4 * 2.0 ** -8, "bf16 state")


def test_gla_step_equals_the_reference():
    rng = np.random.default_rng(8)
    st = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    q, k = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 3, 5)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(2, 3)))).astype(np.float32)
    jy, jst = jssm.gla_step(*(jnp.asarray(x) for x in (st, q, k, v, la)))
    y, st2 = ssm.gla_step(*(_t(x) for x in (st, q, k, v, la)))
    _close(y, jy, OUT_RTOL, "y")
    _close(st2, jst, OUT_RTOL, "state")


# =============================================================================
# moe
# =============================================================================


def test_capacity_equals_the_reference():
    for e, k, cf in ((4, 2, 1.25), (64, 6, 1.25), (128, 1, 1.25), (4, 2, 0.25), (8, 3, 2.0)):
        jc, tc = jmoe.MoECfg(e, k, 16, 8, capacity_factor=cf), moe.MoECfg(e, k, 16, 8,
                                                                         capacity_factor=cf)
        for t in (1, 7, 8, 63, 64, 100, 1000, 32768, 10**6):
            assert moe.capacity(tc, t) == jmoe.capacity(jc, t), (e, k, cf, t)


MOE_CASES = {
    "top2": dict(num_experts=4, top_k=2, d_model=16, d_ff=32),
    "drops": dict(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=0.25),
    "top3_gelu": dict(num_experts=8, top_k=3, d_model=16, d_ff=24, act="gelu", gated=False),
    "top1": dict(num_experts=4, top_k=1, d_model=16, d_ff=32),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_equals_the_reference(case):
    """y, the three aux values, and the gradients of x and every parameter
    through y and the two weighted aux losses."""
    kw = MOE_CASES[case]
    jcfg, tcfg = jmoe.MoECfg(**kw), moe.MoECfg(**kw)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(64, kw["d_model"])).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def jobj(p, x):
        y, aux = jmoe.moe_apply(jcfg, p, x)
        return jnp.sum(y * dy) + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"], (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jobj, argnums=(0, 1),
                                                             has_aux=True))(jp, jnp.asarray(x))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(tp)]
    xt = _t(x).requires_grad_()
    y, aux = moe.moe_apply(tcfg, tree.unflatten(tp, leaves), xt)
    obj = torch.sum(y * _t(dy)) + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
    *gp, gx = torch.autograd.grad(obj, leaves + [xt])
    _close(y, jy, OUT_RTOL, "y")
    for key in ("load_balance", "router_z"):
        _close(aux[key], jaux[key], OUT_RTOL, key)
    _dropped_close(aux, jaux)
    if case == "drops":
        assert float(aux["dropped_frac"]) > 0.5
    else:
        assert float(aux["dropped_frac"]) < 0.5
    _close(gx, jgx, GRAD_RTOL, "dx")
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgp)[0], gp):
        ctx = f"d{jax.tree_util.keystr(path)}"
        if kw["top_k"] == 1 and "router" in ctx:
            # one expert a token: the gate is g / g = 1, whose gradient
            # 1/g - g/g^2 is zero but for float32 rounding (~1e-7/g) that each
            # package adds through every token (~1e-6 here, beside the aux
            # losses' ~7e-4), in its own rounding
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOP1_ROUTER_ATOL,
                                       err_msg=ctx)
        else:
            _close(got, want, GRAD_RTOL, ctx)


def test_moe_top_k_ties_go_to_the_lower_index():
    """Equal router probabilities: the reference's top_k takes the lower
    expert index first; a zero router makes every probability equal."""
    cfg = moe.MoECfg(num_experts=4, top_k=2, d_model=8, d_ff=8)
    p = moe.moe_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn((16, 8), generator=torch.Generator().manual_seed(1))
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(p))
    jy, jaux = jmoe.moe_apply(jmoe.MoECfg(4, 2, 8, 8), jp, jnp.asarray(x.numpy()))
    y, aux = moe.moe_apply(cfg, p, x)
    _close(y, jy, OUT_RTOL, "y")
    _close(aux["load_balance"], jaux["load_balance"], OUT_RTOL, "load_balance")


# =============================================================================
# positions
# =============================================================================


def test_apply_mrope_and_sinusoidal_equal_the_reference():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 24, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 4096, size=(3, 2, 24)).astype(np.int32)
    for sec in ((2, 3, 3), jblocks._mrope_sections(16)):
        assert blocks._mrope_sections(16) == jblocks._mrope_sections(16)
        for theta in (1e4, 1e6):
            got = common.apply_mrope(_t(x), _t(pos3), theta, sec)
            want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta, sec)
            _close(got, want, OUT_RTOL, f"mrope {sec} {theta}")
    with pytest.raises(ValueError, match="head_dim/2"):
        common.apply_mrope(_t(x), _t(pos3), 1e4, (2, 2, 2))
    positions = np.broadcast_to(np.arange(4096, dtype=np.int32), (2, 4096))
    for d in (64, 1536):
        got = common.sinusoidal_embedding(_t(positions), d)
        want = jcommon.sinusoidal_embedding(jnp.asarray(positions), d)
        assert got.dtype == torch.float32
        # sin and cos of angles up to 4096: the libraries' float32 range
        # reductions differ by an ulp of the angle's magnitude
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=4096 * 2.0 ** -23)
    for d in (64,):
        pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
        _close(common.sinusoidal_embedding(_t(pos), d),
               jcommon.sinusoidal_embedding(jnp.asarray(pos), d), OUT_RTOL, "sinusoidal, 64")


# =============================================================================
# blocks
# =============================================================================


BLOCKS = {
    "mamba2": dict(kind="mamba2", d_model=32, d_state=8, ssm_heads=4, expand=2, conv_width=4),
    "mlstm": dict(kind="mlstm", d_model=32, ssm_heads=2, expand=2, qkv_block=4),
    "slstm": dict(kind="slstm", d_model=32, ssm_heads=4),
    "attn_moe": dict(kind="attn", d_model=32, heads=4, kv_heads=2, d_ff=0,
                     moe=("moe", dict(num_experts=4, top_k=2, d_model=32, d_ff=16))),
    "attn_mrope": dict(kind="attn", d_model=32, heads=2, kv_heads=1, head_dim=16, d_ff=64,
                       qkv_bias=True, rope="mrope", rope_theta=1e6),
}


def _block_cfgs(name):
    kw = dict(BLOCKS[name])
    jkw, tkw = dict(kw), dict(kw)
    if "moe" in kw:
        jkw["moe"], tkw["moe"] = jmoe.MoECfg(**kw["moe"][1]), moe.MoECfg(**kw["moe"][1])
    return jblocks.BlockCfg(**jkw), blocks.BlockCfg(**tkw)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_train_equals_the_reference(name):
    """block_train's output, aux and gradients (x and every parameter;
    the MoE's aux losses weighted in).  The GLA blocks run S = 150: two
    chunks of 128, the second padded."""
    jcfg, tcfg = _block_cfgs(name)
    b, s = 2, (150 if name in ("mamba2", "mlstm") else 24)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, s, 32)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    pos3 = np.stack([positions, positions // 4, positions % 7]).astype(np.int32)
    jp = jblocks.block_init(jcfg, jax.random.PRNGKey(12))
    jpos = jblocks.PosCtx(positions=jnp.asarray(positions), mrope_positions=jnp.asarray(pos3))

    def jobj(p, x):
        y, aux = jblocks.block_train(jcfg, p, x, jpos)
        extra = sum(w * aux[k] for k, w in (("load_balance", 0.01), ("router_z", 0.001))
                    if k in aux)
        return jnp.sum(y * dy) + extra, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jobj, argnums=(0, 1),
                                                             has_aux=True))(jp, jnp.asarray(x))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(jp)
    leaves = [p.requires_grad_() for p in tree.leaves(tp)]
    xt = _t(x).requires_grad_()
    tpos = blocks.PosCtx(positions=_t(positions), mrope_positions=_t(pos3))
    y, aux = blocks.block_train(tcfg, tree.unflatten(tp, leaves), xt, tpos)
    extra = sum(w * aux[k] for k, w in (("load_balance", 0.01), ("router_z", 0.001)) if k in aux)
    *gp, gx = torch.autograd.grad(torch.sum(y * _t(dy)) + extra, leaves + [xt])
    _close(y, jy, OUT_RTOL, "y")
    assert sorted(aux) == sorted(jaux)
    for k in set(aux) - {"dropped_frac"}:
        _close(aux[k], jaux[k], OUT_RTOL, k)
    if "dropped_frac" in aux:
        _dropped_close(aux, jaux)
    _close(gx, jgx, GRAD_RTOL, "dx")
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgp)[0], gp):
        _close(got, want, GRAD_RTOL, f"d{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_init_shapes_equal_the_reference(name):
    """The port's own draws: the reference's leaves, shapes and dtypes,
    and its constants (norms and biases zero, D one, dt_bias -2)."""
    jcfg, tcfg = _block_cfgs(name)
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jblocks.block_init(jcfg, jax.random.PRNGKey(0))))[0]
    own = blocks.block_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = tree.leaves(own)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, jax.tree_util.keystr(path)
    meta = blocks.block_init(tcfg, device="meta")
    assert [tuple(x.shape) for x in tree.leaves(meta)] == [w.shape for _, w in want]
    if name == "mamba2":
        assert not own["conv_b"].any() and not own["A_log"].any()
        assert (own["D"] == 1).all() and (own["dt_bias"] == -2).all()
