"""The port's dense optimizers (``repro_torch.optim``) against the JAX
package's on the same parameters and gradients, made with numpy, over
several steps, on a tree shaped as the LM's (dicts, lists, ``None`` slots,
stacked [repeats, count, ...] leaves).

Tolerances: adamw, adamw8bit and sgdm work element by element (adamw8bit's
block scales are an absmax, exact in any order) and are held bit for bit,
parameters and state.  adafactor's factored moments are row and column
means, reductions that XLA and torch sum in other orders: its parameters
and moments within a relative 1e-6 of each leaf's largest magnitude.  The
mirrors of the reference's `TestDenseOptimizers` follow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as J  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.optim import optimizers as T  # noqa: E402

NAMES = ("adamw", "adamw8bit", "adafactor", "sgdm")
RTOL = {"adamw": 0.0, "sgdm": 0.0, "adafactor": 1e-6, "adamw8bit": 0.0}
STEPS = 6


def _tree(rng):
    """An LM-shaped tree: a stacked segment, a norm, a None slot, a head."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"final_norm": f(33), "head": f(40, 24),
            "repeat": [{"ln1": f(2, 3, 33), "wq": f(2, 3, 33, 17)}, None],
            "shared": [None, {"wo": f(17, 33)}]}


def _close(got, want, rtol, ctx):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, ctx
    if not rtol or got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=ctx)
        return
    err = np.abs(got.astype(np.float64) - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), f"{ctx}: {err}"


def _run(name, p_np, grads_np, start=None):
    """STEPS updates on both packages: (jax params, jax state, port params,
    port state).  `start`: a JAX state to begin from (carried across)."""
    jo, to = getattr(J, name)(), getattr(T, name)()
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = convert.lm_params_from_jax(p_np, device="cpu")
    js = jo.init(jp) if start is None else start
    ts = to.init(tp) if start is None else convert.opt_state_from_jax(
        jax.tree.map(np.asarray, start), device="cpu")
    for g in grads_np:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = J.apply_updates(jp, ju)
        tu, ts = to.update(convert.lm_params_from_jax(g, device="cpu"), ts, tp)
        tp = T.apply_updates(tp, tu)
    return jp, js, tp, ts


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_jax_over_steps(name):
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jp, js, tp, ts = _run(name, p_np, grads)
    jl, tl = jax.tree.leaves(jp), tree.leaves(tp)
    assert len(jl) == len(tl) == 5
    for i, (a, b) in enumerate(zip(jl, tl)):
        _close(b, a, RTOL[name], f"{name} param leaf {i}")
    js_l, ts_l = jax.tree.leaves(js), tree.leaves(ts)
    assert len(js_l) == len(ts_l)
    for i, (a, b) in enumerate(zip(js_l, ts_l)):
        _close(b, a, RTOL[name], f"{name} state leaf {i}")


@pytest.mark.parametrize("name", NAMES)
def test_state_from_jax_continues_the_run(name):
    """A JAX optimizer state taken mid-run (two steps in) continues in the
    port as in the reference."""
    rng = np.random.default_rng(2)
    p_np = _tree(rng)
    first = [_tree(rng) for _ in range(2)]
    jp, js, _, _ = _run(name, p_np, first)
    rest = [_tree(rng) for _ in range(3)]
    jp2, js2, tp2, ts2 = _run(name, jax.tree.map(np.asarray, jp), rest, start=js)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jp2), tree.leaves(tp2))):
        _close(b, a, RTOL[name], f"{name} param leaf {i}")
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js2), tree.leaves(ts2))):
        _close(b, a, RTOL[name], f"{name} state leaf {i}")


@pytest.mark.parametrize("name", NAMES)
def test_quadratic_descent(name):
    opt = T.OPTIMIZERS[name]()
    params = {"w": torch.ones((64, 32)), "b": torch.ones((32,))}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(10):
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        g = torch.autograd.grad(loss(tree.unflatten(params, leaves)), leaves)
        upd, state = opt.update(tree.unflatten(params, list(g)), state, params)
        params = T.apply_updates(params, upd)
    assert float(loss(params)) < l0


def test_adamw8bit_moment_memory():
    state = T.adamw8bit().init({"w": torch.ones((1024, 256))})
    q = state["mu"]["w"]["q"]
    assert q.dtype == torch.int8
    assert q.numel() == 1024 * 256  # int8 vs f32: 4x moment memory saving
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
