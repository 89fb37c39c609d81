"""The port's LM serving half (``repro_torch.models``: `prefill`,
`decode_step`, `init_decode_state`, the blocks' decode paths and
`decode_attention`) against the JAX package's, on the CPU at the smoke
sizes.

Parameters are drawn by the reference and carried across with
``convert.lm_params_from_jax``; prompts and tokens are made with numpy.

  * For each of the ten archs: prefill of a 40-token prompt into a state
    of 48 positions (h2o-danube's window is 32 at smoke size, so its ring
    wraps with a shift of 8), its logits and every state leaf (the tree's
    paths, shapes and dtypes too), then 3 `decode_step`s' logits and
    states; qwen2-vl with its frontend embeddings and M-RoPE positions.
  * The ring layout: danube's caches after prefill hold position t in slot
    t % window, and prefill(t[:n-1]) then decode_step(t[n-1]) equals
    prefill(t) in logits and state (for every arch without a MoE, whose
    capacity differs between a prompt's tokens and a step's).
  * `decode_step(embeds=)` (gemma's embed_scale included) against the
    reference and against the same step from tokens.
  * `decode_attention`, both loop orders of its grouped form, against the
    reference's.
  * A reference state carried across (``convert.decode_state_from_jax``)
    decodes as the reference does, and comes back bit for bit.

Tolerances are tests/test_torch_lm.py's for gradients: each logit array
and state leaf within 2e-5 of its largest magnitude (zamba2's within 2e-4:
its float32 stack is ill-conditioned, ROADMAP queue 3), because XLA and
torch sum products in other orders.  Prefill-then-decode against a longer
prefill (one implementation, two orders of work) is held at the same
bounds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.models.common import decode_attention as jdecode_attention  # noqa: E402
from repro.models.lm import CompositeLM as JLM  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.models import blocks as blocks_mod  # noqa: E402
from repro_torch.models.common import decode_attention  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402

RTOL = 2e-5
RTOL_OF = {"zamba2-1.2b": 2e-4}
BATCH, PROMPT, MAX_LEN, STEPS = 2, 40, 48, 3
MOE_ARCHS = ("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b")


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """The JAX side compiled without most optimizations (compile time is
    most of its cost here)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _np(x):
    return convert.values_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, ctx):
    got, want = _np(got).astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, ctx
    if got.size:
        err = np.abs(got - want).max()
        assert err <= rtol * max(np.abs(want).max(), 1e-30), f"{ctx}: {err}"


def _paths(t, prefix=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _paths(t[k], f"{prefix}/{k}")]
    if isinstance(t, (list, tuple)):
        return [x for i, c in enumerate(t) for x in _paths(c, f"{prefix}/{i}")]
    return [(prefix, t)]


def _states_close(got, want, rtol, ctx):
    got, want = _paths(got), _paths(jax.tree.map(np.asarray, want))
    assert [p for p, _ in got] == [p for p, _ in want], ctx
    for (path, g), (_, w) in zip(got, want):
        assert _np(g).dtype == w.dtype, f"{ctx} {path}"
        _close(g, w, rtol, f"{ctx} {path}")


def _models(name):
    jm = JLM(jget(name).smoke)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, CompositeLM(get_arch(name).smoke), tp


def _prompt(cfg, b, s, seed=0):
    """Tokens, and the frontend inputs of a vision arch (8 patch embeddings,
    arange M-RoPE positions on all three axes) as (JAX's, the port's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    if cfg.frontend != "vision":
        return toks, {}, {}
    fe = rng.normal(size=(b, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return (toks, {"frontend_embeds": jnp.asarray(fe), "mrope_positions": jnp.asarray(pos)},
            {"frontend_embeds": torch.from_numpy(fe), "mrope_positions": torch.from_numpy(pos)})


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_equal_the_reference(name):
    jm, jp, tm, tp = _models(name)
    rtol = RTOL_OF.get(name, RTOL)
    toks, jx, tx = _prompt(tm.cfg, BATCH, PROMPT)
    jl, js = jax.jit(lambda p, t: jm.prefill(p, t, MAX_LEN, **jx))(jp, jnp.asarray(toks))
    tl, ts = tm.prefill(tp, torch.from_numpy(toks), MAX_LEN, **tx)
    _close(tl, jl, rtol, f"{name} prefill logits")
    _states_close(ts, js, rtol, f"{name} prefill state")
    assert int(ts["pos"]) == PROMPT and ts["pos"].dtype == torch.int32
    dec = jax.jit(jm.decode_step)
    rng = np.random.default_rng(1)
    for i in range(STEPS):
        nxt = rng.integers(0, tm.cfg.vocab, size=(BATCH,)).astype(np.int32)
        jl, js = dec(jp, jnp.asarray(nxt), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(nxt), ts)
        _close(tl, jl, rtol, f"{name} decode {i} logits")
        _states_close(ts, js, rtol, f"{name} decode {i} state")
    assert int(ts["pos"]) == PROMPT + STEPS


def test_init_decode_state_equals_the_reference():
    """Every kind's empty state (zamba2: mamba2 and the shared block's one
    cache a repeat; xlstm: mLSTM and sLSTM, m at -1e30), bit for bit."""
    for name in ("zamba2-1.2b", "xlstm-1.3b", "h2o-danube-1.8b"):
        jm, _, tm, _ = _models(name)
        want = jax.tree.map(np.asarray, jm.init_decode_state(BATCH, MAX_LEN))
        got = _paths(tm.init_decode_state(BATCH, MAX_LEN, device="cpu"))
        assert [p for p, _ in got] == [p for p, _ in _paths(want)]
        for (path, g), (_, w) in zip(got, _paths(want)):
            np.testing.assert_array_equal(_np(g), w, err_msg=f"{name} {path}")
    st = CompositeLM(get_arch("zamba2-1.2b").smoke).init_decode_state(1, 8, device="cpu")
    shared = st["repeat"][1]
    assert shared["k"].shape[:2] == (2, 1)   # one cache a repeat of the shared block


def test_ring_layout_past_the_window():
    """danube's caches are rings of `window` slots: after a prompt longer
    than the window, slot t % window holds position t's K and V (the
    reference's roll by (s - window) % window), and decoding past it keeps
    writing slot step % window."""
    _, _, tm, tp = _models("h2o-danube-1.8b")
    window = tm.cfg.segments[0].block.window
    assert PROMPT > window and (PROMPT - window) % window
    toks, _, _ = _prompt(tm.cfg, BATCH, PROMPT + STEPS)
    _, st = tm.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), MAX_LEN)
    assert st["repeat"][0]["k"].shape[3] == window
    for t in range(PROMPT, PROMPT + STEPS):
        _, st = tm.decode_step(tp, torch.from_numpy(toks[:, t]), st)
    _, want = tm.prefill(tp, torch.from_numpy(toks), MAX_LEN)
    for leaf in ("k", "v"):
        _close(st["repeat"][0][leaf], want["repeat"][0][leaf].numpy(), RTOL, leaf)
    # the first layer's keys depend on the tokens alone: slot t % window of
    # its ring holds position t's key, for the last `window` positions
    s = PROMPT + STEPS
    x, pos = tm._inputs(tp, torch.from_numpy(toks), None, None, None)
    lp = tree.map(lambda a: a[0, 0], tp["repeat"][0])
    _, k_all, _ = blocks_mod._qkv(tm.cfg.segments[0].block, lp, x, pos)
    for t in range(s - window, s):
        np.testing.assert_array_equal(_np(want["repeat"][0]["k"][0, 0][:, t % window]),
                                      _np(k_all[:, t]), err_msg=f"position {t}")


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES if n not in MOE_ARCHS])
def test_prefill_then_decode_equals_a_longer_prefill(name):
    """prefill(t[:n-1]) then decode_step(t[n-1]) against prefill(t): the
    caches, rings and recurrent states continue as the prompt would (the
    reference's tests/test_models.py check, at its archs and more)."""
    _, _, tm, tp = _models(name)
    rtol = RTOL_OF.get(name, RTOL)
    toks, _, tx = _prompt(tm.cfg, BATCH, PROMPT)
    cut = {k: (v if k == "frontend_embeds" else v[..., :-1]) for k, v in tx.items()}
    full_l, full_s = tm.prefill(tp, torch.from_numpy(toks), MAX_LEN, **tx)
    _, st = tm.prefill(tp, torch.from_numpy(toks[:, :-1]), MAX_LEN, **cut)
    dec_l, st = tm.decode_step(tp, torch.from_numpy(toks[:, -1]), st)
    _close(dec_l, full_l.numpy(), rtol, f"{name} logits")
    _states_close(st, tree.map(lambda a: a.numpy(), full_s), rtol, f"{name} state")


@pytest.mark.parametrize("name", ["gemma-2b", "qwen2-0.5b"])
def test_decode_with_embeds(name):
    """`embeds=` [B, 1, d] (scaled by sqrt(d) where the arch says so) equals
    the step from tokens whose rows they are, and the reference's step."""
    jm, jp, tm, tp = _models(name)
    toks, _, _ = _prompt(tm.cfg, BATCH, 8)
    nxt = np.array([3, 5], np.int32)
    embeds = tp["embed"]["table"][torch.from_numpy(nxt)][:, None]
    _, st = tm.prefill(tp, torch.from_numpy(toks), 16)
    st2 = tree.map(torch.clone, st)
    got, st = tm.decode_step(tp, None, st, embeds=embeds)
    from_tokens, st2 = tm.decode_step(tp, torch.from_numpy(nxt), st2)
    assert torch.equal(got, from_tokens)
    _, js = jm.prefill(jp, jnp.asarray(toks), 16)
    want, _ = jm.decode_step(jp, None, js, embeds=jnp.asarray(embeds.numpy()))
    _close(got, want, RTOL, f"{name} embeds")


@pytest.mark.parametrize("b, sc, hq, hkv, cur", [(2, 24, 4, 1, 17), (3, 16, 8, 4, 16),
                                                 (1, 20, 6, 6, 1), (4, 12, 4, 2, 9)])
def test_decode_attention_equals_the_reference(b, sc, hq, hkv, cur):
    """The grouped form one lane at a time (B <= Hkv) and one KV head at a
    time (B > Hkv) against the reference's."""
    rng = np.random.default_rng(b * 100 + sc)
    q = rng.normal(size=(b, 1, hq, 16)).astype(np.float32)
    k, v = (rng.normal(size=(b, sc, hkv, 16)).astype(np.float32) for _ in range(2))
    want = jdecode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(cur))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.tensor(cur, dtype=torch.int32))
    assert got.shape == q.shape
    _close(got, want, RTOL, "decode_attention")


def test_reference_state_carries_across():
    """xlstm (mLSTM and sLSTM states): the reference's prefill state carried
    into the port decodes as the reference does, and a port state goes to
    numpy and back bit for bit."""
    jm, jp, tm, tp = _models("xlstm-1.3b")
    toks, _, _ = _prompt(tm.cfg, BATCH, 12)
    _, js = jm.prefill(jp, jnp.asarray(toks), 16)
    ts = convert.decode_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    back = convert.decode_state_to_numpy(ts)
    for (p, g), (_, w) in zip(_paths(back), _paths(jax.tree.map(np.asarray, js))):
        np.testing.assert_array_equal(g, w, err_msg=p)
    nxt = np.array([7, 9], np.int32)
    want, _ = jm.decode_step(jp, jnp.asarray(nxt), js)
    got, _ = tm.decode_step(tp, torch.from_numpy(nxt), ts)
    _close(got, want, RTOL, "xlstm decode from the reference's state")


def test_bfloat16_state_converts_bit_for_bit():
    lm = dataclasses.replace(get_arch("qwen2-0.5b").smoke, dtype=torch.bfloat16)
    tm = CompositeLM(lm)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    _, st = tm.prefill(tp, torch.from_numpy(np.arange(16, dtype=np.int32).reshape(2, 8)), 12)
    assert st["repeat"][0]["k"].dtype == torch.bfloat16
    back = convert.decode_state_from_jax(convert.decode_state_to_numpy(st), device="cpu")
    for a, b in zip(tree.leaves(st), tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
