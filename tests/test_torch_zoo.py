"""The six architectures the port added beside the four dense ones
(llama4-maverick, moonshot-v1-16b, zamba2-1.2b, qwen2-vl-2b,
musicgen-medium, xlstm-1.3b) against the JAX package, on the CPU at their
smoke sizes.  ``tests/test_torch_lm.py`` holds every arch's configuration,
parameter tree and dense-backend loss and gradients; this file holds:

  * the HKV backend's loss and gradients (embeds passed in, untied head),
    the embeds' gradient included, for each of the six; their parameter
    trees and adamw states carried across by ``convert`` leaf by leaf;
  * the full configs' parameter counts inside tests/test_models.py:145's
    ranges (and equal to the reference's);
  * qwen2-vl's `train_step` with both frontend inputs against the
    reference's, over 2 steps;
  * zamba2's `train_step_hkv` against the reference's step composed from
    its parts, over 2 steps (jax 0.9 refuses the reference's own, see
    tests/test_torch_lm.py), and a checkpoint of its train state (a tree
    with prelude and shared leaves, ``None`` slots) restored by the
    reference bit for bit;
  * the port's launcher at --smoke on the CPU with --backend hkv for
    zamba2-1.2b and xlstm-1.3b, and qwen2-vl-2b through the launcher
    raising the reference launcher's TypeError (its batches carry no
    M-RoPE positions).

Tolerances are tests/test_torch_lm.py's: the loss within a relative 2e-6,
each gradient leaf within 2e-5 of its largest magnitude (zamba2's within
2e-4, its float32 stack being ill-conditioned), parameters after adamw
steps within an absolute 2e-5 (zamba2's after 2 steps within 2 lr: adamw
steps a noise-level coordinate by up to lr); zamba2's table rows within 1e-4 of
their magnitude (tests/test_torch_lm.py's 1e-5, times the same factor of
10 that its gradients carry).
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.distributed.table_sharding import ShardedHKVTable as JSharded  # noqa: E402
from repro.embedding.dynamic import HKVEmbedding as JEmb  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JOpt  # noqa: E402
from repro.models.lm import CompositeLM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.optimizers import apply_updates as japply  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.step import StepBuilder as JStep  # noqa: E402
from repro.train.step import clip_by_global_norm as jclip  # noqa: E402
from repro_torch import ShardedHKVTable, convert, make_dev_mesh, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import StepBuilder  # noqa: E402

NEW_ARCHS = ("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b", "zamba2-1.2b", "qwen2-vl-2b",
             "musicgen-medium", "xlstm-1.3b")
LOSS_RTOL = 2e-6
GRAD_RTOL = 2e-5
GRAD_RTOL_OF = {"zamba2-1.2b": 2e-4}
PARAM_ATOL = 2e-5
LM_LR = 3e-4                       # adamw's default, the launcher's
# a trained row moves by lr along its gradient's direction (rowwise_adagrad);
# zamba2's embeds' gradients carry its stack's 10x wider spread (GRAD_RTOL_OF)
ZAMBA2_VALUE_RTOL = 1e-4
# tests/test_models.py:145's ranges
PARAM_RANGES = {
    "gemma-2b": (2.0e9, 3.3e9), "qwen2-0.5b": (0.4e9, 0.7e9), "yi-6b": (5.5e9, 7.0e9),
    "h2o-danube-1.8b": (1.5e9, 2.1e9), "moonshot-v1-16b-a3b": (24e9, 32e9),
    "zamba2-1.2b": (1.0e9, 1.6e9), "qwen2-vl-2b": (1.2e9, 2.3e9),
    "musicgen-medium": (1.3e9, 2.1e9), "xlstm-1.3b": (1.0e9, 1.8e9),
    "llama4-maverick-400b-a17b": (330e9, 440e9),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """The JAX side's sharded table ops compiled without most optimizations
    (compile time is most of their cost; only the row mean's order moves)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, ctx):
    got, want = _np(got).astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, ctx
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), f"{ctx}: {err}"


def _hkv(lm):
    return dataclasses.replace(lm, embedding_backend="hkv", tied_head=False)


def _models(name, backend="dense", seed=0):
    """(JAX model, its params, port model, the same params) on a smoke config."""
    jlm, tlm = jget(name).smoke, get_arch(name).smoke
    if backend == "hkv":
        jlm, tlm = _hkv(jlm), _hkv(tlm)
    jm = JLM(jlm)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, CompositeLM(tlm), convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                                                 device="cpu")


def _batch(vocab, b=2, s=32, seed=0, d_model=None, vision=False):
    """tokens, labels and (for a vision arch) the frontend inputs as numpy:
    8 patch embeddings and arange M-RoPE positions (tests/test_models.py:19)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    extras = {}
    if vision:
        extras["frontend_embeds"] = rng.normal(size=(b, 8, d_model)).astype(np.float32)
        extras["mrope_positions"] = np.broadcast_to(np.arange(s, dtype=np.int32),
                                                    (3, b, s)).copy()
    return toks, labels, extras


def _paths(t):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(t)[0]]


# =============================================================================
# Loss and gradients with HKV embeds
# =============================================================================


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_hkv_backend_loss_and_grads(name):
    jm, jp, tm, tp = _models(name, "hkv")
    d = tm.cfg.d_model
    toks, labels, ex = _batch(tm.cfg.vocab, seed=1, d_model=d, vision=tm.cfg.frontend is not None)
    e = np.random.default_rng(2).normal(size=toks.shape + (d,)).astype(np.float32)
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    (jl, jaux), (jg, jeg) = jax.jit(jax.value_and_grad(
        lambda p, x: jm.loss(p, None, jnp.asarray(labels), embeds=x, **jex), argnums=(0, 1),
        has_aux=True))(jp, jnp.asarray(e))
    leaves = [p.detach().requires_grad_() for p in tree.leaves(tp)]
    et = torch.from_numpy(e).requires_grad_()
    loss, aux = tm.loss(tree.unflatten(tp, leaves), None, torch.from_numpy(labels), embeds=et,
                        **{k: torch.from_numpy(v) for k, v in ex.items()})
    *grads, eg = torch.autograd.grad(loss, leaves + [et])
    _close(loss, jl, LOSS_RTOL, "loss")
    for k in ("ce", "load_balance", "router_z"):
        _close(aux[k], jaux[k], LOSS_RTOL, k)
    rtol = GRAD_RTOL_OF.get(name, GRAD_RTOL)
    for (path, want), got in zip(_paths(jg), grads):
        _close(got, want, rtol, f"grad {path}")
    _close(eg, jeg, rtol, "embeds' grad")
    assert "embed" not in tp and "head" in tp


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_convert_carries_the_trees_leaf_by_leaf(name):
    """lm_params_from_jax / lm_params_to_numpy / opt_state_from_jax on the
    new trees (mLSTM's [G, qb, qb] blocks, sLSTM's r, the MoE's [E, d, f]
    experts, zamba2's shared list with its None slots): every leaf's path,
    dtype and bits, both ways; adamw's state after one reference step."""
    jm, jp, tm, tp = _models(name, "hkv")
    back = convert.lm_params_to_numpy(tp)
    for (path, want), got in zip(_paths(jp), tree.leaves(back)):
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, back))
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    _, js = jadamw().update(grads, jadamw().init(jp), jp)
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert sorted(ts) == sorted(js) and ts["count"].dtype == torch.int32
    for (path, want), got in zip(_paths(js), tree.leaves(ts)):
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", PARAM_RANGES)
def test_param_counts_in_the_reference_ranges(name):
    lo, hi = PARAM_RANGES[name]
    n = get_arch(name).param_count()
    assert lo <= n <= hi, f"{name}: {n / 1e9:.3f} B parameters"
    if name in NEW_ARCHS:
        assert n == jget(name).param_count()


def test_zamba2_full_config_tree():
    """The published zamba2's tree on 'meta': the prelude stacked [2, ...],
    the repeated mamba2 segment [6, 6, ...], the shared attention block
    stored once beside a None slot (1,087,971,456 parameters with the
    tied table)."""
    p = CompositeLM(get_arch("zamba2-1.2b").lm).init(device="meta")
    assert tuple(p["prelude"][0]["in_proj"].shape) == (2, 2048, 2 * 4096 + 2 * 64 + 64)
    assert tuple(p["repeat"][0]["conv_w"].shape) == (6, 6, 4, 4096)
    assert p["repeat"][1] is None and p["shared"][0] is None
    assert tuple(p["shared"][1]["wq"].shape) == (2048, 2048)
    assert sum(x.numel() for x in tree.leaves(p)) == jget("zamba2-1.2b").param_count()


# =============================================================================
# Train steps
# =============================================================================


def test_qwen2_vl_train_step_with_frontend_inputs_equals_the_reference():
    jm, jp, tm, tp = _models("qwen2-vl-2b")
    jb, tb = JStep(jm, jadamw()), StepBuilder(tm, adamw())
    js, ts = jadamw().init(jp), adamw().init(tp)
    jstep = jax.jit(jb.train_step)
    for step in range(2):
        toks, labels, ex = _batch(tm.cfg.vocab, seed=30 + step, d_model=tm.cfg.d_model,
                                  vision=True)
        batch = {"tokens": toks, "labels": labels, **ex}
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tmet = tb.train_step(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tmet["loss"], jmet["loss"], LOSS_RTOL, f"step {step} loss")
        _close(tmet["grad_norm"], jmet["grad_norm"], GRAD_RTOL, f"step {step} grad norm")
    for (path, want), got in zip(_paths(jp), tree.leaves(tp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"param {path}")


@jax.jit
def _j_lookup(t, toks):
    return t.lookup(toks, train=True)


@jax.jit
def _j_grads(t, toks, g):
    return t.apply_grads(toks, g)


def test_zamba2_train_step_hkv_equals_the_reference_composition(tmp_path):
    """2 HKV steps of zamba2 (smoke) on a 1-shard mesh in both packages, the
    launcher's table (rowwise_adagrad), adamw; then the port's checkpoint of
    its train state restored by the reference onto its own state's
    structure, bit for bit."""
    jm, jp, tm, tp = _models("zamba2-1.2b", "hkv")
    vocab, d = tm.cfg.vocab, tm.cfg.d_model
    cap = train_mod.hkv_capacity(vocab)
    jt = JSharded.create(jax.make_mesh((1, 1), ("data", "model")),
                         JEmb(capacity=cap, dim=d, optimizer=JOpt("rowwise_adagrad", lr=0.05)))
    tt = ShardedHKVTable.create(make_dev_mesh(1, 1, device="cpu"),
                                HKVEmbedding(capacity=cap, dim=d,
                                             optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05)))
    jopt = jadamw()
    js, tb, ts = jopt.init(jp), StepBuilder(tm, adamw()), adamw().init(tp)
    jloss = jax.jit(jax.value_and_grad(lambda p, e, lab: jm.loss(p, None, lab, embeds=e),
                                       argnums=(0, 1), has_aux=True))
    for step in range(2):
        toks, labels, _ = _batch(vocab, seed=40 + step)
        jtoks = jnp.asarray(toks)
        jt, embeds, jovf = _j_lookup(jt, jtoks)
        (jl, _), (jg, jeg) = jloss(jp, jnp.asarray(np.asarray(embeds)), jnp.asarray(labels))
        jg, jgn = jclip(jg, 1.0)
        upd, js = jopt.update(jg, js, jp)
        jp = japply(jp, upd)
        jt = _j_grads(jt, jtoks, jeg)
        tp, ts, tt, met = tb.train_step_hkv(tp, ts, tt, {"tokens": torch.from_numpy(toks),
                                                         "labels": torch.from_numpy(labels)})
        assert int(met["emb_overflow"]) == int(jovf) == 0
        _close(met["loss"], jl, LOSS_RTOL, f"step {step} loss")
        _close(met["grad_norm"], jgn, GRAD_RTOL_OF["zamba2-1.2b"], f"step {step} grad norm")
        jstate = jax.tree.map(np.asarray, jt.state)
        tstate = convert.sharded_state_to_arrays(tt.state)
        for f in ("key_hi", "key_lo", "digests", "score_hi", "score_lo"):
            np.testing.assert_array_equal(tstate[f], getattr(jstate, f), err_msg=f"step {step} {f}")
        got, want = tstate["values"], jstate.values
        scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
        assert (np.abs(got - want).max(axis=1) <= ZAMBA2_VALUE_RTOL * scale).all(), \
            f"step {step} values"
    # adamw steps a coordinate whose gradient is at the noise level by up to
    # lr either way; zamba2's gradient noise reaches such coordinates
    for (path, want), got in zip(_paths(jp), tree.leaves(tp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2 * LM_LR,
                                   err_msg=f"param {path}")
    ckpt.save(str(tmp_path), 2, (tp, ts), extra={"step": 2})
    (rp, rs), extra = jckpt.restore(str(tmp_path), 2, (jp, js))
    assert extra == {"step": 2}
    for (path, want), got in zip(_paths((rp, rs)), tree.leaves((tp, ts))):
        np.testing.assert_array_equal(np.asarray(want), _np(got), err_msg=path)
    back, _ = ckpt.restore(str(tmp_path), 2, (tp, ts))
    for a, b in zip(tree.leaves(back), tree.leaves((tp, ts))):
        assert torch.equal(a, b)


# =============================================================================
# The launcher
# =============================================================================


@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-1.3b"])
def test_launcher_hkv_smoke(tmp_path, name):
    argv = ["--arch", name, "--smoke", "--device", "cpu", "--backend", "hkv", "--steps", "3",
            "--batch", "2", "--seq", "32", "--checkpoint-every", "2", "--ckpt-dir", str(tmp_path)]
    hist = train_mod.main(argv)
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    assert all(x < 3 * np.log(512) for x in hist["loss"])
    assert [p.step for p in hist["checkpoints"]] == [2, 3] and hist["restarts"] == 0
    params, _, table = hist["state"]
    assert "embed" not in params and all(m["emb_overflow"] == 0 for m in hist["metrics"])
    # the table holds every token the run looked up (the launcher's stream)
    stream = TokenStream(seed=0, batch=2, seq=32, vocab=512, alpha=1.0)
    seen = set().union(*(np.unique(stream.batch_at(step)[0]) for step in range(3)))
    assert table.size() == len(seen)


def test_qwen2_vl_launcher_raises_as_the_reference(tmp_path, monkeypatch):
    """The reference's launcher gives qwen2-vl batches without M-RoPE
    positions, and its M-RoPE indexes None (a TypeError); the port's
    launcher invents none and raises the same."""
    from repro.launch import train as jtrain

    argv = ["--arch", "qwen2-vl-2b", "--smoke", "--steps", "1", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "j")]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(TypeError, match="subscriptable"):
        jtrain.main()
    with pytest.raises(TypeError, match="subscriptable"):
        train_mod.main(argv[:-1] + [str(tmp_path / "t"), "--device", "cpu"])
