"""The port's train-stack distribution (``repro_torch.distributed.sharding``,
``.compression``, ``.pipeline``, ``launch.mesh.make_production_mesh``,
``train.step.make_sharded_train_step``) against the JAX package.

  * Specs: ``param_specs`` leaf by leaf for all ten archs at full size (the
    JAX side on ``jax.eval_shape`` leaves, the port's on 'meta'), equal as
    tuples and on equal paths; ``decode_state_specs`` (KV heads divisible
    and not) for all ten archs at smoke size; ``table_specs``,
    ``ShardedHKVEmbedding.state_specs`` (flat and tiered) and
    ``batch_spec`` on dev and production meshes.  Exact.
  * ``maybe_constrain`` is the identity, and ``moe_apply``'s three pins
    take the reference's specs and leave its result as it was, bit for bit.
  * ``compressed_psum`` and ``ef_compress_grads`` on 8 positions, and
    ``pipeline_apply`` over 4 stages, against the reference's
    ``shard_map`` runs on the inputs of ``tests/test_distributed.py``
    (105-162), computed by a JAX subprocess with 8 forced host devices (JAX
    must see the flag before it is imported).  The port computes the
    reference's source in IEEE float32, one rounding an operation.  XLA's
    compiled CPU program contracts two of its expressions into fused
    multiply-adds, one rounding for two operations: the carried error
    ``g - q * scale`` (so the error may sit 1 ulp of the dequantized value
    ``q * scale`` from the port's; on these inputs 3,009 of 4,096 do), and
    the block scale ``m / 127.0 + 1e-12``, which becomes ``fma(m,
    float32(1/127), 1e-12)`` (a division by a constant turned into a
    product by its reciprocal; a scale may then sit 1 ulp away, and the
    sums with it).  So: the synced sums and means within 1 ulp (float32
    units in the last place) of the reference's (equal on these inputs), the
    carried error within 1 ulp of the dequantized value, each step on the
    reference's own inputs, and both within the reference's own 0.05 of
    the exact sum or mean.  The pipeline: within
    the reference test's atol 1e-5 of the reference's output, and bit for
    bit the stages applied in sequence (the same operators on the same
    shapes).
  * ``make_sharded_train_step``, dense and HKV, on a CPU dev mesh: the
    builder's steps, bit for bit; a mesh without the rules' axes raises, as
    the reference's ``NamedSharding`` does.
"""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.distributed.table_sharding import ShardedHKVEmbedding as JSEmb  # noqa: E402
from repro.embedding.dynamic import HKVEmbedding as JEmb  # noqa: E402
from repro.models.lm import CompositeLM as JLM  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.distributed import compression, pipeline, sharding  # noqa: E402
from repro_torch.distributed.table_sharding import ShardedHKVEmbedding  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402
from repro_torch.launch.mesh import make_dev_mesh, make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jpath(path) -> tuple:
    """A JAX key path as the port's: dict keys and sequence indices."""
    out = []
    for e in path:
        if isinstance(e, jax.tree_util.DictKey):
            out.append(e.key)
        elif isinstance(e, jax.tree_util.SequenceKey):
            out.append(e.idx)
        else:
            out.append(e.name)
    return tuple(out)


def _jspecs(specs):
    return [(_jpath(p), tuple(s)) for p, s in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _tspecs(specs):
    return [(p, tuple(s)) for p, s in tree.leaves_with_path(specs, is_leaf=sharding.is_spec)]


# =============================================================================
# specs
# =============================================================================


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_equal_the_reference_leaf_by_leaf(name):
    jm = JLM(jget(name).lm)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = CompositeLM(get_arch(name).lm).init(device="meta")
    jpaths = [(_jpath(p), tuple(x.shape)) for p, x in
              jax.tree_util.tree_leaves_with_path(shapes)]
    assert [(p, tuple(x.shape)) for p, x in tree.leaves_with_path(params)] == jpaths
    for fsdp in (True, False):
        assert _tspecs(sharding.param_specs(params, fsdp)) == \
            _jspecs(jshard.param_specs(shapes, fsdp))


@pytest.mark.parametrize("kv_div", [True, False])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_state_specs_equal_the_reference(name, kv_div):
    jm = JLM(jget(name).smoke)
    shapes = jax.eval_shape(lambda: jm.init_decode_state(batch=2, max_len=32))
    state = CompositeLM(get_arch(name).smoke).init_decode_state(2, 32, device="meta")
    mesh = make_dev_mesh(1, 1, device="meta")
    got = _tspecs(sharding.decode_state_specs(mesh, state, kv_div))
    assert got == _jspecs(jshard.decode_state_specs(None, shapes, kv_div))
    assert len(got) == len(tree.leaves(state))


def _ref_state_fields(hkv_state):
    """The reference's HKVState specs on the port's fields (its hi/lo key,
    score and clock halves are one field each here, with one spec)."""
    d = hkv_state._asdict()
    assert d["key_hi"] == d["key_lo"] and d["score_hi"] == d["score_lo"]
    assert d["clock_hi"] == d["clock_lo"]
    return {"keys": tuple(d["key_hi"]), "digests": tuple(d["digests"]),
            "scores": tuple(d["score_hi"]), "values": tuple(d["values"]),
            "clock": tuple(d["clock_hi"]), "epoch": tuple(d["epoch"])}


def _port_state_fields(state):
    return {f: tuple(getattr(state, f))
            for f in ("keys", "digests", "scores", "values", "clock", "epoch")}


def test_table_specs_equal_the_reference():
    assert _port_state_fields(sharding.table_specs()) == _ref_state_fields(jshard.table_specs(None))


@pytest.mark.parametrize("axes", [("data", "model"), ("data",), ("pod", "data", "model")])
@pytest.mark.parametrize("tiered", [False, True])
def test_state_specs_equal_the_reference(axes, tiered):
    hot = 2 * 128 if tiered else None
    want = JSEmb(emb=JEmb(capacity=8 * 128, dim=4, hot_capacity=hot), axis_names=axes).state_specs()
    got = ShardedHKVEmbedding(emb=HKVEmbedding(capacity=8 * 128, dim=4, hot_capacity=hot),
                              axis_names=axes).state_specs()
    if tiered:
        assert _port_state_fields(got.hot) == _ref_state_fields(want.hot)
        assert _port_state_fields(got.cold) == _ref_state_fields(want.cold)
    else:
        assert _port_state_fields(got) == _ref_state_fields(want)


def test_batch_spec_and_production_mesh_equal_the_reference():
    meshes = [make_dev_mesh(2, 4, device="cpu"), make_mesh((8,), ("data",), device="cpu"),
              make_mesh((4,), ("model",), device="cpu"),
              make_production_mesh(device="meta"), make_production_mesh(multi_pod=True,
                                                                        device="meta")]
    for m in meshes:
        ref = jshard.batch_spec(types.SimpleNamespace(axis_names=m.axis_names))
        assert tuple(sharding.batch_spec(m)) == tuple(ref), m
    assert make_production_mesh(device="meta").shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True, device="meta").shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(device="cpu").devices.size == 256


def test_production_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_production_mesh()


def test_maybe_constrain_is_the_identity_and_moe_pins_change_nothing(monkeypatch):
    x = torch.randn(3, 4)
    assert sharding.maybe_constrain(x, "model", None) is x
    cfg = moe.MoECfg(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=0.5)
    p = moe.moe_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    xs = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    y, aux = moe.moe_apply(cfg, p, xs)
    pins = []

    def record(t, *spec):
        pins.append((tuple(t.shape), spec))
        return t

    monkeypatch.setattr(sharding, "maybe_constrain", record)
    y0, aux0 = moe.moe_apply(cfg, p, xs)
    c = moe.capacity(cfg, 64)
    assert pins == [((4, c, 16), ("model", None, None)), ((4, c, 64), ("model", None, None)),
                    ((4, c, 16), ("model", None, None))]
    assert torch.equal(y, y0) and all(torch.equal(aux[k], aux0[k]) for k in aux)


def test_spec_type():
    s = sharding.P(("data",), ("pod", "data"), (), None, "model")
    assert tuple(s) == ("data", ("pod", "data"), None, None, "model")
    assert s.axes() == ("data", "pod", "data", "model")
    assert repr(sharding.P("model", None)) == "PartitionSpec('model', None)"
    assert sharding.P("a") == sharding.P(("a",)) and hash(sharding.P("a")) == hash(sharding.P("a"))
    assert sharding.shard_shape((33, 8), sharding.P(("data", "model"), None),
                                {"data": 2, "model": 4}) == (5, 8)
    with pytest.raises(ValueError, match="twice"):
        sharding.NamedSharding(make_dev_mesh(2, 4, device="cpu"), sharding.P("data", "data"))


# =============================================================================
# compression and the pipeline against the reference's shard_map runs
# =============================================================================

_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import shard_map
from repro.distributed.compression import compressed_psum, ef_compress_grads, init_error_state
from repro.distributed.pipeline import pipeline_apply

out = {}
mesh = jax.make_mesh((8,), ("d",))
# tests/test_distributed.py:105-122
x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 1000)), jnp.float32)
out["psum_x"] = np.asarray(x)
out["psum_y"] = np.asarray(jax.jit(shard_map(lambda x: compressed_psum(x, "d"), mesh=mesh,
                                             in_specs=P("d"), out_specs=P("d")))(x))
# tests/test_distributed.py:125-143, then a second step carrying the error
g = {"w": jnp.asarray(np.random.default_rng(1).normal(size=(8, 512)), jnp.float32)}
g2 = {"w": jnp.asarray(np.random.default_rng(3).normal(size=(8, 512)), jnp.float32)}

def body(g, g2):
    e = init_error_state({"w": g["w"]})
    s1, e1 = ef_compress_grads(g, e, "d")
    s2, e2 = ef_compress_grads(g2, e1, "d")
    return s1["w"], e1["w"], s2["w"], e2["w"]

res = jax.jit(shard_map(body, mesh=mesh, in_specs=({"w": P("d")}, {"w": P("d")}),
                        out_specs=(P("d"),) * 4))(g, g2)
out["ef_g"], out["ef_g2"] = np.asarray(g["w"]), np.asarray(g2["w"])
for k, v in zip(("ef_s1", "ef_e1", "ef_s2", "ef_e2"), res):
    out[k] = np.asarray(v)
# tests/test_distributed.py:145-162
pmesh = jax.make_mesh((4,), ("pod",))
rng = np.random.default_rng(2)
ws = jnp.asarray(rng.normal(size=(4, 16, 16)) / 4.0, jnp.float32)
xs = jnp.asarray(rng.normal(size=(6, 8, 16)), jnp.float32)
out["pipe_ws"], out["pipe_xs"] = np.asarray(ws), np.asarray(xs)
out["pipe_got"] = np.asarray(pipeline_apply(pmesh, "pod", lambda w, x: jnp.tanh(x @ w), ws, xs))
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    import os

    path = tmp_path_factory.mktemp("dist") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "XLA_FLAGS": "", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT), str(path)],
                          cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _ulps(a, b) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _rows(positions) -> np.ndarray:
    return np.concatenate([p.numpy() for p in positions])


def test_compressed_psum_equals_the_reference(recorded):
    x = recorded["psum_x"]
    got = compression.compressed_psum([torch.from_numpy(x[i:i + 1]) for i in range(8)])
    y, want = _rows(got), recorded["psum_y"]
    assert y.shape == want.shape
    assert _ulps(y, want).max() <= 1
    exact = np.broadcast_to(x.sum(0, keepdims=True), x.shape)
    assert np.abs(y - exact).max() / np.abs(exact).max() < 0.05


def test_ef_compress_grads_equals_the_reference_over_two_steps(recorded):
    """Each step on the reference's own inputs (the second carries the
    reference's first error), then the port's own two-step chain."""
    g1, g2, e1_ref = recorded["ef_g"], recorded["ef_g2"], recorded["ef_e1"]
    pos = lambda a: [{"w": torch.from_numpy(a[i:i + 1])} for i in range(8)]  # noqa: E731
    errs = [compression.init_error_state(p) for p in pos(g1)]
    assert all(e["w"].dtype == torch.float32 and not e["w"].any() for e in errs)
    s1, e1 = compression.ef_compress_grads(pos(g1), errs)
    s2, e2 = compression.ef_compress_grads(pos(g2), pos(e1_ref))
    for got_s, got_e, step, g, e_in in ((s1, e1, "1", g1, 0.0), (s2, e2, "2", g2, e1_ref)):
        s = _rows([p["w"] for p in got_s])
        e = _rows([p["w"] for p in got_e])
        assert _ulps(s, recorded[f"ef_s{step}"]).max() <= 1, step
        # the error is (g + e_in) - deq: within one ulp of the reference's deq
        deq = (g + e_in) - recorded[f"ef_e{step}"]
        ulp = np.spacing(np.abs(deq).astype(np.float32))
        assert (np.abs(e - recorded[f"ef_e{step}"]) <= ulp).all(), step
        exact = np.broadcast_to((g + e_in).mean(0, keepdims=True), g.shape)
        assert np.abs(s - exact).max() / np.abs(exact).max() < 0.05
        assert np.abs(e).sum() > 0
    # the port's own chain: the second step carries its first error
    s2, e2 = compression.ef_compress_grads(pos(g2), e1)
    e1_np = _rows([p["w"] for p in e1])
    exact = np.broadcast_to((g2 + e1_np).mean(0, keepdims=True), g2.shape)
    s = _rows([p["w"] for p in s2])
    assert np.abs(s - exact).max() / np.abs(exact).max() < 0.05
    assert np.abs(_rows([p["w"] for p in e2])).sum() > 0
    # positions on one device share the synced result
    assert all(p["w"] is s1[0]["w"] for p in s1)


def _stage(w, x):
    return torch.tanh(x @ w)


def test_pipeline_equals_the_reference_and_sequential_application(recorded):
    ws, xs = torch.from_numpy(recorded["pipe_ws"]), torch.from_numpy(recorded["pipe_xs"])
    mesh = make_mesh((4,), ("pod",), device="cpu")
    got = pipeline.pipeline_apply(mesh, "pod", _stage, ws, xs)
    np.testing.assert_allclose(got.numpy(), recorded["pipe_got"], rtol=0, atol=1e-5)
    want = torch.stack([_seq(ws, x) for x in xs])
    assert torch.equal(got, want)


def _seq(ws, x):
    for w in ws:
        x = _stage(w, x)
    return x


def test_pipeline_runs_the_reference_schedule():
    """M + K - 1 ticks of every stage, a tree of stage parameters, and
    stages over a mesh with another axis (taken at its index 0)."""
    calls = []

    def stage(p, x):
        calls.append(x.shape)
        return torch.tanh(x @ p["w"] + p["b"])

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 8, 8, generator=g) / 3, "b": torch.randn(3, 8, generator=g)}
    xs = torch.randn(5, 2, 8, generator=g)
    mesh = make_mesh((3, 2), ("pod", "data"), device="cpu")
    got = pipeline.pipeline_apply(mesh, "pod", stage, params, xs)
    assert len(calls) == 3 * (5 + 3 - 1)
    for m in range(5):
        x = xs[m]
        for i in range(3):
            x = torch.tanh(x @ params["w"][i] + params["b"][i])
        assert torch.equal(got[m], x)


# =============================================================================
# make_sharded_train_step
# =============================================================================


def _same_tree(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hkv", [False, True])
def test_make_sharded_train_step_is_the_builders_step(hkv):
    from repro_torch.optim import adamw
    from repro_torch.train.step import StepBuilder, make_sharded_train_step
    from repro_torch import ShardedHKVTable

    lm = get_arch("qwen2-0.5b").smoke
    if hkv:
        lm = dataclasses.replace(lm, embedding_backend="hkv", tied_head=False)
    model = CompositeLM(lm)
    builder = StepBuilder(model, adamw())
    mesh = make_dev_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, lm.vocab, size=(4, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    runs = []
    for sharded in (True, False):
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        opt_state = builder.optimizer.init(params)
        step = (make_sharded_train_step(builder, mesh, model.init(device="meta"), hkv)
                if sharded else builder.train_step_hkv if hkv else builder.train_step)
        if hkv:
            table = ShardedHKVTable.create(mesh, HKVEmbedding(
                capacity=8 * 1024, dim=lm.d_model,
                optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05)))
            for _ in range(2):
                params, opt_state, table, m = step(params, opt_state, table, batch)
            runs.append((params, opt_state, m, [s.planes for s in table.state]))
        else:
            for _ in range(2):
                params, opt_state, m = step(params, opt_state, batch)
            runs.append((params, opt_state, m, []))
    (p1, o1, m1, t1), (p2, o2, m2, t2) = runs
    _same_tree(p1, p2)
    _same_tree(o1, o2)
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    _same_tree(t1, t2)


def test_make_sharded_train_step_raises_where_the_reference_does():
    """The rules name "data" and "model": a mesh without them is refused by
    the reference's NamedSharding and by the port."""
    from repro.train.step import StepBuilder as JBuilder
    from repro.train.step import make_sharded_train_step as jmake
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    from repro_torch.train.step import StepBuilder, make_sharded_train_step

    name = "qwen2-0.5b"
    jm = JLM(jget(name).smoke)
    jmesh = jax.make_mesh((1,), ("pod",))
    with pytest.raises(ValueError):
        jmake(JBuilder(jm, jadamw()), jmesh, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), False)
    model = CompositeLM(get_arch(name).smoke)
    with pytest.raises(ValueError, match="lacks"):
        make_sharded_train_step(StepBuilder(model, adamw()), make_mesh((1,), ("pod",), "cpu"),
                                model.init(device="meta"), False)
