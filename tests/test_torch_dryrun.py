"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's sharding of the same cells.

  * Argument bytes per device: for every arch x shape x {single, multi}
    that is not skipped (and the HKV backend's train cell of every arch),
    the port's count equals the bytes a JAX subprocess computes from the
    reference's own ``param_specs``, ``decode_state_specs``,
    ``_batch_specs``, ``_opt_specs`` and ``ShardedHKVEmbedding.state_specs``
    on ``jax.eval_shape`` leaves and the production mesh's sizes: each
    leaf's bytes with every split dim divided by its axes' sizes (rounded
    up), summed.  Nothing is compiled.  The subprocess forces 512 host
    devices, which JAX must see before it is imported.
  * FLOPs: a dense smoke arch's forward, counted on meta tensors, equals
    the count worked out by hand from its config.
  * The CLI writes one JSON a cell, whose keys are the reference's (and
    ``notes``, the port's statement of what its count leaves out).
Exact equality throughout: these are integer counts.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.lm import CompositeLM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r'''
import os, sys, json, math
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch import dryrun as D
from repro.configs import ARCH_NAMES, get_arch
from repro.distributed import sharding as S
from repro.distributed.table_sharding import ShardedHKVEmbedding
from repro.embedding.dynamic import HKVEmbedding
from repro.embedding.sparse_opt import SparseOptimizer
from repro.launch.mesh import make_production_mesh
from repro.models.lm import CompositeLM
import dataclasses

def spec_of(s):
    return s.spec if isinstance(s, NamedSharding) else s

def is_leaf(x):
    return isinstance(x, (P, NamedSharding))

def nbytes(leaves, specs, mesh):
    ls = jax.tree.leaves(leaves)
    ss = jax.tree.leaves(specs, is_leaf=is_leaf)
    assert len(ls) == len(ss), (len(ls), len(ss))
    total = 0
    for leaf, s in zip(ls, ss):
        shape = list(leaf.shape)
        for i, p in enumerate(spec_of(s)):
            names = p if isinstance(p, tuple) else () if p is None else (p,)
            n = math.prod(mesh.shape[a] for a in names)
            shape[i] = -(-shape[i] // n)
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total

out = {}
key = jax.random.PRNGKey(0)
for mesh_kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    for name in ARCH_NAMES:
        arch = get_arch(name)
        model = arch.model()
        params = jax.eval_shape(model.init, key)
        pspecs = S.param_specs(params)
        for shape in arch.shapes:
            if shape.skip:
                continue
            tag = f"{name}__{shape.name}__dense__{mesh_kind}"
            b = shape.global_batch
            if shape.kind == "train":
                opt, opt_name = D._opt_for(name)
                opt_shape = jax.eval_shape(opt.init, params)
                osh = D._opt_specs(opt_name, opt_shape, pspecs, mesh)
                batch, bsh = D._batch_specs(arch, shape, mesh, arch.lm.d_model)
                out[tag] = (nbytes(params, pspecs, mesh) + nbytes(opt_shape, osh, mesh)
                            + nbytes(batch, bsh, mesh))
                # the HKV backend's cell
                emb = ShardedHKVEmbedding(
                    emb=HKVEmbedding(capacity=D._hkv_capacity(arch.lm.vocab),
                                     dim=arch.lm.d_model,
                                     optimizer=SparseOptimizer("rowwise_adagrad")),
                    axis_names=tuple(mesh.axis_names))
                hkv_model = CompositeLM(dataclasses.replace(
                    arch.lm, embedding_backend="hkv", tied_head=False))
                hp = jax.eval_shape(hkv_model.init, key)
                hspecs = S.param_specs(hp)
                hopt = jax.eval_shape(opt.init, hp)
                hosh = D._opt_specs(opt_name, hopt, hspecs, mesh)
                n_shards = int(np.prod(list(mesh.shape.values())))
                local = jax.eval_shape(lambda: emb.local_embedding(n_shards).create().state)
                table = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                    (a.shape[0] * n_shards,) + a.shape[1:], a.dtype) if a.ndim >= 1 else a, local)
                out[f"{name}__{shape.name}__hkv__{mesh_kind}"] = (
                    nbytes(hp, hspecs, mesh) + nbytes(hopt, hosh, mesh)
                    + nbytes(table, emb.state_specs(), mesh) + nbytes(batch, bsh, mesh))
            elif shape.kind == "prefill":
                batch, bsh = D._batch_specs(arch, shape, mesh, arch.lm.d_model)
                keys = [k for k in batch if k != "labels"]
                out[tag] = nbytes(params, pspecs, mesh) + nbytes(
                    {k: batch[k] for k in keys}, {k: bsh[k] for k in keys}, mesh)
            else:
                state = jax.eval_shape(lambda: model.init_decode_state(batch=b, max_len=shape.seq))
                kv_div = all(seg.block.kind != "attn"
                             or seg.block.kv_heads % mesh.shape["model"] == 0
                             for seg in tuple(arch.lm.prelude) + tuple(arch.lm.segments))
                sspecs = S.decode_state_specs(mesh, state, kv_div)
                if b % dp_size != 0:
                    sspecs = jax.tree.map(lambda s: P(*(None if a == "data" else a for a in s)),
                                          sspecs, is_leaf=lambda x: isinstance(x, P))
                tok = P(dp) if b % dp_size == 0 else P(None)
                out[tag] = (nbytes(params, pspecs, mesh)
                            + nbytes(jax.ShapeDtypeStruct((b,), np.int32), tok, mesh)
                            + nbytes(state, sspecs, mesh))
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference_bytes():
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "XLA_FLAGS": "",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cells():
    for name in ARCH_NAMES:
        for shape in get_arch(name).shapes:
            if shape.skip:
                continue
            for mesh in ("single", "multi"):
                yield name, shape.name, "dense", mesh
                if shape.kind == "train":
                    yield name, shape.name, "hkv", mesh


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_argument_bytes_equal_the_reference_specs(reference_bytes, name):
    """Every cell of one arch, both meshes, both backends' train cells."""
    cells = [c for c in _cells() if c[0] == name]
    assert cells
    for _, shape_name, backend, mesh_kind in cells:
        arch = get_arch(name)
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device="meta")
        cell = dryrun.build_cell(arch, arch.shape(shape_name), mesh, backend)
        want = reference_bytes[f"{name}__{shape_name}__{backend}__{mesh_kind}"]
        assert cell.argument_bytes() == want, (shape_name, backend, mesh_kind)


def test_every_reference_cell_is_counted(reference_bytes):
    assert sorted(reference_bytes) == sorted("__".join(c) for c in _cells())


def test_forward_flops_equal_the_hand_count():
    """qwen2-0.5b's smoke config (d 64, 4 heads of 16, 1 KV head, gated FFN
    of 128, vocab 512, 2 layers, tied head): its loss's forward at B 2 x S
    32, one attention block, counted on meta tensors."""
    lm = get_arch("qwen2-0.5b").smoke
    blk = lm.segments[0].block
    b, s = 2, 32
    d, h, kv, ff, v = lm.d_model, blk.heads, blk.kv_heads, blk.d_ff, lm.vocab
    hd = d // h
    t = b * s
    per_layer = (2 * t * d * h * hd            # q
                 + 2 * 2 * t * d * kv * hd     # k, v
                 + 2 * t * h * hd * d          # o
                 + 3 * 2 * t * d * ff          # gated FFN: gate, up, down
                 + 2 * 2 * b * h * s * s * hd)  # QK^T and AV
    want = lm.num_layers * per_layer + 2 * t * d * v   # the tied head
    model = CompositeLM(lm, attention="sdpa")
    params = model.init(device="meta")
    toks = torch.zeros((b, s), dtype=torch.int32, device="meta")
    with dryrun.FlopCounterMode(display=False) as fc:
        model.loss(params, toks, toks)
    assert fc.get_total_flops() == want


_REFERENCE_KEYS = {"arch", "shape", "mesh", "backend", "kind", "devices", "params", "compile_s",
                   "memory", "cost", "collectives", "collective_wire_bytes_per_device",
                   "skipped", "error"}
_REFERENCE_MEMORY = {"argument_bytes_per_device", "output_bytes_per_device",
                     "temp_bytes_per_device", "alias_bytes_per_device",
                     "peak_estimate_per_device"}


def test_cli_writes_one_record_a_cell(tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--backend", "hkv",
                        "--mesh", "multi", "--out", str(out)]) == 0
    files = sorted(p.relative_to(out).as_posix() for p in out.rglob("*.json"))
    assert files == ["multi/qwen2-0.5b__train_4k__hkv.json",
                     "single/qwen2-0.5b__decode_32k__dense.json",
                     "single/qwen2-0.5b__long_500k__dense.json"]
    rec = json.loads((out / files[1]).read_text())
    assert set(rec) <= _REFERENCE_KEYS | {"notes"}
    assert set(rec["memory"]) <= _REFERENCE_MEMORY and set(rec["cost"]) == {"flops_per_device"}
    assert rec["devices"] == 256 and rec["kind"] == "decode"
    assert rec["params"] == get_arch("qwen2-0.5b").param_count()
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["output_bytes_per_device"] > 0
    skipped = json.loads((out / files[2]).read_text())
    assert skipped["skipped"].startswith("full-attn")
    hkv = json.loads((out / files[0]).read_text())
    assert hkv["devices"] == 512 and dryrun.NOTE_HKV in hkv["notes"]
    # --skip-existing leaves a finished record alone
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--skip-existing",
                        "--out", str(out)]) == 0
    assert "(cached)" in capsys.readouterr().out


def test_output_bytes_of_a_train_step_are_its_state_and_metrics():
    """A dense train step's outputs are its new parameters and optimizer
    state (their inputs' specs) and replicated scalar metrics."""
    arch = get_arch("qwen2-0.5b")
    mesh = make_production_mesh(device="meta")
    cell = dryrun.build_cell(arch, arch.shape("train_4k"), mesh)
    rec = cell.run()
    b, s = arch.shape("train_4k").global_batch, arch.shape("train_4k").seq
    batch_bytes = 2 * b * s * 4 // 16          # tokens and labels, split over data
    metrics = rec["memory"]["output_bytes_per_device"] - (
        rec["memory"]["argument_bytes_per_device"] - batch_bytes)
    # loss, grad_norm, ce, load_balance, router_z: float32 scalars
    assert metrics == 5 * 4
