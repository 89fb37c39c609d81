"""Dry run on meta tensors (port of ``repro/launch/dryrun.py``): every (arch
x shape) cell on the production mesh, counted without allocating.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi --out runs/dryrun
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --backend hkv

The reference lowers and compiles each cell's step on 512 forced host
devices and reads XLA's analyses.  The port has no compiler; per cell it
  1. builds the full-size parameters, optimizer state, batch and decode
     state on ``torch.device("meta")`` (shapes and dtypes, no storage),
  2. gives each leaf its spec (``distributed.sharding``; the same rules
     as the reference's, so the same layout),
  3. counts each device's argument and output bytes from the specs: a
     leaf's bytes over the product of the sizes of the mesh axes its spec
     names (each split dim rounded up, as a padded shard), summed,
  4. runs the step itself on the meta tensors under
     ``torch.utils.flop_counter.FlopCounterMode`` and divides its FLOPs by
     the devices.

The record keeps the reference's keys where the quantity is the same:
``arch``, ``shape``, ``mesh``, ``backend``, ``kind``, ``devices``,
``params``, ``memory.argument_bytes_per_device``,
``memory.output_bytes_per_device`` and ``cost.flops_per_device``, and adds
``notes`` (what the count leaves out).  It leaves out what needs a
compiler: temporary and peak bytes, aliasing, bytes accessed, the
collectives and their wire bytes, and the compile time.

Outputs: the step's new parameters, optimizer state, table and decode
state carry their inputs' specs (the reference donates them); logits are
split over the data-parallel axes on their batch dim where it divides;
metrics are replicated.  Attention is counted in its card form (SDPA, the
whole S x S product).  The HKV backend's dedupe has shapes that depend on
the data, so its table ops do not run on meta tensors: the table's state
is counted from its shape (the reference's sizing: 2 x vocab slots over
every mesh axis, rowwise_adagrad), and the step runs with the table's
lookup and update left out of the FLOPs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.configs.common import ArchDef, ShapeCfg
from repro_torch.core.tiered import TieredState
from repro_torch.distributed import sharding as shard_rules
from repro_torch.distributed.sharding import P, is_spec
from repro_torch.distributed.table_sharding import ShardedHKVEmbedding
from repro_torch.embedding import HKVEmbedding, SparseOptimizer
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.lm import CompositeLM
from repro_torch.optim import adafactor, adamw
from repro_torch.train.step import StepBuilder

META = torch.device("meta")
# the bytes of a table's scalar clock (unsigned 64-bit) and epoch (32-bit)
_CLOCK_BYTES, _EPOCH_BYTES = 8, 4
NOTE_HKV = "flops leave out the HKV table's lookup and update (data-dependent dedupe)"
NOTE_ATTENTION = "attention counted in its card form (SDPA over the whole S x S)"
NOTE_SLSTM = ("step not run (no flops, no output bytes): sLSTM's recurrence is a Python step "
              "a position (a train_4k step took ~600 s on meta tensors)")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _dp(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp(mesh))


def _batch_specs(arch: ArchDef, shape: ShapeCfg, mesh: Mesh, d_model: int):
    """One training or prefill batch on meta, and its specs."""
    b, s = shape.global_batch, shape.seq
    bspec = P(_dp(mesh), None) if b % _dp_size(mesh) == 0 else P(None, None)
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    specs = {"tokens": bspec, "labels": bspec}
    if arch.lm.frontend == "vision":
        batch["frontend_embeds"] = _meta((b, arch.vision_tokens, d_model), torch.bfloat16)
        specs["frontend_embeds"] = P(bspec[0], None, None)
        batch["mrope_positions"] = _meta((3, b, s), torch.int32)
        specs["mrope_positions"] = P(None, bspec[0], None)
    return batch, specs


def _opt_for(arch_name: str):
    # llama4's 395 B parameters need factored moments to fit (DESIGN.md)
    if arch_name.startswith("llama4"):
        return adafactor(), "adafactor"
    return adamw(), "adamw"


def _opt_specs(opt_name: str, opt_state, pspecs):
    if opt_name == "adamw":
        return {"mu": pspecs, "nu": pspecs, "count": P()}
    # adafactor: the factored moments are small; replicated
    return tree.map(lambda _: P(), opt_state)


def hkv_capacity(vocab: int) -> int:
    """The dry run's table: two slots a vocabulary id (the reference's)."""
    return max(1, (2 * vocab) // 128) * 128


class _Entries:
    """(shape, itemsize, spec) of every leaf one side of a step holds."""

    def __init__(self):
        self.items: list = []

    def add(self, leaves: Any, specs: Any) -> None:
        self.items.extend(shard_rules.leaf_entries(leaves, specs))

    def add_table(self, state, specs, n_shards: int) -> None:
        """A sharded table: each plane's leading axis `n_shards` times one
        shard's, the scalar clock and epoch replicated."""
        if isinstance(state, TieredState):
            self.add_table(state.hot, specs.hot, n_shards)
            self.add_table(state.cold, specs.cold, n_shards)
            return
        spec_planes = (specs.keys, specs.digests, specs.scores, specs.values)
        for t, sp in zip(state.planes, spec_planes):
            self.items.append(((t.shape[0] * n_shards,) + tuple(t.shape[1:]), t.element_size(),
                               sp))
        self.items.append(((), _CLOCK_BYTES, specs.clock))
        self.items.append(((), _EPOCH_BYTES, specs.epoch))

    def bytes_per_device(self, mesh: Mesh) -> int:
        return shard_rules.bytes_per_device(self.items, mesh.shape)


class _MetaTable:
    """Stands in for the HKV table in a meta run of ``train_step_hkv``: the
    lookup gives rows of the table's shape and the update does nothing (the
    real ops' dedupe has data-dependent shapes)."""

    def __init__(self, dim: int):
        self.dim = dim

    def lookup(self, tokens, *, train: bool):
        return self, _meta(tuple(tokens.shape) + (self.dim,), torch.float32), 0

    def apply_grads(self, tokens, grads):
        return self


@dataclasses.dataclass
class Cell:
    """One cell's step, its inputs on meta, and the bytes each device holds."""

    record: dict
    mesh: Mesh
    args: _Entries
    step: Callable[[], Any]            # runs the step on the meta inputs
    out_specs: Callable[[Any], _Entries]
    runnable: bool                     # whether the step runs on meta tensors in time

    def argument_bytes(self) -> int:
        return self.args.bytes_per_device(self.mesh)

    def run(self) -> dict:
        """The record: the cell's argument bytes and, where the step runs on
        meta tensors, its output bytes and FLOPs per device from a run of
        the step on the meta inputs."""
        rec = dict(self.record)
        rec["memory"] = {"argument_bytes_per_device": self.argument_bytes()}
        if self.runnable:
            with FlopCounterMode(display=False) as fc:
                outputs = self.step()
            rec["memory"]["output_bytes_per_device"] = (
                self.out_specs(outputs).bytes_per_device(self.mesh))
            rec["cost"] = {"flops_per_device": fc.get_total_flops() / rec["devices"]}
        return rec


def _kv_divisible(lm, mesh: Mesh) -> bool:
    return all(seg.block.kind != "attn" or seg.block.kv_heads % mesh.shape["model"] == 0
               for seg in tuple(lm.prelude) + tuple(lm.segments))


def _state_specs(lm, mesh: Mesh, state, batch: int):
    sspecs = shard_rules.decode_state_specs(mesh, state, _kv_divisible(lm, mesh))
    if batch % _dp_size(mesh) != 0:   # long_500k's batch of 1: replicate the batch dim
        sspecs = tree.map(lambda s: P(*(None if a == "data" else a for a in s)), sspecs,
                          is_leaf=is_spec)
    return sspecs


def build_cell(arch: ArchDef, shape: ShapeCfg, mesh: Mesh, backend: str = "dense",
               scan_train: bool = False) -> Cell:
    """The cell of `arch` at `shape` on `mesh` (a mesh of any devices: only
    its axes and sizes are read).  `scan_train` is the reference's
    scan-over-layers switch; the port always loops over layers, so the
    count does not depend on it."""
    lm = dataclasses.replace(arch.lm, scan_layers=True) if scan_train else arch.lm
    n_dev = math.prod(mesh.shape.values())
    record = {"arch": arch.name, "shape": shape.name, "mesh": None, "backend": backend,
              "kind": shape.kind, "devices": n_dev, "notes": [NOTE_ATTENTION]}
    # a sequence of sLSTM steps is too long a loop to run on meta tensors
    runnable = not (shape.kind in ("train", "prefill") and any(
        seg.block.kind == "slstm" for seg in tuple(lm.prelude) + tuple(lm.segments)))
    if not runnable:
        record["notes"].append(NOTE_SLSTM)
    args = _Entries()
    model = CompositeLM(lm, attention="sdpa")
    params = model.init(device=META)
    record["params"] = sum(p.numel() for p in tree.leaves(params))   # ArchDef.param_count
    pspecs = shard_rules.param_specs(params)
    dp_split = shape.global_batch % _dp_size(mesh) == 0

    if shape.kind == "train":
        opt, opt_name = _opt_for(arch.name)
        batch, bspecs = _batch_specs(arch, shape, mesh, lm.d_model)
        if backend == "hkv":
            lm = dataclasses.replace(lm, embedding_backend="hkv", tied_head=False)
            model = CompositeLM(lm, attention="sdpa")
            params = model.init(device=META)
            pspecs = shard_rules.param_specs(params)
            semb = ShardedHKVEmbedding(
                emb=HKVEmbedding(capacity=hkv_capacity(lm.vocab), dim=lm.d_model,
                                 optimizer=SparseOptimizer("rowwise_adagrad")),
                axis_names=tuple(mesh.axis_names))
            local = semb.local_embedding(n_dev).create(device=META).state
            tspecs = semb.state_specs()
            record["notes"].append(NOTE_HKV)
        opt_state = opt.init(params)
        ospecs = _opt_specs(opt_name, opt_state, pspecs)
        args.add(params, pspecs)
        args.add(opt_state, ospecs)
        if backend == "hkv":
            args.add_table(local, tspecs, n_dev)
        args.add(batch, bspecs)
        builder = StepBuilder(model, opt)

        def out_specs(out):
            ent = _Entries()
            ent.add(out[0], pspecs)
            ent.add(out[1], ospecs)
            if backend == "hkv":
                ent.add_table(local, tspecs, n_dev)
            metrics = {k: v for k, v in out[-1].items() if isinstance(v, torch.Tensor)}
            ent.add(metrics, tree.map(lambda _: P(), metrics))
            return ent

        if backend == "hkv":
            def step():
                return builder.train_step_hkv(params, opt_state, _MetaTable(lm.d_model), batch)
        else:
            def step():
                return builder.train_step(params, opt_state, batch)

    else:
        if backend == "hkv":
            raise ValueError("the HKV backend has a dry-run cell for training shapes only")
        b = shape.global_batch
        if shape.kind == "prefill":
            batch, bspecs = _batch_specs(arch, shape, mesh, lm.d_model)
            extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
            args.add(params, pspecs)
            args.add({"tokens": batch["tokens"], **extras},
                     {"tokens": bspecs["tokens"], **{k: bspecs[k] for k in extras}})

            def step():
                return model.prefill(params, batch["tokens"], shape.seq, **extras)
        else:  # decode
            state = model.init_decode_state(b, shape.seq, device=META)
            toks = _meta((b,), torch.int32)
            args.add(params, pspecs)
            args.add(toks, P(_dp(mesh)) if dp_split else P(None))
            args.add(state, _state_specs(lm, mesh, state, b))

            def step():
                return model.decode_step(params, toks, state)

        def out_specs(out):
            logits, new_state = out
            ent = _Entries()
            lspec = P(*((_dp(mesh) if dp_split else None,) + (None,) * (logits.ndim - 1)))
            ent.add(logits, lspec)
            ent.add(new_state, _state_specs(lm, mesh, new_state, b))
            return ent

    return Cell(record=record, mesh=mesh, args=args, step=step, out_specs=out_specs,
                runnable=runnable)


def build_and_compile(arch_name: str, shape_name: str, mesh_kind: str, backend: str = "dense",
                      scan_train: bool = False) -> dict:
    """The record of one cell on the production mesh (the reference's
    entry point and name; nothing is compiled)."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if shape.skip:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
                "backend": backend, "skipped": shape.skip}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=META)
    cell = build_cell(arch, shape, mesh, backend, scan_train)
    cell.record["mesh"] = mesh_kind
    return cell.run()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--backend", choices=("dense", "hkv"), default="dense")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume a partial grid: skip cells with records")
    ap.add_argument("--scan-train", action="store_true",
                    help="the reference's scan-over-layers switch (the port's count is "
                         "the same either way)")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(name, sh.name) for name in ARCH_NAMES for sh in get_arch(name).shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(os.path.join(args.out, args.mesh), exist_ok=True)
    failed = 0
    for arch_name, shape_name in cells:
        tag = f"{arch_name}__{shape_name}__{args.backend}"
        path = os.path.join(args.out, args.mesh, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if "error" not in json.load(f):
                    print(f"=== {tag} on {args.mesh} === (cached)", flush=True)
                    continue
        print(f"=== {tag} on {args.mesh} ===", flush=True)
        t0 = time.perf_counter()
        try:
            rec = build_and_compile(arch_name, shape_name, args.mesh, args.backend,
                                    scan_train=args.scan_train)
        except Exception as e:  # noqa: BLE001 (recorded; the exit status counts it)
            rec = {"arch": arch_name, "shape": shape_name, "mesh": args.mesh,
                   "backend": args.backend, "error": f"{type(e).__name__}: {e}"}
            failed += 1
            print(f"    FAILED: {rec['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        if "skipped" in rec:
            print(f"    SKIP: {rec['skipped']}", flush=True)
        elif "error" not in rec:
            mem, cost = rec["memory"], rec.get("cost", {})
            print(f"    ok in {time.perf_counter() - t0:.1f} s: "
                  f"args/dev={mem['argument_bytes_per_device'] / 2**30:.2f}GiB"
                  + (f" out/dev={mem['output_bytes_per_device'] / 2**30:.2f}GiB"
                     if "output_bytes_per_device" in mem else "")
                  + (f" flops/dev={cost['flops_per_device']:.3e}" if cost else "")
                  + "".join(f"\n    note: {n}" for n in rec["notes"]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
