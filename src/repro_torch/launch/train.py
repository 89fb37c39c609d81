"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --steps 8 --backend hkv --device cpu --ckpt-dir runs/ckpt

`--smoke` runs the arch's reduced config; without it the published widths.
`--backend hkv` puts the token embedding in a `ShardedHKVTable` over a
`make_dev_mesh(--data-mesh, --model-mesh)` mesh (capacity
max(256, (2 * vocab // 128) * 128) slots, rowwise_adagrad at lr 0.05, a
two-tier hierarchy a shard with `--hkv-hot-capacity`) and unties the head;
`--backend dense` keeps the embedding in the parameter tree.  The run goes
through `TrainDriver` (checkpoints every `--checkpoint-every` steps,
restart on failure).  It runs on the card unless `--device cpu`, and
blocks attend through ``F.scaled_dot_product_attention`` there
(``models.common.attention_impl``, the model's default).

`main(argv)` returns the driver's history, so a caller can run it
in-process; `failure_injector` goes to the driver (it is called with each
step's number before the step and may raise).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--backend", choices=("dense", "hkv"), default="dense")
    ap.add_argument("--hkv-hot-capacity", type=int, default=None,
                    help="run the HKV table as a two-tier hierarchy a shard: this many "
                    "HBM hot slots in front of the cold table; requires --backend hkv")
    ap.add_argument("--optimizer", choices=("adamw", "adamw8bit", "adafactor", "sgdm"),
                    default="adamw")
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.hkv_hot_capacity is not None and args.backend != "hkv":
        ap.error("--hkv-hot-capacity requires --backend hkv")
    return args


def hkv_capacity(vocab: int) -> int:
    """The launcher's table: two slots a vocabulary id, whole buckets."""
    return max(256, (2 * vocab // 128) * 128)


def build(args: argparse.Namespace, failure_injector: Optional[Callable] = None):
    """The `TrainDriver` for `args`, its state (parameters, optimizer state
    and, with --backend hkv, the table) made and placed."""
    from repro_torch.configs import get_arch
    from repro_torch.core.table import resolve_device
    from repro_torch.data import DataCursor, TokenStream
    from repro_torch.distributed import ShardedHKVTable
    from repro_torch.embedding import HKVEmbedding, SparseOptimizer
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.lm import CompositeLM
    from repro_torch.optim import OPTIMIZERS
    from repro_torch.train.driver import TrainDriver
    from repro_torch.train.step import StepBuilder

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    lm = arch.smoke if args.smoke else arch.lm
    if args.backend == "hkv":
        lm = dataclasses.replace(lm, embedding_backend="hkv", tied_head=False)
    model = CompositeLM(lm)
    opt = OPTIMIZERS[args.optimizer]()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    opt_state = opt.init(params)
    builder = StepBuilder(model, opt)
    stream = TokenStream(seed=args.seed, batch=args.batch, seq=args.seq, vocab=lm.vocab,
                         alpha=1.0)

    if args.backend == "hkv":
        mesh = make_dev_mesh(args.data_mesh, args.model_mesh, device=device)
        table = ShardedHKVTable.create(
            mesh,
            HKVEmbedding(capacity=hkv_capacity(lm.vocab), dim=lm.d_model,
                         optimizer=SparseOptimizer("rowwise_adagrad", lr=0.05),
                         hot_capacity=args.hkv_hot_capacity))

        def step_fn(state, batch):
            params, opt_state, table = state
            params, opt_state, table, metrics = builder.train_step_hkv(params, opt_state, table,
                                                                       batch)
            return (params, opt_state, table), metrics

        state = (params, opt_state, table)
    else:
        def step_fn(state, batch):
            params, opt_state = state
            params, opt_state, metrics = builder.train_step(params, opt_state, batch)
            return (params, opt_state), metrics

        state = (params, opt_state)

    def batch_fn(step):
        toks, labels = stream.batch_at(step)
        return {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labels).to(device)}

    driver = TrainDriver(step_fn=step_fn, batch_fn=batch_fn, state=state,
                         ckpt_dir=args.ckpt_dir, cursor=DataCursor(seed=args.seed, step=0),
                         checkpoint_every=args.checkpoint_every,
                         failure_injector=failure_injector)
    return driver


def main(argv=None, *, failure_injector: Optional[Callable] = None) -> dict:
    args = parse_args(argv)
    driver = build(args, failure_injector)
    hist = driver.run(args.steps)
    hist["state"] = driver.state
    losses = hist["loss"]
    print(f"[train] {args.arch} backend={args.backend}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps "
          f"({hist['restarts']} restarts)")
    return hist


if __name__ == "__main__":
    main()
