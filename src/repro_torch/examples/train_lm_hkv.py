"""End-to-end driver: train an LM with the HKV dynamic-embedding backend
for a few hundred steps, with checkpoint/restart fault tolerance (port of
``examples/train_lm_hkv.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_hkv [--steps 200] [--device cpu]

The paper's deployment story in miniature: the token embedding is a
cache-semantic HKV table (a find_or_insert of each batch, sparse
rowwise_adagrad through the updater role), the backbone a GQA transformer
(the arch's reduced config), and the driver checkpoints the table, the
parameters and the data cursor together; a failure injected two thirds
into the run restores the last checkpoint and replays from it.
"""

from __future__ import annotations

import argparse
import shutil

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm_hkv")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--ckpt-dir", default="runs/example_hkv_ckpt")
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as train_mod

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    every = max(args.steps // 8, 1)
    fail_at = {2 * args.steps // 3}

    def injector(step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")

    hist = train_mod.main(["--arch", args.arch, "--smoke", "--steps", str(args.steps),
                           "--batch", "4", "--seq", "64", "--backend", "hkv",
                           "--ckpt-dir", args.ckpt_dir, "--checkpoint-every", str(every),
                           "--device", args.device], failure_injector=injector)
    losses = hist["loss"]
    k = max(len(losses) // 10, 1)
    print(f"loss: first-{k}-avg {np.mean(losses[:k]):.3f} -> "
          f"last-{k}-avg {np.mean(losses[-k:]):.3f} ({hist['restarts']} restarts)")
    assert hist["restarts"] == 1, "the injected failure did not restart the run"
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), "no learning signal!"
    print("ok.")
    return hist


if __name__ == "__main__":
    main()
