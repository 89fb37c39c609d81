"""The paper's own workload: a DLRM-style recommender whose embeddings live
in an HKV table under continuous online ingestion (configs A-D of Table 5,
scaled; port of ``examples/dlrm_continuous.py``).

    PYTHONPATH=src python -m repro_torch.examples.dlrm_continuous [--device cpu]

26 sparse criteo-style fields share one HKV table (each field salts its
ids into its own slice of the key space); dense features go through a
bottom MLP; the interaction is a dot product over the field embeddings;
training is click-through logistic regression on synthetic Zipfian
streams.  The rows' gradient goes to the table's sparse optimizer
(`apply_grads`), the MLPs' to plain SGD.

The labels are random, so the stream carries no signal to learn: the loss
sits near ln 2 throughout, and the reference's check that the last 20
steps' mean loss is below the first 20's holds or fails with the initial
draws (it fails for this package's).  The check here is what training does
on such a stream: each step's update lowers the loss on its own batch,
read back through the table (`lookup_serve`) after `apply_grads`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.hkv_dlrm import PAPER_CONFIGS, scaled
from repro_torch.data import zipf_keys
from repro_torch.models.dlrm import DLRM


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.dlrm_continuous")
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = scaled(PAPER_CONFIGS["B"], scale=2**13)  # 16k slots
    emb = cfg.embedding()
    table = emb.create(device=dev)
    rng = np.random.default_rng(0)
    model = DLRM(cfg.dim, cfg.num_sparse, cfg.dense_features, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(0))
    nf = cfg.num_sparse

    batch, lr = 256, 0.05
    losses, after = [], []
    for step in range(80):
        # each field hashes into its own slice of the key space; the token
        # API takes int32 ids: the low bits, salted by field
        field_keys = np.stack([zipf_keys(rng, batch, 0.99, 10**6) ^ np.uint64(f << 56)
                               for f in range(nf)], axis=1)
        toks = torch.from_numpy((field_keys & np.uint64(0x7FFFFFFF)).astype(np.int32)).to(dev)
        dense_x = torch.from_numpy(rng.normal(size=(batch, cfg.dense_features))
                                   .astype(np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(0, 2, size=batch).astype(np.float32)).to(dev)

        table, rows = emb.lookup_train(table, toks)
        rows = rows.detach().requires_grad_()
        loss = model.loss(rows, dense_x, labels)
        loss.backward()
        model.sgd_(lr)
        table = emb.apply_grads(table, toks, rows.grad)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            after.append(float(model.loss(emb.lookup_serve(table, toks), dense_x, labels)))
        if step % 20 == 19:
            print(f"step {step:3d}: loss={np.mean(losses[-20:]):.4f} "
                  f"lf={table.load_factor():.3f}")

    gain = np.asarray(losses) - np.asarray(after)
    print(f"loss {np.mean(losses[:20]):.4f} -> {np.mean(losses[-20:]):.4f}; each step's own "
          f"batch after its update: {np.mean(gain):.2e} lower on average, lower in "
          f"{int((gain > 0).sum())} of {len(gain)} steps")
    assert (gain > 0).all(), "an update did not lower its own batch's loss"
    print("ok.")


if __name__ == "__main__":
    main()
