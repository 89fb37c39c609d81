"""Online embedding serving under continuous ingestion, the paper's
deployment scenario (Fig. 1), driven end to end through the serving stack
(port of ``examples/online_serving.py``).

    PYTHONPATH=src python -m repro_torch.examples.online_serving [--device cpu]

An `OnlineEmbeddingEngine` (reader role) serves Zipfian lookups from a
`TieredHKVTable` behind a `TablePublisher`, while an `OnlineTrainer`
(updater and inserter roles) streams gradient updates and publishes whole
tables.  Eviction runs live at every structural op; the engine's miss
policy 'admit' makes served misses admit themselves.  The tail shows the
cross-process publication path: the served table is drained through
`export_delta` and replayed into a fresh replica with `ingest_delta`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import HKVTable, TieredHKVTable
from repro_torch.data import zipf_keys
from repro_torch.serving import (EmbeddingRequest, OnlineEmbeddingEngine, OnlineTrainer,
                                 TablePublisher, export_delta, ingest_delta)

DIM = 16
WAVE = 512
HOT, COLD = 8 * 128, 64 * 128


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.online_serving")
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    table = TieredHKVTable.create(hot_capacity=HOT, cold_capacity=COLD, dim=DIM,
                                  score_policy="lfu",  # LFU: best hit rate at α≈1 (Table 8)
                                  device=dev)
    pub = TablePublisher(table)
    trainer = OnlineTrainer(publisher=pub, publish_every=2, lr=0.1)
    eng = OnlineEmbeddingEngine(pub, wave_size=WAVE, miss_policy="admit")

    serve_rng = np.random.default_rng(1)
    train_rng = np.random.default_rng(0)
    key_space = 2 * COLD
    grads = torch.full((WAVE, DIM), 0.1, dtype=torch.float32, device=dev)

    hit_hist = []
    for step in range(40):
        # --- online training path: a Zipfian batch (inserter + updater) -----
        trainer.train_step(zipf_keys(train_rng, WAVE, 1.05, key_space), grads)
        # --- concurrent serving path: wave-batched lookups (reader) ---------
        eng.submit(EmbeddingRequest(rid=step, keys=zipf_keys(serve_rng, WAVE, 1.05, key_space)))
        r = eng.step()
        hit_hist.append(r.hit_rate)
        if step % 10 == 9:
            m = eng.metrics()
            print(f"step {step:3d}: hit={100 * np.mean(hit_hist[-10:]):5.1f}% "
                  f"hot={100 * m.hot_rate:5.1f}% kv/s={m.kv_per_s / 1e3:6.1f}k "
                  f"published=v{pub.version}")

    m = eng.metrics()
    print(f"steady state: hit-rate trend {100 * np.mean(hit_hist[:10]):.1f}% -> "
          f"{100 * np.mean(hit_hist[-10:]):.1f}%, p99 wave latency "
          f"{m.p99_latency_s * 1e3:.1f} ms")
    assert np.mean(hit_hist[-10:]) > np.mean(hit_hist[:10])

    # --- cross-process publish: export the hierarchy, replay into a replica --
    delta = export_delta(pub.table)
    replica = ingest_delta(HKVTable.create(capacity=HOT + COLD, dim=DIM, device=dev), delta)
    probe = zipf_keys(serve_rng, WAVE, 1.05, key_space)
    src = pub.table.find(probe, promote=False)
    dst = replica.find(probe)
    agree = float((src.found == dst.found).float().mean())
    print(f"delta publish: {delta.count} entries -> replica; probe membership agreement "
          f"{100 * agree:.1f}%")
    assert agree > 0.95
    print("ok.")


if __name__ == "__main__":
    main()
