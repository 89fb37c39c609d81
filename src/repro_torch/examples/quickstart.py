"""Quickstart: the HKV cache-semantic hash table in five minutes (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's core semantics end to end through the public `HKVTable`
handle: batched upsert with in-place eviction at load factor 1.0,
digest-accelerated lookup, admission control, the updater role in a fused
op session, and the two-tier hierarchy (capacity beyond HBM).  The port's
tables change in place: an op's `.table` is the same handle.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import HKVTable, TieredHKVTable


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = args.device

    # A 16k-slot table of 32-dim float values, dual bucket, LRU scoring: the
    # paper's config-B analogue at laptop scale
    table = HKVTable.create(capacity=128 * 128, dim=32, buckets_per_key=2, score_policy="lru",
                            device=dev)
    rng = np.random.default_rng(0)

    # --- continuous online ingestion: 3x capacity through a full table ------
    print("ingesting 3x capacity ...")
    for step in range(12):
        keys = rng.integers(0, 2**50, size=4096).astype(np.uint64)
        values = torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32))
        res = table.insert_or_assign(keys, values)   # keys: raw numpy uint64
        table = res.table
        status = res.status.cpu().numpy()
        print(f"  step {step:2d}: lf={table.load_factor():.3f} "
              f"updated={np.sum(status == 1):4d} inserted={np.sum(status == 2):4d} "
              f"evicted={np.sum(status == 3):4d} rejected={np.sum(status == 4):4d}")
    assert table.load_factor() > 0.99  # full is the normal operating point

    # --- reader role: digest-accelerated find --------------------------------
    q = rng.integers(0, 2**50, size=1024).astype(np.uint64)
    found = table.find(q)
    print(f"find: {int(found.found.sum())}/1024 hits at lf=1.0 "
          f"(misses cost one bucket row each, Prop. 3.1)")

    # --- updater role via an op session (one shared probe) -------------------
    exp = table.export_batch(0, 4)
    some = exp.keys[exp.mask][:16]
    sess = table.session()
    sess.assign(some, torch.ones((16, 32)))   # updater
    check = sess.find(some)                   # reader: shares the same locate
    table = sess.commit()
    print(sess.explain())
    assert bool(torch.all(check.get().values == 1.0))
    print("assign+find fused: 16 rows updated in place, one probe, no structural change")

    # --- admission control (custom scores) -----------------------------------
    t = HKVTable.create(capacity=512, dim=4, score_policy="custom", device=dev)
    res = t.insert_or_assign(np.arange(1024, dtype=np.uint64), torch.zeros((1024, 4)),
                             custom_scores=np.full(1024, 100, np.uint64))
    low = res.table.insert_or_assign(np.arange(5000, 5128, dtype=np.uint64),
                                     torch.zeros((128, 4)),
                                     custom_scores=np.full(128, 1, np.uint64))
    rejected = int((low.status == 4).sum())
    print(f"admission control: low-score burst -> {rejected}/128 rejected (Table 9)")
    assert rejected == 128

    # --- capacity beyond HBM: the two-tier hierarchy -------------------------
    # a small HBM hot tier in front of a large host-capacity cold tier:
    # hot-tier evictions DEMOTE (with their values) instead of vanishing,
    # and cold keys read again PROMOTE back up on the miss path
    tiered = TieredHKVTable.create(hot_capacity=2 * 128, cold_capacity=32 * 128, dim=8,
                                   device=dev)
    early = np.arange(1, 257, dtype=np.uint64)
    tiered = tiered.insert_or_assign(early, torch.full((256, 8), 5.0)).table
    # churn the hot tier with 4x its capacity of fresh keys
    for i in range(4):
        churn = np.arange(10_000 + 256 * i, 10_256 + 256 * i, dtype=np.uint64)
        tiered = tiered.insert_or_assign(churn, torch.zeros((256, 8))).table
    out = tiered.find(early)               # cold hits are promoted on access
    tiered = out.table
    print(f"tiered: {int(out.found.sum())}/256 early keys survived a 4x hot-capacity churn "
          f"(hot hits: {int(out.hot_hit.sum())}, promoted back: {int(out.promoted)}, "
          f"demoted victims: {int(out.demoted)}, lost: {int(out.dropped)})")
    assert bool(out.found.all())
    assert bool(torch.all(out.values == 5.0))
    print("ok.")


if __name__ == "__main__":
    main()
