"""`HKVEmbedding(hot_capacity=...).lookup_train` then `.apply_grads`: the
training step on the tier hierarchy, a hot tier in HBM over a cold tier
whose value plane is in pinned host memory (cell `tiered.train_zipf`).

As `embedding_step`, on the configuration's `HKVEmbedding` with the hot
tier's `hot_capacity` slots in front of its `capacity`-slot cold tier,
placed and scored per `cold_value_tier` and `cold_score_policy`.  The
reference is the hierarchy's (`reference/tiered.py`); the final planes
of both tiers are compared, named by tier, the cold plane a block of rows
at a time."""

from __future__ import annotations

import dataclasses

from hkvbench.op import CHUNK_ROWS, gap, mismatch
from hkvbench.ops.embedding_step import Op as Step
from hkvbench.reference import embedding as ref_emb
from hkvbench.reference import tiered as ref_tiered


class Op(Step):
    def __init__(self, config, device, value_dtype):
        super().__init__(config, device, value_dtype)
        self.emb = dataclasses.replace(self.emb, hot_capacity=config["hot_capacity"],
                                       cold_score_policy=config["cold_score_policy"],
                                       cold_value_tier=config["cold_value_tier"])

    def reference(self):
        c = self.config
        return ref_tiered.RefHierarchy(c["hot_capacity"], c["capacity"], self.width,
                                       c["buckets_per_key"], self.device,
                                       score_policy=c["score_policy"],
                                       cold_score_policy=c["cold_score_policy"],
                                       value_dtype=c["value_dtype"])

    def ref_prefill(self, ref, batch):
        ref_tiered.ingest(ref, batch["tokens"], self.dim)

    def ref_call(self, ref, batch):
        rows, counts = ref_tiered.lookup_train(ref, batch["tokens"], self.dim)
        opt = self.config["optimizer"]
        counts.update(ref_emb.apply_grads(ref.hot, batch["tokens"], batch["grads"], self.dim,
                                          lr=opt["lr"], eps=opt["eps"]))
        return rows, counts

    def compare_planes(self, ref):
        st = self.table.state
        return {**_planes("hot", st.hot, ref.hot), **_planes("cold", st.cold, ref.cold)}


def _planes(tier: str, st, ref) -> dict:
    """One tier's planes against the reference's: metadata exactly, value
    rows by the widest gap, a block of rows at a time."""
    out = {f"{tier}_plane_{name}_mismatch": mismatch(getattr(st, name), getattr(ref, name))
           for name in ("keys", "digests", "scores")}
    out[f"{tier}_plane_values_gap"] = max(
        (gap(st.values[i:i + CHUNK_ROWS], ref.values[i:i + CHUNK_ROWS])
         for i in range(0, ref.values.shape[0], CHUNK_ROWS)), default=0.0)
    return out
