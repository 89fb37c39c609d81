"""`HKVEmbedding.lookup_train` then `HKVEmbedding.apply_grads`: the sparse
side of a training step (cells `hkv_b.train_zipf`, `hkv_d.train_zipf`).

The prefill goes in through `HKVEmbedding.ingest`.  Every step changes the
table, so the reference replays the prefill and every step of the run.
Kept per checked step: the rows that `lookup_train` returned, compared by
the widest gap (rowwise_adagrad's sums round in the order the card adds
them); the trained rows show in the final planes."""

from __future__ import annotations

from hkvbench.op import Op as Base
from hkvbench.op import gap
from hkvbench.reference import embedding as ref_emb


class Op(Base):
    spans = ("lookup_train", "apply_grads")

    def prefill(self, batch):
        self.emb.ingest(self.table, batch["tokens"])

    def call(self, batch, span):
        with span("lookup_train"):
            self.table, rows = self.emb.lookup_train(self.table, batch["tokens"])
        with span("apply_grads"):
            self.table = self.emb.apply_grads(self.table, batch["tokens"], batch["grads"])
        return rows

    def keep(self, out):
        return out

    def ref_prefill(self, ref, batch):
        ref_emb.ingest(ref, batch["tokens"], self.dim)

    def ref_call(self, ref, batch):
        rows, res = ref_emb.lookup_train(ref, batch["tokens"], self.dim)
        opt = self.config["optimizer"]
        counts = dict(res.counts)
        counts.update(ref_emb.apply_grads(ref, batch["tokens"], batch["grads"], self.dim,
                                          lr=opt["lr"], eps=opt["eps"]))
        return rows, counts

    def compare(self, kept, want):
        return {"rows_gap": gap(kept.reshape(-1, self.dim), want)}
