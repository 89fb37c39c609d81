"""`HKVTable.find`: a serving replica's lookups (cell `hkv_b.find_zipf`).

The prefill goes in through `insert_or_assign`; a find changes nothing,
so the reference answers only the batches it checks.  Kept per checked
batch: the found flags, the rows and the scores, all compared exactly."""

from __future__ import annotations

import torch

from hkvbench.op import Op as Base
from hkvbench.op import gap, mismatch
from hkvbench.reference.table import pad


class Op(Base):
    spans = ("find",)
    stateful = False

    def prefill(self, batch):
        self.table.insert_or_assign(batch["keys"].view(torch.uint64), batch["rows"])

    def call(self, batch, span):
        with span("find"):
            return self.table.find(batch["keys"].view(torch.uint64))

    def keep(self, out):
        return out.found, out.values, out.scores

    def ref_prefill(self, ref, batch):
        ref.upsert(batch["keys"], pad(batch["rows"], self.width))

    def ref_call(self, ref, batch):
        found, rows, scores, counts = ref.find(batch["keys"], self.dim)
        return (found, rows, scores), counts

    def compare(self, kept, want):
        return {"found_mismatch": mismatch(kept[0], want[0]),
                "rows_gap": gap(kept[1], want[1]),
                "scores_mismatch": mismatch(kept[2], want[2])}
