"""`HKVTable.insert_or_assign`: ingestion (cell `hkv_b.ingest_fresh`).

Every batch changes the table, so the reference replays the prefill and
every batch of the run.  Kept per checked batch: the statuses, compared
exactly; the rows written show in the final planes."""

from __future__ import annotations

import torch

from hkvbench.op import Op as Base
from hkvbench.op import mismatch
from hkvbench.reference.table import pad


class Op(Base):
    spans = ("insert_or_assign",)

    def prefill(self, batch):
        self.table.insert_or_assign(batch["keys"].view(torch.uint64), batch["rows"])

    def call(self, batch, span):
        with span("insert_or_assign"):
            return self.table.insert_or_assign(batch["keys"].view(torch.uint64), batch["rows"])

    def keep(self, out):
        return out.status

    def ref_prefill(self, ref, batch):
        ref.upsert(batch["keys"], pad(batch["rows"], self.width))

    def ref_call(self, ref, batch):
        res = ref.upsert(batch["keys"], pad(batch["rows"], self.width))
        return res.status, res.counts

    def compare(self, kept, want):
        return {"status_mismatch": mismatch(kept, want)}
