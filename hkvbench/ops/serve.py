"""`OnlineEmbeddingEngine` over the configuration's `HKVTable`: a serving
replica's requests, spliced into waves (cell `hkv_b.serve_open`).

The loop is open (`hkvbench/open_loop.py`): each query is submitted when it
falls due, stamped with its due time.  The engine serves readonly waves of
`find` with continuous admission, so nothing changes the table after the
prefill, which goes in through `insert_or_assign` as `find`'s does; the
reference answers only the queries it checks.  Kept per checked request:
the found flags and the rows the engine unpacked into it on the host,
compared exactly (the rows are copies, and a miss is zeros on both
sides)."""

from __future__ import annotations

import torch

from hkvbench.op import Op as Base
from hkvbench.op import gap, mismatch
from hkvbench.ops import find


class Op(Base):
    spans = ("submit", "step", "poll")
    stateful = False

    prefill = find.Op.prefill
    ref_prefill = find.Op.ref_prefill

    def engine(self, mix: dict):
        from repro_torch.serving import OnlineEmbeddingEngine

        return OnlineEmbeddingEngine(self.table, wave_size=mix["wave_size"],
                                     miss_policy=mix["miss_policy"],
                                     admission=mix["admission"])

    def request(self, rid: int, keys, t_due: float):
        from repro_torch.serving import EmbeddingRequest

        return EmbeddingRequest(rid=rid, keys=keys, t_submit=t_due)

    def keep(self, req):
        return torch.from_numpy(req.found), torch.from_numpy(req.values)

    def ref_call(self, ref, batch):
        found, rows, _scores, counts = ref.find(batch["keys"], self.dim)
        return (found, rows), counts

    def compare(self, kept, want):
        return {"found_mismatch": mismatch(kept[0], want[0]),
                "rows_gap": gap(kept[1], want[1])}
