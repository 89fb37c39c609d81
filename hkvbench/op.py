"""What an op (``ops/<op>.py``) is: how a cell feeds its batches to
the program and to the reference, what it keeps of the program's answers,
and how it compares them.

The program is `repro_torch`: its table is the configuration's
`HKVEmbedding` table, built and driven only through the port's public
entries.  The reference is ``reference/``; the two get the same generated
batches and nothing else of each other's.
"""

from __future__ import annotations

import torch

from hkvbench.reference.table import RefTable

# A row gap is |program - reference| over max(|reference|, GAP_FLOOR): the
# rows are of order 0.1 to 1, and an entry near 0 is judged by the rows'
# scale rather than its own.
GAP_FLOOR = 2.0 ** -6
CHUNK_ROWS = 1 << 22


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative gap between two row blocks (0.0 when equal)."""
    got, want = got.to(want.device, torch.float32), want.float()
    den = want.abs().clamp_min(GAP_FLOOR)
    return float(((got - want).abs() / den).max()) if want.numel() else 0.0


def mismatch(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(want.device) != want).sum())


class Op:
    """One cell's entry into the program.  Subclasses set `spans` (the
    benchmark spans of one call, in order), `stateful` (whether a call
    changes the table, so that the reference replays every batch) and
    implement the hooks below."""

    spans: tuple = ()
    stateful: bool = True

    def __init__(self, config: dict, device: torch.device, value_dtype: str):
        from repro_torch.embedding import HKVEmbedding, SparseOptimizer

        opt = config["optimizer"]
        if config["slots_per_bucket"] != 128:
            raise ValueError("the port's tables have 128 slots a bucket")
        self.config, self.device = config, device
        self.emb = HKVEmbedding(
            capacity=config["capacity"], dim=config["dim"],
            optimizer=SparseOptimizer(opt["name"], lr=opt["lr"], eps=opt["eps"]),
            buckets_per_key=config["buckets_per_key"], score_policy=config["score_policy"],
            value_dtype=getattr(torch, value_dtype), value_tier=config["value_tier"])
        self.table = None

    @property
    def dim(self) -> int:
        return self.config["dim"]

    @property
    def width(self) -> int:
        return self.emb.config().total_value_dim

    def create(self) -> None:
        self.table = self.emb.create(device=self.device)

    # -- the program's side ------------------------------------------------------

    def prefill(self, batch: dict) -> None:
        raise NotImplementedError

    def call(self, batch: dict, span):
        """One timed call; `span(name)` wraps each entry into the port."""
        raise NotImplementedError

    def keep(self, out):
        """What of a call's answer is kept for the comparison."""
        raise NotImplementedError

    # -- the reference's side ----------------------------------------------------

    def reference(self) -> RefTable:
        c = self.config
        return RefTable(c["capacity"], self.width, c["buckets_per_key"], self.device,
                        score_policy=c["score_policy"], value_dtype=c["value_dtype"])

    def ref_prefill(self, ref: RefTable, batch: dict) -> None:
        raise NotImplementedError

    def ref_call(self, ref: RefTable, batch: dict):
        """(the reference's answer, the batch's work counts)."""
        raise NotImplementedError

    def compare(self, kept, want) -> dict:
        """{number name: value} for one kept answer against the reference's."""
        raise NotImplementedError

    # -- the final state ----------------------------------------------------------

    def compare_planes(self, ref: RefTable) -> dict:
        """The program's planes against the reference's: metadata exactly,
        value rows (optimizer column included) by the widest gap, in blocks
        so that a plane in host memory crosses a block at a time."""
        st = self.table.state
        out = {f"plane_{name}_mismatch": mismatch(getattr(st, name), getattr(ref, name))
               for name in ("keys", "digests", "scores")}
        worst = 0.0
        for start in range(0, ref.values.shape[0], CHUNK_ROWS):
            stop = start + CHUNK_ROWS
            worst = max(worst, gap(st.values[start:stop], ref.values[start:stop]))
        out["plane_values_gap"] = worst
        return out

    def free(self) -> None:
        self.table = None
