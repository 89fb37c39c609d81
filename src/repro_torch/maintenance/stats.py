"""TableStats: the whole-table summary of the maintenance subsystem.

The port's copy of ``repro/maintenance/stats.py``, computed from the key
and score planes alone with plain PyTorch reductions, as the reference
computes it with plain jnp (it calls no kernel):

  size / capacity / load_factor   live entries against slots
  occupancy_hist  int32 [S+1]     buckets holding exactly k live entries
  score_q         int64 [5]       score quantiles (min, p25, p50, p75, max)
                                  of the live entries in unsigned order, as
                                  unsigned bits; 0 for an empty table

The quantile index is ``round(q * float32(n - 1))`` in float32, rounding
half to even, as the reference computes it: above 2**24 live entries
float32 no longer holds n - 1 exactly, and the index follows the
reference's rounding there too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import u64

QUANTILES = (0.0, 0.25, 0.5, 0.75, 1.0)


class TableStats(NamedTuple):
    size: torch.Tensor            # int64 [] live entries
    capacity: int
    load_factor: torch.Tensor     # float32 []
    occupancy_hist: torch.Tensor  # int32 [S+1]
    score_q: torch.Tensor         # int64 [5] score quantiles, unsigned bits

    def score_quantiles(self) -> np.ndarray:
        """The score quantiles as numpy uint64 (min..max)."""
        return self.score_q.cpu().numpy().view(np.uint64)


def quantile_index(n: torch.Tensor, slots: int) -> torch.Tensor:
    """int64 [5]: positions of the QUANTILES among `n` ascending live
    scores, round(q * float32(n - 1)) in float32, half to even."""
    q = torch.tensor(QUANTILES, dtype=torch.float32, device=n.device)
    idx = torch.round(q * (n - 1).clamp(min=0).to(torch.float32)).to(torch.int64)
    return idx.clamp(0, slots - 1)


def stats_from_planes(keys: torch.Tensor, scores: Optional[torch.Tensor] = None, *,
                      live: Optional[torch.Tensor] = None) -> TableStats:
    """TableStats of [B, S] key and score planes.  `live` overrides the
    EMPTY-key liveness test; the scores default to zeros."""
    b, s = keys.shape
    dev = keys.device
    if live is None:
        live = ~u64.empty_lanes(keys)
    if scores is None:
        scores = torch.zeros_like(keys)
    hist = torch.bincount(live.sum(dim=1), minlength=s + 1).to(torch.int32)
    n = live.sum()
    # live scores in unsigned order; free slots sort last as the all-ones
    # word and the quantile indices stop short of them
    ranked = torch.sort(u64.flip(torch.where(live, scores, u64.U64_MAX)).reshape(-1)).values
    idx = quantile_index(n, b * s)
    score_q = torch.where(n > 0, u64.flip(ranked[idx]), 0)
    load = torch.div(n.to(torch.float32), torch.tensor(float(b * s), device=dev))
    return TableStats(size=n, capacity=b * s, load_factor=load, occupancy_hist=hist,
                      score_q=score_q)


def combine_stats(a: TableStats, b: TableStats, *, size=None) -> TableStats:
    """Merge two tiers' (or shards') stats into one table-level view.

    Histograms add elementwise (the tiers share the slot width); quantiles
    merge by re-quantiling the two summaries' concatenation, an
    approximation, exact when one side is empty (exact per-tier quantiles
    stay on the inputs).  `size` overrides the sum for hierarchies that
    count inclusive copies once."""
    dev = a.size.device
    n = a.size + b.size if size is None else torch.as_tensor(size, dtype=torch.int64, device=dev)
    cap = a.capacity + b.capacity
    q = torch.cat([a.score_q, b.score_q])
    weight = torch.cat([a.size.expand(5), b.size.expand(5)])
    # an empty side's zeros must not pull the minimum down: they sort last
    q = torch.where(weight > 0, q, u64.U64_MAX)
    merged = u64.flip(torch.sort(u64.flip(q)).values)[torch.tensor([0, 2, 4, 6, 9], device=dev)]
    # one side empty: the other side's quantiles, exactly
    score_q = torch.where(b.size == 0, a.score_q, torch.where(a.size == 0, b.score_q, merged))
    load = torch.div(n.to(torch.float32),
                     torch.tensor(max(float(cap), 1.0), dtype=torch.float32, device=dev))
    return TableStats(size=n, capacity=cap, load_factor=load,
                      occupancy_hist=a.occupancy_hist + b.occupancy_hist, score_q=score_q)
