"""Independent queries at Poisson arrivals (an open loop): a serving
replica's lookups, as MLPerf Inference's DLRM Server scenario sends them.

A query is N samples x len(`field_sizes`) keys, N from `samples_min` to
`samples_max`; lane i draws an id of field i mod len(`field_sizes`) from
the field's Zipf(`alpha`), as `zipf_keys` does, and its key is fmix64(id).
Lane i of query j draws its uniform from the counter (j, i)
(`draw.uniform`), so any query is drawn again from its index and size
alone, and a whole stream of them in a few large calls.

The schedule of n queries is the same set of sizes and of gaps for every
seed, in an order that the seed draws: the sizes are the n quantiles of
the uniform over `samples_min` .. `samples_max`, the gaps between arrivals
the n quantiles of the exponential at `rate_qps`, each in a seeded
permutation.  So the arrivals are a Poisson process at `rate_qps`
conditioned on its count and its total length, and every seed offers the
same keys in the same time.

The prefill is `zipf_keys`': the keys of the `prefill_load * capacity` ids
of highest probability (the ideal cache) with N(0, 1) rows, in batches of
`prefill_batch`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hkvbench import draw
from hkvbench.traffic import zipf_keys

LANE_BITS = 20          # a query's lane count stays below 2^20
GROUP_KEYS = 1 << 24    # keys a call draws on the card


@dataclasses.dataclass(frozen=True)
class Schedule:
    """n queries: due times (s after the stream's start), keys per query,
    each query's first key in `keys`, and every key, on the host."""

    due: np.ndarray
    sizes: np.ndarray
    starts: np.ndarray
    keys: np.ndarray

    def query(self, j: int) -> np.ndarray:
        return self.keys[self.starts[j]:self.starts[j] + self.sizes[j]]


def arrivals(mix: dict, config: dict, seed: int, n: int, stream: str = "window"):
    """(due times in s from the stream's start, keys per query) of n
    queries."""
    rng = np.random.default_rng(draw.seed_of(seed, stream, "arrivals"))
    q = (np.arange(n) + 0.5) / n
    lo, hi = mix["samples_min"], mix["samples_max"]
    samples = lo + np.floor(q * (hi - lo + 1)).astype(np.int64)
    gaps = -np.log1p(-q) / mix["rate_qps"]
    return np.cumsum(gaps[rng.permutation(n)]), samples[rng.permutation(n)] * len(mix["field_sizes"])


def _keys(mix: dict, seed: int, stream: str, rids: torch.Tensor, lanes: torch.Tensor):
    f = len(mix["field_sizes"])
    u = draw.uniform((rids << LANE_BITS) | lanes, seed, stream, "query")
    return draw.fmix64(draw.zipf_lanes(u, lanes % f, mix["field_sizes"], mix["alpha"]))


def query(mix: dict, config: dict, seed: int, j: int, size: int, device: torch.device,
          stream: str = "window") -> torch.Tensor:
    """Query j's `size` keys (int64 bit patterns) on `device`."""
    lanes = torch.arange(size, device=device)
    return _keys(mix, seed, stream, torch.full_like(lanes, j), lanes)


def schedule(mix: dict, config: dict, seed: int, n: int, device: torch.device,
             stream: str = "window") -> Schedule:
    """n queries' arrivals and keys: drawn on `device` in groups of about
    `GROUP_KEYS` keys and kept on the host."""
    due, sizes = arrivals(mix, config, seed, n, stream)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    host = torch.empty(int(sizes.sum()), dtype=torch.int64)
    j = 0
    while j < n:
        k = j + 1 + int(np.searchsorted(np.cumsum(sizes[j + 1:]), GROUP_KEYS - sizes[j], "right"))
        a, b = int(starts[j]), int(starts[k - 1] + sizes[k - 1])
        size = torch.as_tensor(sizes[j:k], device=device)
        rids = torch.repeat_interleave(torch.arange(j, k, device=device), size)
        first = torch.as_tensor(starts[j:k] - a, device=device)
        lanes = torch.arange(b - a, device=device) - torch.repeat_interleave(first, size)
        host[a:b].copy_(_keys(mix, seed, stream, rids, lanes))
        j = k
    return Schedule(due, sizes, starts, host.numpy().view(np.uint64))


def prefill(mix: dict, config: dict, seed: int, device: torch.device):
    return zipf_keys.prefill(dict(mix, batch=mix["prefill_batch"]), config, seed, device)
