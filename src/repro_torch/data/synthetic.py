"""Seeded Zipfian key streams (the port's copy of the key generators of
``repro/data/synthetic.py``, numpy only, bit for bit the reference's).

`zipf_ranks` draws ranks from a truncated Zipf(α) through the analytic
inverse CDF of the harmonic approximation; `zipf_keys` maps ranks through
fmix64, so hot keys are spread over the uint64 space.
"""

from __future__ import annotations

import numpy as np


def zipf_ranks(rng: np.random.Generator, n: int, alpha: float, k: int) -> np.ndarray:
    """Ranks in [0, k) with P(r) ∝ (r+1)^-alpha, via inverse harmonic CDF."""
    u = rng.random(n)
    if abs(alpha - 1.0) < 1e-9:
        h = np.log(k + 1.0)
        ranks = np.expm1(u * h)
    else:
        h = ((k + 1.0) ** (1.0 - alpha) - 1.0) / (1.0 - alpha)
        ranks = (u * h * (1.0 - alpha) + 1.0) ** (1.0 / (1.0 - alpha)) - 1.0
    return np.clip(ranks.astype(np.int64), 0, k - 1)


def _fmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return x


def zipf_keys(rng: np.random.Generator, n: int, alpha: float, key_space: int) -> np.ndarray:
    """Power-law uint64 feature ids: rank -> fmix64(rank)."""
    return _fmix64(zipf_ranks(rng, n, alpha, key_space))
