"""Seeded Zipfian key streams, request arrival processes and LM token
batches (the port's copy of ``repro/data/synthetic.py``, numpy only, bit
for bit the reference's).

`zipf_ranks` draws ranks from a truncated Zipf(α) through the analytic
inverse CDF of the harmonic approximation; `zipf_keys` maps ranks through
fmix64, so hot keys are spread over the uint64 space.  The arrival
generators give the request sizes of the serving engine's ticks.
"""

from __future__ import annotations

import dataclasses

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


# =============================================================================
# Arrival processes — request sizes per serving tick (SLO workloads)
# =============================================================================
#
# The serving engine's SLO numbers (queue-wait vs service p50/p99) only
# mean something under NON-steady arrivals: a burst that outruns one
# wave's lanes queues, and the queue-wait it accrues is exactly what
# continuous-batch admission exists to cut.  Each generator returns an
# int64 array of REQUEST SIZES (keys per tick) for `ticks` serving ticks,
# calibrated so the mean load is `base_load * wave_size` keys/tick —
# comparable total work across arrival shapes.

ARRIVAL_KINDS = ("steady", "burst", "diurnal")


def steady_sizes(rng: np.random.Generator, ticks: int, wave_size: int,
                 *, base_load: float = 0.75) -> np.ndarray:
    """Constant-rate arrivals: every tick offers the same key count."""
    return np.full(ticks, max(1, int(round(base_load * wave_size))), np.int64)


def poisson_burst_sizes(rng: np.random.Generator, ticks: int, wave_size: int,
                        *, base_load: float = 0.5, burst_prob: float = 0.15,
                        burst_mult: float = 6.0) -> np.ndarray:
    """Poisson arrivals with a bursty modulated rate: each tick draws
    Poisson(λ) keys where λ is the base rate, except Bernoulli(burst_prob)
    ticks fire at `burst_mult`× — the flash-crowd shape whose queue
    depth exposes admission-granularity latency."""
    lam = base_load * wave_size
    bursty = rng.random(ticks) < burst_prob
    rates = np.where(bursty, burst_mult * lam, lam)
    return rng.poisson(rates).astype(np.int64)


def sinusoidal_sizes(rng: np.random.Generator, ticks: int, wave_size: int,
                     *, base_load: float = 0.5, amplitude: float = 0.9,
                     period: int = 32) -> np.ndarray:
    """Diurnal arrivals: Poisson around a sinusoidal rate —
    λ(t) = base * (1 + amplitude * sin(2πt/period)), floor 0.  The slow
    swell fills and drains the queue once per period."""
    t = np.arange(ticks)
    lam = base_load * wave_size * (
        1.0 + amplitude * np.sin(2.0 * np.pi * t / period))
    return rng.poisson(np.maximum(lam, 0.0)).astype(np.int64)


def arrival_sizes(kind: str, rng: np.random.Generator, ticks: int,
                  wave_size: int, **kwargs) -> np.ndarray:
    """Dispatch on arrival shape: 'steady' | 'burst' | 'diurnal'."""
    try:
        fn = {"steady": steady_sizes, "burst": poisson_burst_sizes,
              "diurnal": sinusoidal_sizes}[kind]
    except KeyError:
        raise ValueError(
            f"arrival kind {kind!r}; one of {ARRIVAL_KINDS}") from None
    return fn(rng, ticks, wave_size, **kwargs)


@dataclasses.dataclass
class TokenStream:
    """Deterministic LM token batches with Zipfian unigram statistics.

    Yields (tokens, labels) int32 [batch, seq]: labels are tokens shifted
    by one (next-token LM).  `rank`/`world` slice the global batch for DP;
    each batch is a pure function of (seed, step, rank, world).
    """

    seed: int
    batch: int           # per-host batch after DP slicing
    seq: int
    vocab: int
    alpha: float = 1.0
    rank: int = 0
    world: int = 1

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.rank, self.world]))
        toks = zipf_ranks(rng, self.batch * (self.seq + 1), self.alpha, self.vocab)
        toks = toks.reshape(self.batch, self.seq + 1).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
