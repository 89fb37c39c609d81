"""Seeded draws on the device: the per-batch generators, Zipf ranks and
fmix64, shared by the traffic kinds in ``traffic/``.

Every batch draws from a generator of its own, seeded from (seed, stream,
index), so a batch can be drawn again from its index alone: the reference
replays the run from the same inputs, and a batch is drawn just before its
call instead of from a pool that a long window would cycle.

`uniform` is the counter-based alternative to a generator: a uniform from
each counter alone, so that one query of an open-loop stream is drawn
again without the rest (`traffic/poisson_queries.py`).

`field_ids` and `zipf_lanes` draw by the inverse CDF of a truncated
Zipf(α) through the harmonic approximation and `fmix64` is MurmurHash3's
64-bit finalizer, the arithmetic of ``repro_torch/data/synthetic.py``
(numpy on the host there), here in torch on the device.
"""

from __future__ import annotations

import math

import torch

MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def seed_of(seed: int, *words) -> int:
    """A 64-bit seed from the run's seed and words naming a stream (ints
    or strings)."""
    s = _splitmix64(seed & MASK64)
    for w in words:
        w = int.from_bytes(w.encode(), "little") if isinstance(w, str) else int(w)
        s = _splitmix64(s ^ _splitmix64(w & MASK64))
    return s


def generator(device: torch.device, seed: int, *words) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *words))
    return g


def to_signed(x: int) -> int:
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def fmix64(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 64-bit finalizer on int64 bit patterns (a bijection;
    int64 products wrap modulo 2^64, the shifts are logical)."""
    low31 = (1 << 31) - 1
    x = x ^ ((x >> 33) & low31)
    x = x * to_signed(0xFF51AFD7ED558CCD)
    x = x ^ ((x >> 33) & low31)
    x = x * to_signed(0xC4CEB9FE1A85EC53)
    return x ^ ((x >> 33) & low31)


# ---- sparse fields of published sizes ------------------------------------------
# Field f holds the ids offset[f] .. offset[f] + size[f] - 1, offset[f] the
# sum of the sizes before it; each field draws its ranks from Zipf(alpha)
# over its own size, rank r being id offset[f] + r.


def offsets(sizes) -> list:
    out, at = [], 0
    for n in sizes:
        out.append(at)
        at += n
    return out


_FIELDS: dict = {}


def _fields(sizes, alpha: float, device: torch.device):
    """Per field, on the device once: the inverse CDF's scale, the last
    rank and the first id."""
    key = (tuple(sizes), alpha, str(device))
    if key not in _FIELDS:
        k = torch.tensor(sizes, dtype=torch.float64)
        scale = torch.log1p(k) if abs(alpha - 1.0) < 1e-9 else (k + 1.0) ** (1.0 - alpha) - 1.0
        _FIELDS[key] = (scale.to(device), (k - 1).to(torch.int64).to(device),
                        torch.tensor(offsets(sizes), dtype=torch.int64, device=device))
    return _FIELDS[key]


def field_ids(g: torch.Generator, n: int, sizes, alpha: float) -> torch.Tensor:
    """n ids, lane i of field i mod len(sizes), each drawn from its field's
    Zipf: rank r of a field of size k with probability proportional to
    (r + 1)^-alpha, by the inverse CDF of the continuous density over
    [0, k), a field's constants broadcast over its lanes."""
    f = len(sizes)
    scale, last, base = _fields(sizes, alpha, g.device)
    u = torch.rand((-(-n // f), f), generator=g, dtype=torch.float64, device=g.device)
    return _inverse_cdf(u, scale, last, base, alpha).view(-1)[:n]


def zipf_lanes(u: torch.Tensor, field: torch.Tensor, sizes, alpha: float) -> torch.Tensor:
    """The ids that `field_ids`' inverse CDF gives the uniforms `u`
    (float64 in [0, 1), overwritten), lane i of field `field[i]`: for draws
    whose uniforms come from `uniform` rather than a generator."""
    scale, last, base = _fields(sizes, alpha, u.device)
    return _inverse_cdf(u, scale[field], last[field], base[field], alpha)


def _inverse_cdf(u, scale, last, base, alpha: float) -> torch.Tensor:
    """Ranks by the truncated Zipf's inverse CDF, offset to their fields'
    ids (`u` is overwritten)."""
    if abs(alpha - 1.0) < 1e-9:
        ranks = torch.expm1(u.mul_(scale))
    else:
        ranks = u.mul_(scale).add_(1.0).pow_(1.0 / (1.0 - alpha)).sub_(1.0)
    return torch.minimum(ranks.to(torch.int64).clamp_(min=0), last).add_(base)


def uniform(counter: torch.Tensor, seed: int, *words) -> torch.Tensor:
    """A float64 uniform in [0, 1) for each int64 counter, from fmix64 of
    the counter spread by the golden ratio and salted by (seed, words):
    counter-based, so any part of a stream is drawn again from its
    counters alone."""
    x = fmix64(counter * to_signed(0x9E3779B97F4A7C15) + to_signed(seed_of(seed, *words)))
    return ((x >> 11) & ((1 << 53) - 1)).to(torch.float64).mul_(2.0 ** -53)


def hottest(sizes, alpha: float, n: int) -> list:
    """How many of each field's hottest ranks make up the n ids of highest
    probability a draw over all fields (one id a field) gives: rank r of a
    field of size k has (r + 1)^-alpha / h(k), h the normaliser that
    `field_ids` draws by.  The ideal cache of n slots."""
    n = min(n, sum(sizes))
    if abs(alpha - 1.0) < 1e-9:
        h = [math.log(k + 1.0) for k in sizes]
    else:
        h = [((k + 1.0) ** (1.0 - alpha) - 1.0) / (1.0 - alpha) for k in sizes]

    def count(log_t):         # ids of probability at least e^log_t
        return [min(k, int(math.exp(-(log_t + math.log(hk)) / alpha)))
                for k, hk in zip(sizes, h)]

    lo, hi = -200.0, 50.0     # count(lo) takes all; count(hi) none
    for _ in range(200):
        mid = (lo + hi) / 2
        if sum(count(mid)) > n:
            lo = mid
        else:
            hi = mid
    c = count(hi)
    while sum(c) < n:         # the few ties that the threshold splits
        f = max((f for f in range(len(sizes)) if c[f] < sizes[f]),
                key=lambda f: ((c[f] + 1.0) ** -alpha / h[f], -f))
        c[f] += 1
    return c


def hottest_ids(sizes, counts, j: torch.Tensor) -> torch.Tensor:
    """The j-th of the hottest ids (`counts` from `hottest`), j < their sum,
    field by field; -1 stays -1."""
    dev = j.device
    ends = torch.tensor(offsets(counts) + [sum(counts)], dtype=torch.int64, device=dev)[1:]
    f = torch.searchsorted(ends, j.clamp(min=0), right=True)
    starts = torch.tensor(offsets(counts), dtype=torch.int64, device=dev)
    base = torch.tensor(offsets(sizes), dtype=torch.int64, device=dev)
    f = f.clamp(max=len(sizes) - 1)
    return torch.where(j < 0, -1, base[f] + j - starts[f])


def permute(x: torch.Tensor, bits: int, seed: int) -> torch.Tensor:
    """A seeded bijection of [0, 2^bits) (bits <= 31): rounds of an odd
    multiplier, a xor-shift and an added constant, each modulo 2^bits."""
    mask = (1 << bits) - 1
    for r in range(4):
        x = (x * ((seed_of(seed, "mul", r) & mask) | 1)) & mask
        x = x ^ (x >> (bits // 2 + 1))
        x = (x + (seed_of(seed, "add", r) & mask)) & mask
    return x


def shuffled(n: int, size: int, seed: int, device: torch.device):
    """0 .. n-1 in one seeded pseudo-random order, in batches of `size`
    padded with -1, without holding the whole order (values of the
    bijection over the next power of two that fall past n are skipped)."""
    bits = max(1, (n - 1).bit_length())
    for start in range(0, 1 << bits, size):
        j = permute(torch.arange(start, min(start + size, 1 << bits), device=device), bits, seed)
        j = j[j < n]
        yield torch.cat([j, j.new_full((size - j.numel(),), -1)])
