"""64-bit keys and scores as bit-cast ``int64`` tensors, and the key hash.

The JAX package carries every 64-bit quantity as a (hi, lo) pair of uint32
planes because TPU lanes are 32-bit.  Here one ``int64`` tensor holds the
same 64 bits: torch's unsigned 32/64-bit dtypes lack shifts, ordering and
``index_put`` on the CPU build, and one 8-byte word is what a CUDA kernel
wants to load anyway.

Unsigned order.  For bit-cast values ``a``, ``b``: ``a <u b`` iff
``flip(a) < flip(b)`` in signed order, where ``flip`` toggles the sign bit.
Every ordering decision (score minimum, victim order, key sort) goes
through :func:`flip`, so the port keeps the reference's unsigned-uint64
total order exactly.

The hash is the reference's Murmur3 fmix32 pair (two coupled finalizer
passes: h1 drives the primary bucket and the 8-bit digest, h2 the secondary
bucket).  It runs in ``int64`` arithmetic masked to 32 bits: a product of
two values below 2**32 may wrap the ``int64`` range, but wrapping is modulo
2**64, so the low 32 bits kept by the mask are exact.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SIGN = -(2**63)             # the sign bit as an int64 scalar

# The all-ones key marks an empty slot; as an int64 it is -1.
EMPTY = -1
EMPTY_DIGEST = 0xFF
U64_MAX = EMPTY             # the all-ones score: +inf in unsigned order

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_SALT2 = 0x7FEB352D


# ---------------------------------------------------------------------------
# Bit-level conversions
# ---------------------------------------------------------------------------

def to_signed(x: int) -> int:
    """A Python int taken as unsigned 64-bit -> its int64 bit pattern."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - 2**64 if x >= 2**63 else x


def hi32(x: torch.Tensor) -> torch.Tensor:
    """High 32 bits of int64 words, as non-negative int64."""
    return (x >> 32) & MASK32


def lo32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 words, as non-negative int64."""
    return x & MASK32


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) 32-bit halves held in int64 -> one int64 word."""
    return (hi << 32) | (lo & MASK32)


def from_numpy_u64(arr: np.ndarray) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint64).view(np.int64))


# ---------------------------------------------------------------------------
# Unsigned order
# ---------------------------------------------------------------------------

def flip(x: torch.Tensor) -> torch.Tensor:
    """Map unsigned order onto signed order (toggle the sign bit)."""
    return torch.bitwise_xor(x, SIGN)


def gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) > flip(b)


def empty_lanes(keys: torch.Tensor) -> torch.Tensor:
    """The one liveness formula: the slot holds the EMPTY sentinel."""
    return keys == EMPTY


# ---------------------------------------------------------------------------
# Hash: Murmur3 fmix32-derived pair
# ---------------------------------------------------------------------------

def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer on non-negative int64 holding 32 bits."""
    h = h ^ (h >> 16)
    h = (h * _C1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2) & MASK32
    return h ^ (h >> 16)


def hash_pair(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two decorrelated 32-bit hashes (as int64) of int64 keys."""
    hi, lo = hi32(keys), lo32(keys)
    a = fmix32(hi ^ _GOLDEN)
    b = fmix32(lo ^ _SALT2)
    h1 = fmix32(a ^ lo)
    h2 = fmix32(b ^ hi ^ _GOLDEN)
    return h1, h2


def digest_from_hash(h1: torch.Tensor) -> torch.Tensor:
    """8-bit digest from bits [31:24] of h1."""
    return ((h1 >> 24) & 0xFF).to(torch.uint8)


def bucket_from_hash(h: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Bucket index (int64): a mask for power-of-two counts, else modulo."""
    if num_buckets & (num_buckets - 1) == 0:
        return h & (num_buckets - 1)
    return h % num_buckets


# ---------------------------------------------------------------------------
# The same hash on numpy uint64 (host code: the sequential oracle)
# ---------------------------------------------------------------------------

EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """Murmur3 32-bit finalizer on numpy uint32."""
    h = np.asarray(h, np.uint32).astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(_C1)) & np.uint64(MASK32)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(_C2)) & np.uint64(MASK32)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def hash_pair_np(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`hash_pair` on numpy uint64 keys: (h1, h2) as uint32."""
    keys = np.asarray(keys, np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(MASK32)).astype(np.uint32)
    a = fmix32_np(hi ^ np.uint32(_GOLDEN))
    b = fmix32_np(lo ^ np.uint32(_SALT2))
    h1 = fmix32_np(a ^ lo)
    h2 = fmix32_np(b ^ hi ^ np.uint32(_GOLDEN))
    return h1, h2
