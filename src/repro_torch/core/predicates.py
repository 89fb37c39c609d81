"""SweepPredicate: the declarative predicate language of the maintenance
sweeps (``erase_if`` / ``evict_if``), as in the reference's
``core/predicates.py``.

A predicate is data, not a callable: a kind from a small closed set and
two unsigned 64-bit operands, held as int64 words with the same bits (the
port's key and score representation, ``core.u64``).  The same formula,
``match_planes``, runs in the plain PyTorch path; the CUDA sweep kernel
(``csrc/sweep_scan.cu``) evaluates the kind by its index in ``KINDS``.

Kinds (every compare unsigned):

  always     every live entry (evict_if's rank order and budget select)
  score_lt   score <  a
  score_ge   score >= a
  epoch_lt   score's high 32 bits < a's high 32 bits (under the epoch_*
             policies the high half is the entry's last-touch epoch)
  key_range  a <= key < b

Liveness is not part of the formula: callers AND it with their occupancy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import u64

KINDS = ("always", "score_lt", "score_ge", "epoch_lt", "key_range")


def _lt(x: torch.Tensor, a: int) -> torch.Tensor:
    """Unsigned x < a for int64 words."""
    return u64.flip(x) < u64.flip(torch.tensor(a, dtype=torch.int64, device=x.device))


def match_planes(kind: str, keys: torch.Tensor, scores: torch.Tensor,
                 a: int, b: int) -> torch.Tensor:
    """The predicate over the key and score planes (int64 words), bool of
    their shape.  `a`, `b`: the operands as int64 bit patterns."""
    if kind == "always":
        return torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    if kind == "score_lt":
        return _lt(scores, a)
    if kind == "score_ge":
        return ~_lt(scores, a)
    if kind == "epoch_lt":
        return u64.hi32(scores) < ((a >> 32) & u64.MASK32)
    if kind == "key_range":
        return ~_lt(keys, a) & _lt(keys, b)
    raise ValueError(f"unknown predicate kind {kind!r}; one of {KINDS}")


def to_word(x: Any) -> int:
    """An unsigned threshold -> its int64 bit pattern.  Python ints and
    numpy integers must be non-negative (taken modulo 2**64); a 64-bit
    tensor or array keeps its bits; a narrower tensor is zero-extended
    from 32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.reshape(())
        if x.dtype in (torch.int64, torch.uint64):
            return u64.to_signed(int(x.view(torch.int64)))
        return int(x.to(torch.int64)) & u64.MASK32
    if isinstance(x, np.ndarray) and x.dtype.itemsize == 8:
        return u64.to_signed(int(x.reshape(()).view(np.uint64)))
    v = int(x)
    if v < 0:
        raise ValueError(f"thresholds are unsigned; got {v}")
    return u64.to_signed(v)


@dataclasses.dataclass(frozen=True)
class SweepPredicate:
    """One sweep predicate: `kind` and two operands as int64 words (the
    unused ones are 0).  Build it with the named constructors."""

    kind: str
    a: int = 0
    b: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown predicate kind {self.kind!r}; one of {KINDS}")

    @property
    def kind_index(self) -> int:
        """The kind's number in the CUDA sweep kernel."""
        return KINDS.index(self.kind)

    @classmethod
    def always(cls) -> "SweepPredicate":
        """Match every live entry (rank order and budget do the selecting)."""
        return cls("always")

    @classmethod
    def score_below(cls, threshold: Any) -> "SweepPredicate":
        """score < threshold: the cold set."""
        return cls("score_lt", to_word(threshold))

    @classmethod
    def score_at_least(cls, threshold: Any) -> "SweepPredicate":
        """score >= threshold (the complement)."""
        return cls("score_ge", to_word(threshold))

    @classmethod
    def expire_before(cls, epoch: Any) -> "SweepPredicate":
        """TTL expiry: entries whose score's high 32 bits (the epoch stamp
        under epoch_lru / epoch_lfu) are below the uint32 `epoch`."""
        return cls("epoch_lt", u64.to_signed((int(epoch) & u64.MASK32) << 32))

    @classmethod
    def key_in_range(cls, lo: Any, hi: Any) -> "SweepPredicate":
        """lo <= key < hi: targeted invalidation of an id range."""
        return cls("key_range", to_word(lo), to_word(hi))

    def matches(self, keys: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """bool mask of the planes' shape; liveness NOT included."""
        return match_planes(self.kind, keys, scores, self.a, self.b)

    def __repr__(self):
        return f"SweepPredicate({self.kind})"
