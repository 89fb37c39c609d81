"""The five score policies (paper §3.3, Table 8) on bit-cast int64 scores.

A policy is a rule for the score of a newly admitted key and for the score
transition when an existing key is touched.  Scores are unsigned 64-bit
values held as int64 bits (``core.u64``); the clock is the table's
unsigned 64-bit batch clock and the epoch a uint32, both Python ints.

Two wrap rules follow the reference exactly:
  * ``lfu`` adds the batch count with a carry from the low into the high
    half, i.e. plain addition modulo 2**64 (int64 addition wraps so);
  * ``epoch_lfu`` adds the count to the low half modulo 2**32 with NO
    carry, and resets the counter when the epoch changes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import u64

POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")


@dataclasses.dataclass(frozen=True)
class ScorePolicy:
    name: str

    def __post_init__(self):
        if self.name not in POLICIES:
            raise ValueError(f"unknown score policy {self.name!r}; one of {POLICIES}")

    @property
    def is_custom(self) -> bool:
        return self.name == "custom"

    @property
    def counts_frequency(self) -> bool:
        return self.name in ("lfu", "epoch_lfu")

    def _need_custom(self, custom):
        if custom is None:
            raise ValueError("policy 'custom' requires caller-supplied scores")
        return custom

    def init_score(self, clock: int, epoch: int, count: torch.Tensor,
                   custom: Optional[torch.Tensor]) -> torch.Tensor:
        """Score of a newly admitted key.  count: int64 [N] occurrences of
        the key in this batch; custom: int64 [N] caller scores."""
        if self.name == "lru":
            return torch.full_like(count, u64.to_signed(clock))
        if self.name == "lfu":
            return count.clone()
        if self.name == "epoch_lru":
            return torch.full_like(count, u64.to_signed((epoch << 32) | (clock & u64.MASK32)))
        if self.name == "epoch_lfu":
            return (count & u64.MASK32) | u64.to_signed(epoch << 32)
        return self._need_custom(custom)

    def update_score(self, old: torch.Tensor, clock: int, epoch: int,
                     count: torch.Tensor,
                     custom: Optional[torch.Tensor]) -> torch.Tensor:
        """Score transition when an existing key is touched."""
        if self.name in ("lru", "epoch_lru"):
            return self.init_score(clock, epoch, count, custom)
        if self.name == "lfu":
            return old + count
        if self.name == "epoch_lfu":
            fresh = u64.hi32(old) != epoch
            new_lo = torch.where(fresh, count, u64.lo32(old) + count) & u64.MASK32
            return new_lo | u64.to_signed(epoch << 32)
        return self._need_custom(custom)


def get_policy(name: str) -> ScorePolicy:
    return ScorePolicy(name)
