"""HKV table configuration and state (paper §3.1-§3.2, Fig. 4).

Structure of arrays, as in the reference, with 64-bit words bit-cast to
int64 (``core.u64``):

  digests : uint8   [B, S]      one 128-byte row per bucket
  keys    : int64   [B, S]      EMPTY (-1) marks a free slot
  scores  : int64   [B, S]      unsigned 64-bit scores
  values  : vdtype  [B*S, D]    position addressing: slot (b, s) owns row
                                b*S + s (paper §3.6)
  clock   : int                 unsigned 64-bit batch clock
  epoch   : int                 uint32 application epoch

State is updated IN PLACE by the ops: the reference's functional updates
would copy the value plane on every op, and at the paper's config B that
plane alone is 2**27 x 32 x 4 B = 16 GiB.  ``HKVState.clone`` is the
explicit copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import u64
from repro_torch.core.scores import ScorePolicy, get_policy

SLOTS_PER_BUCKET = 128


@dataclasses.dataclass(frozen=True)
class HKVConfig:
    """Static configuration of an HKV table."""

    capacity: int                      # total slots (B * S)
    dim: int                           # value vector length
    slots_per_bucket: int = SLOTS_PER_BUCKET
    buckets_per_key: int = 1           # 1 = single-bucket, 2 = dual-bucket (§3.4)
    score_policy: str = "lru"
    value_dtype: torch.dtype = torch.float32
    value_tier: str = "hbm"
    aux_value_dim: int = 0             # optimizer-state columns after `dim`
    use_digest: bool = True            # False = Exp#3a "no digest" ablation

    def __post_init__(self):
        if self.capacity % self.slots_per_bucket != 0:
            raise ValueError(
                f"capacity {self.capacity} must be a multiple of "
                f"slots_per_bucket {self.slots_per_bucket}")
        if self.buckets_per_key not in (1, 2):
            raise ValueError("buckets_per_key must be 1 or 2")
        if self.value_tier not in ("hbm", "hmem"):
            raise ValueError("value_tier must be 'hbm' or 'hmem'")
        if self.num_buckets < 1:
            raise ValueError("capacity must hold at least one bucket")
        get_policy(self.score_policy)

    @property
    def num_buckets(self) -> int:
        return self.capacity // self.slots_per_bucket

    @property
    def total_value_dim(self) -> int:
        return self.dim + self.aux_value_dim

    @property
    def policy(self) -> ScorePolicy:
        return get_policy(self.score_policy)


@dataclasses.dataclass
class HKVState:
    """The table's planes; mutated in place by the ops."""

    keys: torch.Tensor
    digests: torch.Tensor
    scores: torch.Tensor
    values: torch.Tensor
    clock: int = 0
    epoch: int = 0

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def slots_per_bucket(self) -> int:
        return self.keys.shape[1]

    def occupied_mask(self) -> torch.Tensor:
        return ~u64.empty_lanes(self.keys)

    def clone(self) -> "HKVState":
        return HKVState(self.keys.clone(), self.digests.clone(),
                        self.scores.clone(), self.values.clone(),
                        self.clock, self.epoch)


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the card.  Without one this raises: the port runs on
    the GPU unless the caller asks for the CPU explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def create(config: HKVConfig, device: Optional[torch.device | str] = None) -> HKVState:
    """Allocate an empty table on `device` (default: the card)."""
    if config.value_tier == "hmem":
        raise NotImplementedError(
            "value_tier='hmem' (host-memory value plane) is not ported yet")
    device = resolve_device(device)
    b, s = config.num_buckets, config.slots_per_bucket
    return HKVState(
        keys=torch.full((b, s), u64.EMPTY, dtype=torch.int64, device=device),
        digests=torch.full((b, s), u64.EMPTY_DIGEST, dtype=torch.uint8, device=device),
        scores=torch.zeros((b, s), dtype=torch.int64, device=device),
        values=torch.zeros((b * s, config.total_value_dim),
                           dtype=config.value_dtype, device=device),
    )


def advance_clock(state: HKVState) -> None:
    """Tick the batch clock (one tick per batched op), modulo 2**64."""
    state.clock = (state.clock + 1) & 0xFFFFFFFFFFFFFFFF


def set_epoch(state: HKVState, epoch: int) -> None:
    state.epoch = int(epoch) & u64.MASK32
