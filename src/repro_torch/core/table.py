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

Tiered key-value separation (§3.6): with ``value_tier='hmem'`` on the card
the value plane lives in pinned host memory mapped into the card's address
space, while keys, digests and scores stay in HBM (the paper's HBM+HMEM
config D).  The kernels read and write its rows over the host link
(``kernels._build.check_plane``), so only touched rows cross; the plain
paths cross through ``tier_gather`` / ``tier_scatter``, which send the
row indices to the host and move only the rows.  On the CPU the plane is
an ordinary CPU tensor, as the reference's CPU container keeps it in place.
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

    def bytes_per_entry(self) -> int:
        # key 8 B + digest 1 B + score 8 B (paper §5.1: 17 B metadata) + value
        return 17 + self.total_value_dim * self.value_dtype.itemsize


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
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def slots_per_bucket(self) -> int:
        return self.keys.shape[1]

    @property
    def planes(self) -> tuple:
        """The four planes: keys, digests, scores, values."""
        return self.keys, self.digests, self.scores, self.values

    def occupied_mask(self) -> torch.Tensor:
        return ~u64.empty_lanes(self.keys)

    def load_factor(self) -> torch.Tensor:
        """float32 []: live slots over all slots."""
        return self.occupied_mask().sum().to(torch.float32) / float(self.keys.numel())

    def bucket_occupancy(self) -> torch.Tensor:
        """int32 [B]: live entries per bucket."""
        return self.occupied_mask().sum(dim=1, dtype=torch.int32)

    @property
    def host_values(self) -> bool:
        """The value plane is the 'hmem' tier: host memory beside key
        planes on the card."""
        return self.values.device.type == "cpu" and self.keys.device.type != "cpu"

    def clone(self) -> "HKVState":
        """A copy of every plane; an 'hmem' plane gets a new pinned plane."""
        if self.host_values:
            host_sync(self.device)
            values = _pinned_empty(self.values.shape, self.values.dtype).copy_(self.values)
        else:
            values = self.values.clone()
        return HKVState(self.keys.clone(), self.digests.clone(),
                        self.scores.clone(), values, self.clock, self.epoch)

    def copy_from(self, src: "HKVState") -> "HKVState":
        """Overwrite every plane, the clock and the epoch with `src`'s, in
        place (planes of equal shapes, dtypes and placement).  The card
        copies in stream order, after the kernels queued before; a host
        plane is copied once the card has run them."""
        if self.host_values or src.host_values:
            host_sync(self.device)
        for dst_plane, src_plane in zip(self.planes, src.planes):
            dst_plane.copy_(src_plane)
        self.clock, self.epoch = src.clock, src.epoch
        return self


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
    """Allocate an empty table on `device` (default: the card); an 'hmem'
    value plane on the card goes to pinned host memory."""
    device = resolve_device(device)
    b, s = config.num_buckets, config.slots_per_bucket
    shape = (b * s, config.total_value_dim)
    if config.value_tier == "hmem" and device.type == "cuda":
        values = _pinned_empty(shape, config.value_dtype).zero_()
    else:
        values = torch.zeros(shape, dtype=config.value_dtype, device=device)
    return HKVState(
        keys=torch.full((b, s), u64.EMPTY, dtype=torch.int64, device=device),
        digests=torch.full((b, s), u64.EMPTY_DIGEST, dtype=torch.uint8, device=device),
        scores=torch.zeros((b, s), dtype=torch.int64, device=device),
        values=values,
    )


def _pinned_empty(shape, dtype) -> torch.Tensor:
    from repro_torch.kernels import _build  # the kernels' library allocates it

    return _build.pinned_empty(shape, dtype)


def place_value_tier(values: torch.Tensor, device: torch.device, tier: str) -> torch.Tensor:
    """A value plane placed for `tier` beside key planes on `device`: an
    'hmem' plane beside the card's key planes is copied into pinned host
    memory; any other plane goes to `device`."""
    if tier == "hmem" and device.type == "cuda":
        return _pinned_empty(values.shape, values.dtype).copy_(values)
    return values.to(device)


# ---------------------------------------------------------------------------
# Tier crossings (§3.6) for the plain paths.  On the 'hmem' tier of a table
# on the card, a gather sends its row indices to the host, gathers there and
# moves only the gathered rows to the card; a scatter sends indices and
# rows to the host.  Host code touches the plane only after the card has
# run every kernel queued before it (a kernel may still read or write the
# plane over the host link).  Otherwise (the 'hbm' tier, or every plane on
# the CPU) they are plain indexing.  Rows lie within the plane.
# ---------------------------------------------------------------------------


def host_sync(device: torch.device) -> None:
    """Wait until the card has run the work queued on its stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _crosses(tier: str, values: torch.Tensor, other: torch.Tensor) -> bool:
    return tier == "hmem" and values.device != other.device


def tier_gather(tier: str, values: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """values[rows], on the device of `rows`."""
    if not _crosses(tier, values, rows):
        return values[rows]
    host_sync(rows.device)
    return values[rows.cpu()].to(rows.device)


def tier_scatter(tier: str, values: torch.Tensor, rows: torch.Tensor, updates,
                 *, add: bool = False) -> None:
    """values[rows] = updates in place (a tensor of rows, or a scalar); with
    `add`, values[rows] += updates, duplicates accumulating."""
    if _crosses(tier, values, rows):
        host_sync(rows.device)
        rows = rows.cpu()
        if isinstance(updates, torch.Tensor):
            updates = updates.cpu()
    if add:
        values.index_put_((rows,), updates, accumulate=True)
    else:
        values[rows] = updates


def tier_mask_rows(tier: str, values: torch.Tensor, keep: torch.Tensor) -> None:
    """Zero every value row where ~keep [B*S], in place; on the 'hmem' tier
    only the mask crosses to the host."""
    if _crosses(tier, values, keep):
        host_sync(keep.device)
        keep = keep.cpu()
    values.masked_fill_(~keep[:, None], 0)


def tier_zero(tier: str, values: torch.Tensor, device: torch.device) -> None:
    """Zero the whole plane of a table on `device`, in place."""
    if tier == "hmem" and values.device != device:
        host_sync(device)
    values.zero_()


def value_row_index(bucket: torch.Tensor, slot: torch.Tensor, slots_per_bucket: int) -> torch.Tensor:
    """Position-based addressing (§3.6): value row = bucket * S + slot."""
    return bucket * slots_per_bucket + slot


def advance_clock(state: HKVState) -> None:
    """Tick the batch clock (one tick per batched op), modulo 2**64."""
    state.clock = (state.clock + 1) & 0xFFFFFFFFFFFFFFFF


def set_epoch(state: HKVState, epoch: int) -> None:
    state.epoch = int(epoch) & u64.MASK32
