"""HKV op engine (paper §4.1): the ops of this slice over an in-place state.

``backend`` picks the implementation of the heavy stages:
  'auto'    the CUDA kernels when the state lies on the card, else 'plain';
  'plain'   the plain PyTorch reference, on any device.

``HKVTable`` in ``core.api`` is the public surface; these free functions
are the implementation it delegates to.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core.merge import (  # noqa: F401  (re-exported status codes)
    STATUS_EVICTED,
    STATUS_INSERTED,
    STATUS_INVALID,
    STATUS_REJECTED,
    STATUS_UPDATED,
)
from repro_torch.core.table import HKVConfig, HKVState


class FindResult(NamedTuple):
    values: torch.Tensor     # [N, dim] (zeros where not found)
    found: torch.Tensor      # bool [N]
    scores: torch.Tensor     # int64 [N] unsigned scores (0 where not found)


class UpsertResult(NamedTuple):
    state: HKVState
    status: torch.Tensor     # int8 [N]: 0 invalid / 1 updated / 2 inserted / 3 evicted / 4 rejected


def uses_kernels(backend: str, device: torch.device) -> bool:
    """Whether `backend` runs the CUDA kernels for state on `device`."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}; one of 'auto'|'plain'")
    return backend == "auto" and device.type == "cuda"


def find(state: HKVState, cfg: HKVConfig, keys: torch.Tensor, *,
         backend: str = "auto") -> FindResult:
    """Reader.  Digest-filtered lookup with value copy (paper `find`); on
    the card one fused find_scan launch does match, score readout and
    value copy."""
    if uses_kernels(backend, state.device):
        from repro_torch.kernels import ops as kernel_ops  # kernels import core

        r = kernel_ops.find_fused_kernel(state, cfg, keys)
        return FindResult(values=r.values[:, :cfg.dim], found=r.found, scores=r.scores)
    loc = find_mod.locate(state, cfg, keys)
    vals = find_mod.gather_values(state, loc, cfg.dim)
    scores = torch.where(loc.found, state.scores[loc.bucket, loc.slot], 0)
    return FindResult(values=vals, found=loc.found, scores=scores)


def insert_or_assign(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                     values: torch.Tensor,
                     custom_scores: Optional[torch.Tensor] = None, *,
                     backend: str = "auto") -> UpsertResult:
    """Inserter.  Update-or-insert with in-line eviction and admission
    (paper Alg. 2/3), in place."""
    stages = None
    if uses_kernels(backend, state.device):
        from repro_torch.kernels import ops as kernel_ops

        stages = kernel_ops.kernel_stages(cfg, state.device)
    status = merge_mod.upsert(state, cfg, keys, _pad_aux(values, state),
                              custom_scores=custom_scores, stages=stages)
    return UpsertResult(state=state, status=status)


def size(state: HKVState) -> int:
    """Reader.  Number of live entries."""
    return int(state.occupied_mask().sum())


def load_factor(state: HKVState) -> float:
    return size(state) / state.keys.numel()


def _pad_aux(values: torch.Tensor, state: HKVState) -> torch.Tensor:
    """Zero-pad caller rows to the plane's width (aux optimizer columns)."""
    values = values.to(state.values.dtype)
    vdim = state.values.shape[1]
    if values.shape[1] == vdim:
        return values
    pad = values.new_zeros((values.shape[0], vdim - values.shape[1]))
    return torch.cat([values, pad], dim=1)
