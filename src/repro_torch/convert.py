"""Carry table state between the JAX package's layout and the port's.

The JAX package's ``HKVState`` holds 64-bit keys and scores as (hi, lo)
uint32 planes; the port holds each as one int64 plane with the same bits.
Both directions go through numpy arrays named as the JAX state's fields:

    key_hi, key_lo, digests, score_hi, score_lo, values,
    clock_hi, clock_lo, epoch

so a JAX ``HKVState`` (a NamedTuple of arrays) or a dict of numpy arrays
can be passed in directly, without this module importing JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.core import table as table_mod
from repro_torch.core.table import HKVState

FIELDS = ("key_hi", "key_lo", "digests", "score_hi", "score_lo", "values",
          "clock_hi", "clock_lo", "epoch")


def _join(hi, lo) -> torch.Tensor:
    words = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64))


def _split(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    words = x.detach().cpu().numpy().view(np.uint64)
    return ((words >> np.uint64(32)).astype(np.uint32),
            (words & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def state_from_arrays(arrays: Any, device=None) -> HKVState:
    """A JAX-layout state (mapping or object with the FIELDS) -> HKVState
    on `device` (default: the card)."""
    get = (lambda f: np.asarray(arrays[f])) if isinstance(arrays, Mapping) \
        else (lambda f: np.asarray(getattr(arrays, f)))
    device = table_mod.resolve_device(device)
    return HKVState(
        keys=_join(get("key_hi"), get("key_lo")).to(device),
        digests=torch.from_numpy(get("digests").astype(np.uint8)).to(device),
        scores=_join(get("score_hi"), get("score_lo")).to(device),
        values=torch.from_numpy(np.array(get("values"))).to(device),
        clock=(int(get("clock_hi")) << 32) | int(get("clock_lo")),
        epoch=int(get("epoch")),
    )


def state_to_arrays(state: HKVState) -> dict[str, np.ndarray]:
    """HKVState -> a dict of numpy arrays in the JAX layout."""
    key_hi, key_lo = _split(state.keys)
    score_hi, score_lo = _split(state.scores)
    return {
        "key_hi": key_hi, "key_lo": key_lo,
        "digests": state.digests.cpu().numpy(),
        "score_hi": score_hi, "score_lo": score_lo,
        "values": state.values.detach().cpu().numpy(),
        "clock_hi": np.uint32(state.clock >> 32),
        "clock_lo": np.uint32(state.clock & 0xFFFFFFFF),
        "epoch": np.uint32(state.epoch),
    }
