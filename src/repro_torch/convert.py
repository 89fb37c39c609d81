"""Carry table state between the JAX package's layout and the port's.

The JAX package's ``HKVState`` holds 64-bit keys and scores as (hi, lo)
uint32 planes; the port holds each as one int64 plane with the same bits.
Both directions go through numpy arrays named as the JAX state's fields:

    key_hi, key_lo, digests, score_hi, score_lo, values,
    clock_hi, clock_lo, epoch

so a JAX ``HKVState`` (a NamedTuple of arrays) or a dict of numpy arrays
can be passed in directly, without this module importing JAX.  The value
plane is placed for the table's tier: ``value_tier='hmem'`` on the card puts
it in pinned host memory (``core.table.place_value_tier``).  A JAX
``TieredState`` (hot and cold states) comes across with
``tiered_state_from_arrays``.  A JAX sharded table's state (every array
leaf the shards' planes concatenated along the bucket axis in shard order,
the clocks and epoch replicated) splits into the port's per-shard states
with ``sharded_state_from_arrays`` and joins back with
``sharded_state_to_arrays``.

The op results that carry 64-bit words convert the same way, to dicts
named as the JAX result's fields: ``stream_to_arrays`` (an
``EvictionStream``), ``locate_to_arrays`` (a ``Locate``, int32 as in the
reference), ``export_to_arrays`` (an ``ExportResult``); and a JAX
``SweepPredicate`` (kind and four uint32 operands) comes across with
``predicate_from_arrays``.  The value plane is carried whole, aux
optimizer columns included (V = dim + aux), bit for bit in its own dtype:
a float32 or float16 plane as it is (numpy has both), and a bfloat16 one
through a ``uint16`` view on both sides (numpy has no bfloat16 of its own;
the JAX package's is ``ml_dtypes.bfloat16``, and torch reads no numpy array
of that dtype).
``ml_dtypes`` is imported only where a bfloat16 tensor goes out to numpy,
so the port needs it only on a machine that holds the JAX package too.

The dictionary baselines' states come across the same way:
``oa_state_from_arrays`` / ``p2c_state_from_arrays`` take a JAX ``OAState``
/ ``P2CState`` (``key_hi``, ``key_lo``, ``values``) and
``dict_state_to_arrays`` gives either back in that layout.

``dlrm_params_from_jax`` carries the reference DLRM's parameter dict
(``bottom1``, ``bottom2``, ``top1``, ``top2`` as numpy arrays) into a state
dict for the port's ``models.dlrm.DLRM``.

``lm_params_from_jax`` carries a reference ``CompositeLM`` parameter tree
(dicts and lists of numpy arrays, ``None`` for an empty slot, a segment's
leaves stacked [repeats, count, ...] as the reference stacks them) into
the port's tree of the same structure, and ``lm_params_to_numpy`` back;
``opt_state_from_jax`` carries the dense optimizers' states (whose trees
mirror the parameters', with an int32 step count) the same way.  A torch
generator cannot reproduce ``jax.random``, so parameters drawn by the
reference come across this way.  ``decode_state_from_jax`` and
``decode_state_to_numpy`` carry an LM decode state (``prefill``'s and
``decode_step``'s: caches and recurrent states stacked as the parameters
are, and the 0-dim int32 position) both ways.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import table as table_mod
from repro_torch.core import u64
from repro_torch.core.predicates import SweepPredicate
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


def values_from_numpy(a) -> torch.Tensor:
    """A numpy value plane or batch -> a CPU tensor of the same dtype and
    bits (an ``ml_dtypes.bfloat16`` array becomes ``torch.bfloat16``; float32
    and float16 cross as they are)."""
    a = np.array(a)   # a writable copy: a JAX array's numpy view is read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def values_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A value tensor -> numpy, bit for bit (``torch.bfloat16`` becomes
    ``ml_dtypes.bfloat16``, imported here only)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes

        return x.contiguous().view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def state_from_arrays(arrays: Any, device=None, value_tier: str = "hbm") -> HKVState:
    """A JAX-layout state (mapping or object with the FIELDS) -> HKVState
    on `device` (default: the card), its value plane placed for
    `value_tier`."""
    get = (lambda f: np.asarray(arrays[f])) if isinstance(arrays, Mapping) \
        else (lambda f: np.asarray(getattr(arrays, f)))
    device = table_mod.resolve_device(device)
    return HKVState(
        keys=_join(get("key_hi"), get("key_lo")).to(device),
        digests=torch.from_numpy(get("digests").astype(np.uint8)).to(device),
        scores=_join(get("score_hi"), get("score_lo")).to(device),
        values=table_mod.place_value_tier(values_from_numpy(get("values")), device, value_tier),
        clock=(int(get("clock_hi")) << 32) | int(get("clock_lo")),
        epoch=int(get("epoch")),
    )


def state_to_arrays(state: HKVState) -> dict[str, np.ndarray]:
    """HKVState -> a dict of numpy arrays in the JAX layout."""
    table_mod.host_sync(state.device)   # a kernel may still write a host plane
    key_hi, key_lo = _split(state.keys)
    score_hi, score_lo = _split(state.scores)
    return {
        "key_hi": key_hi, "key_lo": key_lo,
        "digests": state.digests.cpu().numpy(),
        "score_hi": score_hi, "score_lo": score_lo,
        "values": values_to_numpy(state.values),
        "clock_hi": np.uint32(state.clock >> 32),
        "clock_lo": np.uint32(state.clock & 0xFFFFFFFF),
        "epoch": np.uint32(state.epoch),
    }


def tiered_state_from_arrays(tiered: Any, device=None, hot_tier: str = "hbm",
                             cold_tier: str = "hmem"):
    """A JAX ``TieredState`` (``hot`` and ``cold`` JAX-layout states) ->
    the port's ``TieredState``, each tier's plane placed for its tier."""
    from repro_torch.core.tiered import TieredState

    get = (lambda f: tiered[f]) if isinstance(tiered, Mapping) else (lambda f: getattr(tiered, f))
    return TieredState(hot=state_from_arrays(get("hot"), device, hot_tier),
                       cold=state_from_arrays(get("cold"), device, cold_tier))


def tiered_state_to_arrays(state) -> dict[str, dict[str, np.ndarray]]:
    """The port's ``TieredState`` -> {"hot": ..., "cold": ...} in the JAX layout."""
    return {"hot": state_to_arrays(state.hot), "cold": state_to_arrays(state.cold)}


def _split_leaves(arrays: Any, n_shards: int) -> list:
    """A JAX-layout state with concatenated planes -> n_shards dicts, each
    shard's planes and the replicated scalars."""
    get = _get(arrays)
    out = [{} for _ in range(n_shards)]
    for f in FIELDS:
        a = get(f)
        parts = np.split(a, n_shards) if a.ndim else [a] * n_shards
        for d, part in zip(out, parts):
            d[f] = part
    return out


def sharded_state_from_arrays(arrays: Any, devices, value_tier: str = "hbm",
                              cold_tier: str = "hmem") -> tuple:
    """A JAX ``ShardedHKVTable``'s state -> the port's per-shard states,
    shard i on ``devices[i]`` (one device a shard, in shard order).  A
    tiered state (``hot`` and ``cold``) splits tier by tier: the hot planes
    placed for `value_tier`, the cold ones for `cold_tier`."""
    from repro_torch.core.tiered import TieredState

    n = len(devices)
    if _has(arrays, "hot"):
        part = (lambda f: arrays[f]) if isinstance(arrays, Mapping) else \
            (lambda f: getattr(arrays, f))
        hot, cold = _split_leaves(part("hot"), n), _split_leaves(part("cold"), n)
        return tuple(TieredState(hot=state_from_arrays(h, d, value_tier),
                                 cold=state_from_arrays(c, d, cold_tier))
                     for h, c, d in zip(hot, cold, devices))
    return tuple(state_from_arrays(a, d, value_tier)
                 for a, d in zip(_split_leaves(arrays, n), devices))


def sharded_state_to_arrays(states) -> dict:
    """The port's per-shard states -> one JAX-layout state, the planes
    concatenated in shard order (tiered: {"hot": ..., "cold": ...}).  The
    shards' clocks and epochs must agree: they advance in lockstep."""
    from repro_torch.core.tiered import TieredState

    states = list(states)
    if isinstance(states[0], TieredState):
        return {"hot": sharded_state_to_arrays([s.hot for s in states]),
                "cold": sharded_state_to_arrays([s.cold for s in states])}
    per = [state_to_arrays(s) for s in states]
    for f in ("clock_hi", "clock_lo", "epoch"):
        if len({int(p[f]) for p in per}) != 1:
            raise ValueError(f"the shards' {f} disagree: {[int(p[f]) for p in per]}")
    return {f: (np.concatenate([p[f] for p in per]) if per[0][f].ndim else per[0][f])
            for f in FIELDS}


def _has(arrays: Any, f: str) -> bool:
    return f in arrays if isinstance(arrays, Mapping) else hasattr(arrays, f)


def _words(prefix: str, x: torch.Tensor) -> dict[str, np.ndarray]:
    hi, lo = _split(x)
    return {f"{prefix}_hi": hi, f"{prefix}_lo": lo}


def stream_to_arrays(stream) -> dict[str, np.ndarray]:
    """EvictionStream -> the JAX EvictionStream's fields as numpy."""
    return {**_words("key", stream.keys), "values": values_to_numpy(stream.values),
            **_words("score", stream.scores), "mask": stream.mask.cpu().numpy()}


def locate_to_arrays(loc) -> dict[str, np.ndarray]:
    """find.Locate -> the JAX Locate's fields (int32 indices) as numpy."""
    return {"found": loc.found.cpu().numpy(),
            **{f: getattr(loc, f).cpu().numpy().astype(np.int32)
               for f in ("bucket", "slot", "row")}}


def export_to_arrays(res) -> dict[str, np.ndarray]:
    """ops.ExportResult -> the JAX ExportResult's fields as numpy."""
    return {**_words("key", res.keys), "values": values_to_numpy(res.values),
            **_words("score", res.scores), "mask": res.mask.cpu().numpy()}


def predicate_from_arrays(pred: Any) -> SweepPredicate:
    """A JAX-layout predicate (kind, a_hi, a_lo, b_hi, b_lo) -> the
    port's SweepPredicate with the same operand bits."""
    word = lambda hi, lo: u64.to_signed((int(np.asarray(getattr(pred, hi))) << 32)
                                        | int(np.asarray(getattr(pred, lo))))
    return SweepPredicate(pred.kind, word("a_hi", "a_lo"), word("b_hi", "b_lo"))


def _get(arrays: Any):
    return (lambda f: np.asarray(arrays[f])) if isinstance(arrays, Mapping) \
        else (lambda f: np.asarray(getattr(arrays, f)))


def oa_state_from_arrays(arrays: Any, device=None):
    """A JAX-layout open-addressing state (``key_hi``, ``key_lo`` [C],
    ``values`` [C, D]) -> the port's ``OAState`` on `device` (default: the
    card)."""
    from repro_torch.baselines.dict_tables import OAState

    get, device = _get(arrays), table_mod.resolve_device(device)
    return OAState(keys=_join(get("key_hi"), get("key_lo")).to(device),
                   values=torch.from_numpy(np.array(get("values"))).to(device))


def p2c_state_from_arrays(arrays: Any, device=None):
    """A JAX-layout P2C state (``key_hi``, ``key_lo`` [B, S], ``values``
    [B*S, D]) -> the port's ``P2CState`` on `device` (default: the card)."""
    from repro_torch.baselines.dict_tables import P2CState

    get, device = _get(arrays), table_mod.resolve_device(device)
    return P2CState(keys=_join(get("key_hi"), get("key_lo")).to(device),
                    values=torch.from_numpy(np.array(get("values"))).to(device))


def dict_state_to_arrays(state) -> dict[str, np.ndarray]:
    """The port's ``OAState`` or ``P2CState`` -> the JAX layout as numpy."""
    key_hi, key_lo = _split(state.keys)
    return {"key_hi": key_hi, "key_lo": key_lo, "values": state.values.cpu().numpy()}


DLRM_PARAMS = ("bottom1", "bottom2", "top1", "top2")


def dlrm_params_from_jax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """The reference DLRM's parameters (numpy arrays, [fan_in, fan_out] as
    the port's) -> a state dict for ``DLRM.load_state_dict``."""
    return {k: torch.from_numpy(np.array(params_np[k], dtype=np.float32)) for k in DLRM_PARAMS}


def _tree_from_numpy(arrays: Any, device=None) -> Any:
    device = table_mod.resolve_device(device)
    return tree.map(lambda a: values_from_numpy(a).to(device), arrays)


def lm_params_from_jax(params_np: Any, device=None) -> Any:
    """A reference LM parameter tree (numpy leaves) -> the port's, each leaf
    a tensor of the same dtype and bits on `device` (default: the card)."""
    return _tree_from_numpy(params_np, device)


def lm_params_to_numpy(params: Any) -> Any:
    """The port's LM parameter tree -> numpy leaves, the same structure."""
    return tree.map(values_to_numpy, params)


def opt_state_from_jax(state_np: Any, device=None) -> Any:
    """A reference dense optimizer's state (numpy leaves: moments, int8
    blocks and scales, factored moments, the int32 count) -> the port's."""
    return _tree_from_numpy(state_np, device)


def decode_state_from_jax(state_np: Any, device=None) -> Any:
    """A reference LM decode state (numpy leaves: caches, recurrent states,
    the 0-dim int32 position) -> the port's, the same tree and bits, on
    `device` (default: the card)."""
    return _tree_from_numpy(state_np, device)


def decode_state_to_numpy(state: Any) -> Any:
    """The port's LM decode state -> numpy leaves, the same structure."""
    return tree.map(values_to_numpy, state)
