"""Checkpointing: atomic, async, restorable onto any device (port of
``repro/train/checkpoint.py``).

Layout, the reference's: ``<dir>/step_<N>/`` holds one ``leaf_<i>.npy``
per leaf of the saved tree and a ``manifest.json`` (the step, the tree's
structure, the leaf count and the caller's `extra`, such as the data
cursor).  Leaves follow the JAX package's pytree order
(``repro_torch.tree``).  A table handle inside the tree stands for its
state's arrays in the JAX layout, in ``HKVState`` field order
(``convert.state_to_arrays``): an ``HKVTable`` gives 9 leaves, a
``TieredHKVTable`` its hot tier's 9 then its cold tier's 9, and a
``ShardedHKVTable`` the 9 (or 18) arrays of its shards' planes joined in
shard order (``convert.sharded_state_to_arrays``), as the reference's
sharded state holds them.  So a table checkpoint written by either package
restores in the other.

Writes go to a ``.tmp`` directory that one ``os.rename`` publishes: a
crashed writer never corrupts the latest checkpoint, and every shard and
tier of a table lands behind the same rename.  `save_async` copies every
leaf off the card into pinned host memory (one synchronize for the whole
tree), then writes on a thread.  `restore` puts each leaf on the device of
the target tree's leaf, and each table's planes where the target's are.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import convert, tree
from repro_torch.core.api import HKVTable
from repro_torch.core.table import HKVState
from repro_torch.core.tiered import TieredHKVTable, TieredState
from repro_torch.distributed.table_sharding import ShardedHKVTable

_TABLES = (HKVTable, TieredHKVTable, ShardedHKVTable)


def _is_table(x) -> bool:
    return isinstance(x, _TABLES)


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


# ---------------------------------------------------------------------------
# Leaves: tensors and table states -> host arrays, and back
# ---------------------------------------------------------------------------


def _field_list(arrays: dict) -> list:
    return [arrays[f] for f in convert.FIELDS]


def _table_leaves(table, host) -> list:
    """A table's state as JAX-layout arrays in pytree order, its planes
    taken through `host` (a tensor -> its host copy)."""
    def flat(st: HKVState) -> HKVState:
        return HKVState(*(host(p) for p in st.planes), clock=st.clock, epoch=st.epoch)

    def tiered(st):
        return TieredState(flat(st.hot), flat(st.cold)) if isinstance(st, TieredState) \
            else flat(st)

    if isinstance(table, ShardedHKVTable):
        states = [tiered(s) for s in table.state]
        return lambda: _joined(convert.sharded_state_to_arrays(states))
    st = tiered(table.state)
    if isinstance(st, TieredState):
        return lambda: (_field_list(convert.state_to_arrays(st.hot))
                        + _field_list(convert.state_to_arrays(st.cold)))
    return lambda: _field_list(convert.state_to_arrays(st))


def _joined(arrays: dict) -> list:
    if "hot" in arrays:
        return _field_list(arrays["hot"]) + _field_list(arrays["cold"])
    return _field_list(arrays)


def _host_copy(t: torch.Tensor, late: list) -> torch.Tensor:
    """A host copy of `t` that no later op on the card can change: a card
    tensor is copied into pinned memory in stream order; a host tensor (a
    CPU tensor, or an 'hmem' plane a kernel may still write) is copied after
    the synchronize, through `late`."""
    if t.device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out
    out = torch.empty_like(t)
    late.append((out, t))
    return out


def _host_leaves(target: Any) -> list:
    """Every leaf of `target` as a numpy array, tables expanded into their
    state's arrays; one synchronize of the card for the whole tree."""
    late: list = []
    host = lambda t: _host_copy(t.detach(), late)  # noqa: E731
    parts = []
    for leaf in tree.leaves(target, is_leaf=_is_table):
        if _is_table(leaf):
            parts.append(_table_leaves(leaf, host))
        elif isinstance(leaf, torch.Tensor):
            parts.append(host(leaf))
        else:
            parts.append(np.asarray(leaf))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for out, src in late:
        out.copy_(src)
    arrays = []
    for p in parts:
        if callable(p):
            arrays.extend(p())
        elif isinstance(p, torch.Tensor):
            arrays.append(convert.values_to_numpy(p))
        else:
            arrays.append(p)
    return arrays


def _treedef(target: Any) -> str:
    kind = lambda x: type(x).__name__ if _is_table(x) else "*"  # noqa: E731
    return str(tree.map(kind, target, is_leaf=_is_table))


def _num_leaves(leaf) -> int:
    if not _is_table(leaf):
        return 1
    st = leaf.state[0] if isinstance(leaf, ShardedHKVTable) else leaf.state
    return 2 * len(convert.FIELDS) if isinstance(st, TieredState) else len(convert.FIELDS)


def _restore_table(table, arrays: list):
    """`table`'s handle on a new state made from its JAX-layout arrays,
    placed where `table`'s planes are."""
    n = len(convert.FIELDS)
    tiered = len(arrays) == 2 * n
    named = lambda a: dict(zip(convert.FIELDS, a))  # noqa: E731
    arrays = {"hot": named(arrays[:n]), "cold": named(arrays[n:])} if tiered else named(arrays)
    if isinstance(table, ShardedHKVTable):
        local = table.local
        devices = [s.hot.device if isinstance(s, TieredState) else s.device
                   for s in table.state]
        cold_tier = local.cold_config().value_tier if local.is_tiered else "hmem"
        return table.with_state(convert.sharded_state_from_arrays(
            arrays, devices, value_tier=local.config().value_tier, cold_tier=cold_tier))
    if isinstance(table, TieredHKVTable):
        return table.with_state(convert.tiered_state_from_arrays(
            arrays, table.device, hot_tier=table.hot.cfg.value_tier,
            cold_tier=table.cold.cfg.value_tier))
    return table.with_state(convert.state_from_arrays(arrays, table.state.device,
                                                      table.cfg.value_tier))


def _from_leaves(target: Any, arrays: list) -> Any:
    it = iter(arrays)

    def one(leaf):
        mine = [next(it) for _ in range(_num_leaves(leaf))]
        if _is_table(leaf):
            return _restore_table(leaf, mine)
        t = convert.values_from_numpy(mine[0])
        return t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t

    return tree.map(one, target, is_leaf=_is_table)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _write(path: str, step: int, arrays: list, treedef: str, extra: Optional[dict]) -> str:
    final = _step_dir(path, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef, "num_leaves": len(arrays),
                "extra": extra or {}}
    for i, arr in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(path, keep=3)
    return final


def save(path: str, step: int, target: Any, extra: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint of a tree (tables included). Returns
    the final directory."""
    return _write(path, step, _host_leaves(target), _treedef(target), extra)


@dataclasses.dataclass
class PendingSave:
    """One `save_async` call: its bytes, the time its host copy held the
    caller, and (once written) the writer thread's time."""

    step: int
    nbytes: int
    host_copy_s: float
    thread: threading.Thread
    write_s: Optional[float] = None
    error: Optional[BaseException] = None


_pending: list = []


def save_async(path: str, step: int, target: Any, extra: Optional[dict] = None) -> PendingSave:
    """Copy every leaf to the host (blocking only for that copy), then
    write on a daemon thread.  `wait_async()` joins outstanding writes."""
    t0 = time.perf_counter()
    arrays = _host_leaves(target)
    host_s = time.perf_counter() - t0
    treedef = _treedef(target)

    def write():
        t1 = time.perf_counter()
        try:
            _write(path, step, arrays, treedef, extra)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait_async
            pending.error = e
        pending.write_s = time.perf_counter() - t1

    thread = threading.Thread(target=write, daemon=True)
    pending = PendingSave(step=step, nbytes=sum(int(a.nbytes) for a in arrays),
                          host_copy_s=host_s, thread=thread)
    thread.start()
    _pending.append(pending)
    return pending


def wait_async():
    """Join every outstanding write; re-raise the first writer's error."""
    errors = []
    while _pending:
        p = _pending.pop()
        p.thread.join()
        if p.error is not None:
            errors.append(p.error)
    if errors:
        raise errors[-1]


def _table_manifest(table) -> dict:
    """Structural fingerprint of a table handle for restore validation, the
    reference's: both tiers of a `TieredHKVTable`."""
    if isinstance(table, TieredHKVTable):
        return {"kind": "TieredHKVTable", "hot": _table_manifest(table.hot),
                "cold": _table_manifest(table.cold)}
    cfg = getattr(table, "cfg", None)
    out = {"kind": type(table).__name__, "capacity": int(table.capacity),
           "dim": int(table.dim)}
    if cfg is not None:
        out["score_policy"] = cfg.score_policy
        out["value_tier"] = cfg.value_tier
    return out


def save_table(path: str, step: int, table, extra: Optional[dict] = None) -> str:
    """Atomic checkpoint of a table handle (flat, tiered or sharded): every
    tier and shard in ONE step directory behind ONE rename; the manifest
    records the structure for validation at restore."""
    extra = dict(extra or {})
    extra["table"] = _table_manifest(table)
    return save(path, step, table, extra=extra)


def _manifest(path: str, step: int) -> dict:
    with open(os.path.join(_step_dir(path, step), "manifest.json")) as f:
        return json.load(f)


def restore_table(path: str, step: int, table):
    """Restore a table checkpoint onto `table`'s structure (config and
    backend from the live handle, planes from disk).  Raises if the
    recorded structure does not match the target."""
    want = _manifest(path, step)["extra"].get("table")
    got = _table_manifest(table)
    if want is not None and want != got:
        raise ValueError(
            f"checkpoint table structure {want} does not match the restore target {got}")
    return restore(path, step, table)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, step: int, target: Any):
    """Restore onto the structure of `target`: each leaf on the device of
    the target's leaf, each table as a handle like the target's on new
    planes.  Returns (tree, extra)."""
    manifest = _manifest(path, step)
    d = _step_dir(path, step)
    want = sum(_num_leaves(x) for x in tree.leaves(target, is_leaf=_is_table))
    if manifest["num_leaves"] != want:
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, the target {want}")
    arrays = [np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
              for i in range(manifest["num_leaves"])]
    return _from_leaves(target, arrays), manifest["extra"]


def _gc(path: str, keep: int):
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
