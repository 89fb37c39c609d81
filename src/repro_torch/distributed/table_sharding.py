"""Distributed HKV table: owner-routed all-to-all over a device mesh (the
port of ``repro/distributed/table_sharding.py``).

The paper leaves multi-GPU sharding to the application (§7); this module is
that application layer, built the way HugeCTR shards model-parallel
embeddings:

  * Every shard owns an independent local HKV table of capacity / n_shards
    (its own buckets, digests, scores and values; every core invariant
    holds locally, cache semantics at local λ = 1.0 included).
  * A key's OWNER shard is a hash of the key (fmix32 of h2), so hot Zipfian
    keys scatter uniformly across shards.
  * Lookup: local dedupe, a capacity-bounded all-to-all of keys to their
    owners, the owner's find_or_insert (or find), and an all-to-all of the
    rows back.  Gradients take the same route: summed per unique key at the
    source, summed again across sources at the owner, applied once by the
    sparse optimizer.
  * Admission and eviction happen owner-side with unchanged semantics.

Skew: a source sends at most `cap` = capacity_factor x its fair share of
keys to one owner (`_cap`).  Keys beyond it fall back to the deterministic
init rows, report `found` False, and are counted in `overflow`.

The mesh (``repro_torch.launch.mesh``) is a grid of torch devices in which
a device may repeat, and one controller drives it, as the reference's
``shard_map`` runs in one process:

  * shard s sits at the mesh position whose coordinates over `axis_names`
    are s in row-major order (the reference's linearization of a tuple of
    axes), on that position's device;
  * a global key batch is split over the data-parallel axes ("pod",
    "data") and replicated over the others, as the reference's
    ``in_specs`` ``P(dp)``: on a ("data", "model") mesh of (2, 4), the 4
    model positions of a data row route the same keys, so an owner receives
    each key up to 4 times in one batch.  Results come back from the
    replica at index 0 of every non-data axis;
  * the all-to-all (`all_to_all`) stacks each destination's chunks: one
    stack when the shards share a device, copies between devices
    otherwise;
  * every shard runs every owner op, even on a batch of EMPTY lanes: the
    shards' clocks and epochs (replicated scalars in the reference) stay
    equal only because they advance in lockstep.

The port's tables change in place: an op's `.table` is the same sharded
handle, and each shard's owner-side traffic goes through its local
handle (`HKVEmbedding.wrap`), an ``HKVTable``, or a ``TieredHKVTable``
when the embedding has `hot_capacity`.  Routed keys reach those handles as
``torch.uint64`` views of the normalized words, which they take bit for
bit (an int64 word at or above 2**63 would read as padding).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import u64
from repro_torch.core.api import normalize_keys
from repro_torch.core.merge import EvictionStream
from repro_torch.core.ops import ExportResult
from repro_torch.core.table import HKVState
from repro_torch.core.tiered import TieredState
from repro_torch.distributed.sharding import P
from repro_torch.embedding.dynamic import HKVEmbedding
from repro_torch.launch.mesh import Mesh, data_axes


def _obs_tel():
    """The telemetry module, imported only where a sink is given."""
    from repro_torch.obs import telemetry as obs_telemetry

    return obs_telemetry


def _exact(keys: torch.Tensor) -> torch.Tensor:
    """Normalized int64 keys in the form a handle takes bit for bit."""
    return keys.view(torch.uint64)


def all_to_all(chunks: list, devices: list) -> list:
    """The reference's ``jax.lax.all_to_all(x, axes, 0, 0, tiled=True)``
    across shards: ``chunks[s]`` is source s's send buffer [n, cap, ...] on
    ``devices[s]``, and destination d receives the stack over sources s of
    ``chunks[s][d]``, [n, cap, ...] on ``devices[d]``.  Shards on one
    device exchange by one stack; on distinct devices each chunk is copied
    to its destination."""
    n = len(chunks)
    if all(d == devices[0] for d in devices):
        return list(torch.stack(chunks).transpose(0, 1).contiguous().unbind(0))
    return [torch.stack([chunks[s][d].to(devices[d], non_blocking=True) for s in range(n)])
            for d in range(n)]


def _each(fn, *cols: list) -> list:
    """[fn(*args) for args in zip(*cols)], computed once per distinct
    tuple of objects (replicas of one data chunk on one device share their
    routing)."""
    memo, out = {}, []
    for args in zip(*cols):
        k = tuple(map(id, args))
        if k not in memo:
            memo[k] = fn(*args)
        out.append(memo[k])
    return out


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where the shards sit: per shard its device and data chunk; per data
    chunk its primary shard (the replica whose results are returned)."""

    devices: tuple
    chunk: tuple
    primaries: tuple

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def n_data(self) -> int:
        return len(self.primaries)

    def split(self, x: torch.Tensor) -> list:
        """x [N, ...] -> per shard its data chunk on its device (one tensor
        per chunk and device).  N must divide by the data-parallel size."""
        if x.shape[0] % self.n_data:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {self.n_data} "
                             "data-parallel shards")
        per = x.shape[0] // self.n_data
        memo = {}
        out = []
        for c, dev in zip(self.chunk, self.devices):
            if (c, dev) not in memo:
                memo[(c, dev)] = x[c * per:(c + 1) * per].to(dev)
            out.append(memo[(c, dev)])
        return out


def layout(mesh: Mesh, axis_names: tuple) -> _Layout:
    """Shard order, devices and data chunks of a table sharded over
    `axis_names` (mesh axes left out must have size 1)."""
    rest = [a for a in mesh.axis_names if a not in axis_names]
    if any(mesh.shape[a] != 1 for a in rest) or not set(axis_names) <= set(mesh.axis_names):
        raise ValueError(f"a table sharded over {axis_names} on {mesh}: every mesh axis of "
                         "size above 1 must be a shard axis")
    dp = data_axes(mesh)
    sizes = [mesh.shape[a] for a in axis_names]
    dp_sizes = [mesh.shape[a] for a in dp]
    devices, chunk, primaries = [], [], {}
    for s in range(int(np.prod(sizes))):
        coord = dict(zip(axis_names, (int(c) for c in np.unravel_index(s, sizes))))
        devices.append(mesh.device_at([coord.get(a, 0) for a in mesh.axis_names]))
        c = int(np.ravel_multi_index([coord.get(a, 0) for a in dp], dp_sizes)) if dp else 0
        chunk.append(c)
        if all(coord.get(a, 0) == 0 for a in mesh.axis_names if a not in dp):
            primaries[c] = s
    return _Layout(devices=tuple(devices), chunk=tuple(chunk),
                   primaries=tuple(primaries[c] for c in range(len(primaries))))


class _Routed(NamedTuple):
    """One source's routing of its keys."""

    send: torch.Tensor       # int64 [n_shards, cap]: keys by owner, EMPTY-padded
    key_slot: torch.Tensor   # int64 [N]: each key's send slot (-1: overflow or EMPTY)


@dataclasses.dataclass(frozen=True)
class ShardedHKVEmbedding:
    """HKVEmbedding sharded over mesh axes (default: every mesh axis)."""

    emb: HKVEmbedding              # GLOBAL capacity; local = capacity / n_shards
    axis_names: tuple              # mesh axes the table shards over
    capacity_factor: float = 2.0

    def local_embedding(self, n_shards: int) -> HKVEmbedding:
        def shard_cap(c):
            return max(128, (c // n_shards // 128) * 128)

        return dataclasses.replace(
            self.emb, capacity=shard_cap(self.emb.capacity),
            hot_capacity=shard_cap(self.emb.hot_capacity) if self.emb.is_tiered else None)

    def layout(self, mesh: Mesh) -> _Layout:
        return layout(mesh, self.axis_names)

    # -- routing ---------------------------------------------------------------

    def _owner(self, keys: torch.Tensor, n_shards: int) -> torch.Tensor:
        """int64 [N]: each key's owner shard; EMPTY keys get `n_shards`."""
        _, h2 = u64.hash_pair(keys)
        own = u64.fmix32(h2 ^ 0x2545F491) % n_shards
        return torch.where(u64.empty_lanes(keys), n_shards, own)

    def _route(self, keys: torch.Tensor, n_shards: int, cap: int) -> _Routed:
        """Sort the keys by owner (stably: the rank within an owner decides
        which keys overflow `cap`) into [n_shards, cap] send buffers."""
        n = keys.shape[0]
        dev = keys.device
        owner = self._owner(keys, n_shards)
        order = torch.sort(owner, stable=True).indices
        o_s = owner[order]
        iota = torch.arange(n, device=dev)
        is_new = torch.ones(n, dtype=torch.bool, device=dev)
        is_new[1:] = o_s[1:] != o_s[:-1]
        rank = iota - torch.cummax(torch.where(is_new, iota, -1), 0).values
        ok = (o_s < n_shards) & (rank < cap)
        slot = torch.where(ok, o_s * cap + rank, n_shards * cap)
        send = torch.full((n_shards * cap + 1,), u64.EMPTY, dtype=torch.int64, device=dev)
        send[slot] = keys[order]              # the extra slot takes what is dropped
        key_slot = torch.empty(n, dtype=torch.int64, device=dev)
        key_slot[order] = torch.where(ok, slot, -1)
        return _Routed(send[:-1].reshape(n_shards, cap), key_slot)

    def _cap(self, per_shard_tokens: int, n_shards: int) -> int:
        c = int(per_shard_tokens * self.capacity_factor / n_shards)
        return max(8, -(-c // 8) * 8)

    def _sized(self, mesh: Mesh, n: int):
        """(layout, cap) of an op on a global batch of n keys."""
        lay = self.layout(mesh)
        return lay, self._cap(max(n // lay.n_data, 1), lay.n_shards)

    @staticmethod
    def _pack(n: int, routes: list, rows: list, cap: int, add: bool) -> list:
        """Per source: its rows set (or, with `add`, added onto zeros, as
        the reference routes gradients) at their keys' send slots, [n, cap,
        width] for n shards, zeros elsewhere."""

        def pack(r: _Routed, v: torch.Tensor):
            buf = v.new_zeros((n * cap + 1, v.shape[1]))
            slot = torch.where(r.key_slot >= 0, r.key_slot, n * cap)   # the last row drops
            if add:
                buf.index_add_(0, slot, v)
            else:
                buf[slot] = v
            return buf[:-1].reshape(n, cap, v.shape[1])

        return _each(pack, routes, rows)

    @staticmethod
    def _ovf(keys: torch.Tensor, r: _Routed) -> torch.Tensor:
        return ((r.key_slot < 0) & ~u64.empty_lanes(keys)).sum()

    @staticmethod
    def _sinks(lay: _Layout, telemetry) -> list:
        """A shard-local sink a shard when the caller gave one."""
        if telemetry is None:
            return [None] * lay.n_shards
        return [_obs_tel().TelemetrySink() for _ in range(lay.n_shards)]

    @staticmethod
    def _record(telemetry, op: str, sinks: list, home: torch.device) -> None:
        """Record the shard-local sinks' sum as one whole-mesh record."""
        if telemetry is not None:
            telemetry.record(op, _obs_tel().psum_telemetry([s.total() for s in sinks], home))

    # -- owner-side bodies -----------------------------------------------------

    def _lookup_body(self, lay, states, uniq, cap, train, promote=True, sinks=None):
        """uniq[s]: source s's unique keys (EMPTY-padded) on its device.  The
        owner op runs on every shard; returns {primary source: (rows [N,
        dim], found [N], overflow)}, rows falling back to the init rows
        where a key was not routed."""
        n = lay.n_shards
        local = self.local_embedding(n)
        sinks = sinks or [None] * n
        routes = _each(lambda k: self._route(k, n, cap), uniq)
        recv = all_to_all([r.send for r in routes], list(lay.devices))
        backs = []
        for o in range(n):
            rk = recv[o].reshape(-1)
            init = local.default_rows(rk)
            t = local.wrap(states[o])
            if train:
                res = t.find_or_insert(_exact(rk), init, telemetry=sinks[o])
                rows, present = res.values, res.found
            else:
                if local.is_tiered:
                    fr = t.find(_exact(rk), promote=promote, telemetry=sinks[o])
                else:
                    fr = t.find(_exact(rk), telemetry=sinks[o])
                rows = torch.where(fr.found[:, None], fr.values, init[:, :local.dim])
                present = fr.found
            # the presence flag travels back as one extra column (exact in
            # float: 0.0 or 1.0)
            backs.append(torch.cat([rows, present.to(rows.dtype)[:, None]], dim=1)
                         .reshape(n, cap, local.dim + 1))
        back = all_to_all(backs, list(lay.devices))
        out = {}
        for s in lay.primaries:
            keys, r = uniq[s], routes[s]
            b = back[s].reshape(n * cap, local.dim + 1)[r.key_slot.clamp(min=0)]
            routed = r.key_slot >= 0
            rows = torch.where(routed[:, None], b[:, :local.dim], local.default_rows(keys))
            out[s] = (rows, routed & (b[:, local.dim] > 0), self._ovf(keys, r))
        return out

    def _grad_body(self, lay, states, uniq, grads, cap):
        """Route each source's per-unique gradient sums to the owners, sum
        them across sources there (in sorted order), and apply them in one
        structured update_rows per shard (one update_scan on the card)."""
        n = lay.n_shards
        local = self.local_embedding(n)
        routes = _each(lambda k: self._route(k, n, cap), uniq)
        gbufs = self._pack(n, routes, grads, cap, add=True)
        recv = all_to_all([r.send for r in routes], list(lay.devices))
        recv_g = all_to_all(gbufs, list(lay.devices))
        for o in range(n):
            rk, g = recv[o].reshape(-1), recv_g[o].reshape(n * cap, -1)
            d = merge_mod.dedupe_keys(rk)
            uk = torch.full_like(rk, u64.EMPTY)
            uk[d.gid] = rk[d.idx_sorted]
            g_sum = torch.zeros_like(g).index_add_(0, d.gid, g[d.idx_sorted])
            s = local.wrap(states[o]).session()
            s.update_rows(_exact(uk), ops_mod.RowUpdate(local.optimizer, g_sum))
            s.commit()

    def _values_body(self, lay, states, keys, values, cap, op, sinks=None):
        """Route each source's deduped keys with their last writer's rows to
        the owners and run `op(local handle, keys, rows, sink)` there.
        Returns (routes, dedupes, per-owner results)."""
        n = lay.n_shards
        local = self.local_embedding(n)
        sinks = sinks or [None] * n
        deds = _each(merge_mod.dedupe_keys, keys)
        routes = _each(lambda d: self._route(d.unique, n, cap), deds)
        last = _each(lambda v, d: v[d.last_index], values, deds)
        vbufs = self._pack(n, routes, last, cap, add=False)
        recv = all_to_all([r.send for r in routes], list(lay.devices))
        recv_v = all_to_all(vbufs, list(lay.devices))
        res = [op(local.wrap(states[o]), _exact(recv[o].reshape(-1)),
                  recv_v[o].reshape(n * cap, -1), sinks[o]) for o in range(n)]
        return routes, deds, res

    # -- entry points: one global batch, on the mesh's home device -------------

    def state_specs(self):
        """One shard's state tree with a spec for each plane: its leading
        (bucket or row) axis split over `axis_names`; the scalar clock and
        epoch replicated (every shard advances them in lockstep).  A tiered
        shard gives a ``TieredState`` of two such trees."""
        ax = self.axis_names

        def specs(state: HKVState) -> HKVState:
            keys, digests, scores, values = (P(ax, *([None] * (t.ndim - 1)))
                                             for t in state.planes)
            return HKVState(keys=keys, digests=digests, scores=scores, values=values,
                            clock=P(), epoch=P())

        shape = self.local_embedding(1).create(device="meta").state
        if isinstance(shape, TieredState):
            return TieredState(specs(shape.hot), specs(shape.cold))
        return specs(shape)

    def create_sharded(self, mesh: Mesh) -> tuple:
        lay = self.layout(mesh)
        local = self.local_embedding(lay.n_shards)
        return tuple(local.create(device=dev).state for dev in lay.devices)

    def lookup(self, mesh: Mesh, states, tokens, *, train: bool):
        """tokens [B, ...] (B split over the data-parallel axes).  Returns
        (rows of shape tokens.shape + (dim,), overflow)."""
        tokens = torch.as_tensor(tokens, device=mesh.home)
        lay, cap = self._sized(mesh, tokens.numel())
        src = lay.split(tokens.reshape(tokens.shape[0], -1))
        deds = _each(lambda t: merge_mod.dedupe_keys(self.emb.keys_of(t)), src)
        out = self._lookup_body(lay, states, [d.unique for d in deds], cap, train)
        rows = [out[s][0][deds[s].inverse].to(mesh.home) for s in lay.primaries]
        ovf = sum(out[s][2].to(mesh.home) for s in lay.primaries)
        return torch.cat(rows).reshape(tuple(tokens.shape) + (self.emb.dim,)), ovf

    def find_keys(self, mesh: Mesh, states, keys: torch.Tensor, *, train: bool = False,
                  promote: bool = True, telemetry=None):
        """Key-level lookup of normalized keys [N] (N divisible by the
        data-parallel size).  Returns (values [N, dim], found [N],
        overflow).  Misses return ZERO rows (the table-surface contract),
        unless `train`: then an overflowed key keeps its init row.
        `telemetry=` records one whole-mesh record: the shards' sums."""
        lay, cap = self._sized(mesh, keys.shape[0])
        sinks = self._sinks(lay, telemetry)
        src = lay.split(keys)
        deds = _each(merge_mod.dedupe_keys, src)
        out = self._lookup_body(lay, states, [d.unique for d in deds], cap, train,
                                promote=promote, sinks=sinks)
        rows, found = [], []
        for s in lay.primaries:
            r, f, _ = out[s]
            d = deds[s]
            f = f[d.inverse] & ~u64.empty_lanes(src[s])
            r = r[d.inverse]
            if not train:    # the reader contract: zeros where not found
                r = torch.where(f[:, None], r, torch.zeros((), dtype=r.dtype, device=r.device))
            rows.append(r.to(mesh.home))
            found.append(f.to(mesh.home))
        self._record(telemetry, "sharded_find_or_insert" if train else "sharded_find", sinks,
                     mesh.home)
        ovf = sum(out[s][2].to(mesh.home) for s in lay.primaries)
        return torch.cat(rows), torch.cat(found), ovf

    def upsert_keys(self, mesh: Mesh, states, keys: torch.Tensor, values: torch.Tensor, *,
                    telemetry=None):
        """Key-level insert_or_assign, the batch's last writer's row routed
        to each key's owner.  Returns (status int8 [N], overflow); lanes
        not routed report status 0."""
        lay, cap = self._sized(mesh, keys.shape[0])
        n = lay.n_shards
        sinks = self._sinks(lay, telemetry)
        routes, deds, res = self._values_body(
            lay, states, lay.split(keys), lay.split(values), cap,
            lambda t, k, v, sink: t.insert_or_assign(k, v, telemetry=sink), sinks)
        back = all_to_all([r.status.to(torch.int32).reshape(n, cap) for r in res],
                          list(lay.devices))
        status, ovf = [], []
        for s in lay.primaries:
            r, d = routes[s], deds[s]
            st = torch.where(r.key_slot >= 0, back[s].reshape(-1)[r.key_slot.clamp(min=0)], 0)
            status.append(st[d.inverse].to(torch.int8).to(mesh.home))
            ovf.append(self._ovf(d.unique, r).to(mesh.home))
        self._record(telemetry, "sharded_insert_or_assign", sinks, mesh.home)
        return torch.cat(status), sum(ovf)

    def assign_keys(self, mesh: Mesh, states, keys: torch.Tensor, values: torch.Tensor) -> None:
        """Key-level updater: rows routed to owners; misses are no-ops."""
        lay, cap = self._sized(mesh, keys.shape[0])
        self._values_body(lay, states, lay.split(keys), lay.split(values), cap,
                          lambda t, k, v, _sink: t.assign(k, v))

    def erase_keys(self, mesh: Mesh, states, keys: torch.Tensor) -> None:
        """Key-level structural erase routed to owners."""
        lay, cap = self._sized(mesh, keys.shape[0])
        n = lay.n_shards
        local = self.local_embedding(n)
        routes = _each(lambda k: self._route(k, n, cap), lay.split(keys))
        recv = all_to_all([r.send for r in routes], list(lay.devices))
        for o in range(n):
            local.wrap(states[o]).erase(_exact(recv[o].reshape(-1)))

    def apply_grads(self, mesh: Mesh, states, tokens, grads: torch.Tensor) -> None:
        """The sparse optimizer step on the rows of the batch's tokens:
        gradients summed per unique token at the source, then per key
        across sources at the owner."""
        tokens = torch.as_tensor(tokens, device=mesh.home)
        grads = torch.as_tensor(grads, device=mesh.home)
        lay, cap = self._sized(mesh, tokens.numel())
        b = tokens.shape[0]
        src_t = lay.split(tokens.reshape(b, -1))
        src_g = lay.split(grads.reshape(b, -1, self.emb.dim))

        def uniq(t, g):
            d = merge_mod.dedupe_keys(self.emb.keys_of(t))
            g = g.reshape(-1, self.emb.dim)
            return d.unique, torch.zeros_like(g).index_add_(0, d.inverse, g)

        per = _each(uniq, src_t, src_g)
        self._grad_body(lay, states, [p[0] for p in per], [p[1] for p in per], cap)


# =============================================================================
# ShardedHKVTable: the KVTable-protocol handle over the sharded engine
# =============================================================================


class ShardedFind(NamedTuple):
    values: torch.Tensor     # [N, dim] (zeros where not found)
    found: torch.Tensor      # bool [N]
    overflow: torch.Tensor   # int64 []: keys that missed their routing budget
    # the handle (the same one: tiered shards' promotions happened in place)
    table: "ShardedHKVTable" = None


class ShardedUpsert(NamedTuple):
    table: "ShardedHKVTable"
    status: torch.Tensor     # int8 [N] merge status codes (0 where unrouted)
    overflow: torch.Tensor

    @property
    def ok(self) -> torch.Tensor:
        return (self.status >= ops_mod.STATUS_UPDATED) & (self.status <= ops_mod.STATUS_EVICTED)


class ShardedFindOrInsert(NamedTuple):
    table: "ShardedHKVTable"
    values: torch.Tensor
    found: torch.Tensor
    overflow: torch.Tensor


class ShardedSweep(NamedTuple):
    table: "ShardedHKVTable"
    swept: torch.Tensor      # int64 []: entries removed across all shards


class ShardedEvictIf(NamedTuple):
    table: "ShardedHKVTable"
    # per-shard coldest-first streams concatenated shard-major: lanes
    # [i*budget, (i+1)*budget) are shard i's rank order (2*budget a shard
    # when the shards are tiered).  The budget is PER SHARD: sweeps are
    # bucket-local, so per-shard application is owner-routed
    evicted: EvictionStream
    count: torch.Tensor      # int64 []


def _clone(state):
    if isinstance(state, TieredState):
        return TieredState(state.hot.clone(), state.cold.clone())
    return state.clone()


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedHKVTable:
    """One table sharded over a mesh, behind the handle discipline of
    `HKVTable`.  `state` holds the shards' states in shard order, each on
    its mesh position's device; ops change them in place and return this
    handle (or results whose `.table` is it).  Global inputs and results
    live on the mesh's home device (its first position's).  Implements the
    `KVTable` protocol."""

    state: tuple
    semb: ShardedHKVEmbedding
    mesh: Mesh

    # -- construction ----------------------------------------------------------

    @classmethod
    def create(cls, mesh: Mesh, emb: Optional[HKVEmbedding] = None, *,
               axis_names: Optional[tuple] = None, capacity_factor: float = 2.0,
               **emb_kwargs) -> "ShardedHKVTable":
        if emb is None:
            emb = HKVEmbedding(**emb_kwargs)
        semb = ShardedHKVEmbedding(emb=emb, axis_names=tuple(axis_names or mesh.axis_names),
                                   capacity_factor=capacity_factor)
        return cls(state=semb.create_sharded(mesh), semb=semb, mesh=mesh)

    def with_state(self, state) -> "ShardedHKVTable":
        """A handle on the given shard states (no copy)."""
        return dataclasses.replace(self, state=tuple(state))

    def snapshot(self) -> "ShardedHKVTable":
        """An independent copy of every shard."""
        return self.with_state(_clone(s) for s in self.state)

    # -- static views ----------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.state)

    @property
    def local(self) -> HKVEmbedding:
        """The embedding of one shard (capacity / n_shards)."""
        return self.semb.local_embedding(self.n_shards)

    @property
    def shards(self) -> list:
        """Each shard's local handle (an HKVTable or a TieredHKVTable)."""
        return [self.local.wrap(s) for s in self.state]

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def backend(self) -> str:
        return self.semb.emb.backend

    @property
    def capacity(self) -> int:
        # realized capacity: per-shard rounding times shard count (both
        # tiers' slots when the local tables are tiered)
        return self.local.total_capacity * self.n_shards

    @property
    def dim(self) -> int:
        return self.semb.emb.dim

    def keys(self, keys: Any) -> torch.Tensor:
        return normalize_keys(keys, self.device)

    def _rows(self, values: Any) -> torch.Tensor:
        if isinstance(values, np.ndarray) and values.dtype.name == "bfloat16":
            from repro_torch.convert import values_from_numpy

            values = values_from_numpy(values)
        return torch.as_tensor(values, device=self.device)

    # -- KVTable protocol ------------------------------------------------------

    def find(self, keys: Any, *, promote: bool = True, telemetry=None) -> ShardedFind:
        """Lookup.  On tiered shards the default runs the miss-path
        promotion; `promote=False` is the pure reader."""
        values, found, ovf = self.semb.find_keys(self.mesh, self.state, self.keys(keys),
                                                 train=False, promote=promote,
                                                 telemetry=telemetry)
        return ShardedFind(values=values, found=found, overflow=ovf, table=self)

    def insert_or_assign(self, keys: Any, values: Any, *, telemetry=None) -> ShardedUpsert:
        status, ovf = self.semb.upsert_keys(self.mesh, self.state, self.keys(keys),
                                            self._rows(values), telemetry=telemetry)
        return ShardedUpsert(table=self, status=status, overflow=ovf)

    def find_or_insert(self, keys: Any, *, telemetry=None) -> ShardedFindOrInsert:
        """Admission-controlled lookup; misses insert the deterministic
        hash-derived init rows (owners recompute them from the key: caller
        init rows are not routed)."""
        values, found, ovf = self.semb.find_keys(self.mesh, self.state, self.keys(keys),
                                                 train=True, telemetry=telemetry)
        return ShardedFindOrInsert(table=self, values=values, found=found, overflow=ovf)

    def assign(self, keys: Any, values: Any) -> "ShardedHKVTable":
        """Updater: write values of existing keys (misses no-op).  Keys
        beyond the routing budget are dropped."""
        self.semb.assign_keys(self.mesh, self.state, self.keys(keys), self._rows(values))
        return self

    def erase(self, keys: Any) -> "ShardedHKVTable":
        self.semb.erase_keys(self.mesh, self.state, self.keys(keys))
        return self

    def clear(self) -> "ShardedHKVTable":
        for t in self.shards:
            t.clear()
        return self

    def contains(self, keys: Any) -> torch.Tensor:
        # the pure reader: no miss-path promotion on tiered shards
        _values, found, _ovf = self.semb.find_keys(self.mesh, self.state, self.keys(keys),
                                                   train=False, promote=False)
        return found

    # -- maintenance (sweeps are bucket-local: each shard sweeps its own) ------

    def erase_if(self, pred) -> ShardedSweep:
        swept = [t.erase_if(pred).swept.to(self.device) for t in self.shards]
        return ShardedSweep(table=self, swept=sum(swept))

    def evict_if(self, pred, budget: int) -> ShardedEvictIf:
        res = [t.evict_if(pred, budget) for t in self.shards]
        stream = EvictionStream(*[torch.cat([getattr(r.evicted, f).to(self.device) for r in res])
                                  for f in EvictionStream._fields])
        return ShardedEvictIf(table=self, evicted=stream,
                              count=sum(r.count.to(self.device) for r in res))

    def stats(self):
        """`TableStats` over the whole mesh: the shards' key and score
        planes taken as one table (stats never hash keys).  For tiered
        shards the hot and cold summaries combine with the inclusive
        duplicates deduped through `size()`."""
        from repro_torch.maintenance import stats as stats_mod  # maintenance sits above

        def planes(states):
            return (torch.cat([s.keys.to(self.device) for s in states]),
                    torch.cat([s.scores.to(self.device) for s in states]))

        if self.local.is_tiered:
            hot = stats_mod.stats_from_planes(*planes([s.hot for s in self.state]))
            cold = stats_mod.stats_from_planes(*planes([s.cold for s in self.state]))
            return stats_mod.combine_stats(hot, cold, size=self.size())
        return stats_mod.stats_from_planes(*planes(self.state))

    # -- export (per-shard drain, lanes concatenated shard-major) ---------------

    @property
    def num_buckets(self) -> int:
        """Export-space bucket count PER SHARD: each call drains the same
        local bucket range on every shard, so [0, num_buckets) covers the
        whole mesh exactly once."""
        local = self.local
        nb = local.config().num_buckets
        if local.is_tiered:
            nb += local.cold_config().num_buckets
        return nb

    def export_batch(self, bucket_start: int, bucket_count: int) -> ExportResult:
        """Local buckets [start, start + count) of EVERY shard,
        concatenated shard-major with the liveness mask.  Owner routing
        partitions the keys, so the lanes are disjoint across shards."""
        parts = [t.export_batch(bucket_start, bucket_count) for t in self.shards]
        return ExportResult(*[torch.cat([getattr(p, f).to(self.device) for p in parts])
                              for f in ExportResult._fields])

    def size(self) -> int:
        # through the handles, so tiered shards count inclusive copies once
        return sum(int(t.size()) for t in self.shards)

    def load_factor(self) -> float:
        return self.size() / self.capacity

    # -- embedding-layer delegates (the training path) -------------------------

    def lookup(self, tokens, *, train: bool):
        """Returns (this handle, rows [*tokens.shape, dim], overflow)."""
        rows, ovf = self.semb.lookup(self.mesh, self.state, tokens, train=train)
        return self, rows, ovf

    def apply_grads(self, tokens, grads: torch.Tensor) -> "ShardedHKVTable":
        self.semb.apply_grads(self.mesh, self.state, tokens, grads)
        return self
