"""Dictionary-semantic baseline hash tables (see the package docstring):
the port's copy of ``repro/baselines/dict_tables.py``.

Both tables expose the batched subset of HKV's API the paper compares
(insert, find) plus per-op probe-transaction counts: the structural cost
metric of paper Table 3, which does not depend on the hardware.  No TPU
kernel backs them in the reference, so they are plain PyTorch here, on any
device.  Their states change in place, as the port's HKV tables do: each
op returns the state it was given.

The reference's probe and placement loops (``jax.lax.while_loop``) become
host loops, one host read a round.  A round works only on the lanes still
active (the reference computes every lane and masks the rest; the results
are the same), and open addressing's claim round keeps one slot-sized
array of winners for the whole insert, resetting only the slots claimed
in the round, where the reference builds a fresh capacity-sized array each
round.  Several lanes that write one slot or row resolve by the batch's
last writer, as the reference's scatter does on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import table as table_mod
from repro_torch.core import u64
from repro_torch.core.api import normalize_keys
from repro_torch.core.merge import EvictionStream
from repro_torch.core.ops import ExportResult

# Open-addressing DELETED marker (classic tombstone): not EMPTY, so probe
# chains continue past it, but claimable by inserts.  One key next to the
# EMPTY sentinel is given up for it: 0xFFFF_FFFF_FFFF_FFFE, the int64 -2.
# A negative id is padding at the API, so the tombstone is only ever
# written into a key plane and compared there.
TOMB = u64.to_signed(0xFFFF_FFFF_FFFF_FFFE)

_OA_EXPORT_SLOTS = 128
_P2C_ROUNDS = 32             # the reference's cap on P2C placement rounds


def _is_tomb(keys: torch.Tensor) -> torch.Tensor:
    return keys == TOMB


def _rank_rows_flat(keys: torch.Tensor, mask: torch.Tensor, budget: int):
    """First `budget` masked slots of a FLAT key plane in the dictionary
    tables' sweep order (no score metadata: ascending unsigned key).
    Returns (rows int64 [budget], lane bool [budget]); rows past the
    masked count are unmasked slots (lane False)."""
    order = merge_mod.stable_argsort((~mask).to(torch.uint8), u64.flip(keys))
    rows = order[:budget]
    return rows, mask[rows]


def _rows(values: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(values, device=device).to(torch.float32)


class InsertReport(NamedTuple):
    state: Any
    ok: torch.Tensor        # bool [N]: False = dictionary-semantic insert FAILURE
    probes: torch.Tensor    # int32 [N]: memory transactions consumed


class FindReport(NamedTuple):
    values: torch.Tensor
    found: torch.Tensor
    probes: torch.Tensor    # int32 [N]


# =============================================================================
# Open addressing (WarpCore / cuCollections family)
# =============================================================================


class OAState(NamedTuple):
    keys: torch.Tensor      # int64 [C]: EMPTY free, TOMB deleted
    values: torch.Tensor    # float32 [C, D]


@dataclasses.dataclass(frozen=True)
class OpenAddressingTable:
    """Linear probing over a flat slot array; probe chains grow with λ.

    max_probe bounds the probe loop (WarpCore's probing is unbounded; the
    cap reports failure beyond it, which is conservative in the baseline's
    favour)."""

    capacity: int
    dim: int
    max_probe: int = 512

    def create(self, device=None) -> OAState:
        """An empty table on `device` (default: the card)."""
        device = table_mod.resolve_device(device)
        c = self.capacity
        return OAState(keys=torch.full((c,), u64.EMPTY, dtype=torch.int64, device=device),
                       values=torch.zeros((c, self.dim), dtype=torch.float32, device=device))

    def _slot(self, h1: torch.Tensor, d: int) -> torch.Tensor:
        """The probe's d-th slot: (h1 + d) as a uint32 (it wraps at 2**32,
        as the reference's does), then the table's modulus."""
        h = (h1 + d) & u64.MASK32
        c = self.capacity
        return h & (c - 1) if c & (c - 1) == 0 else h % c

    def _probe(self, state: OAState, keys: torch.Tensor):
        """Scan each key's probe chain until the key or a true EMPTY slot.
        Tombstones do NOT stop the scan (the key may live beyond one).
        Returns (found, slot, probes)."""
        n = keys.shape[0]
        dev = keys.device
        h1, _ = u64.hash_pair(keys)
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        slot_at = torch.zeros(n, dtype=torch.int64, device=dev)
        probes = torch.zeros(n, dtype=torch.int32, device=dev)
        active = torch.nonzero(keys != u64.EMPTY)[:, 0]
        d = 0
        while d < self.max_probe and active.numel():
            slot = self._slot(h1[active], d)
            occ = state.keys[slot]
            probes[active] += 1
            hit = occ == keys[active]
            found[active[hit]] = True
            slot_at[active[hit]] = slot[hit]
            active = active[~(hit | (occ == u64.EMPTY))]
            d += 1
        return found, slot_at, probes

    def insert(self, state: OAState, keys: torch.Tensor, values: Any) -> InsertReport:
        """Batched linear-probe insert, resolving claims within the batch
        like the CAS race it emulates: the lowest batch index wins a
        contested slot.

        Two phases, as in a tombstone-aware table: a full probe pass first
        (so a key beyond a tombstone updates in place rather than
        duplicating into the tombstone), then a claim loop over EMPTY or
        tombstone slots for the remaining misses.  Only the first phase's
        probes count: a real implementation remembers the first free slot
        during its one chain scan."""
        n = keys.shape[0]
        dev = keys.device
        values = _rows(values, dev)
        found, fslot, probes = self._probe(state, keys)
        upd = found & merge_mod.last_writer_mask(keys)
        state.values[fslot[upd]] = values[upd]
        placed = (keys == u64.EMPTY) | found
        h1, _ = u64.hash_pair(keys)
        # the claim rounds' winners, by slot: n means unclaimed; each round
        # resets only the slots it claimed
        winner = torch.full((self.capacity,), n, dtype=torch.int64, device=dev)
        active = torch.nonzero(~placed)[:, 0]
        d = 0
        while d < self.max_probe and active.numel():
            slot = self._slot(h1[active], d)
            occ = state.keys[slot]
            is_self = occ == keys[active]        # a key an earlier round placed
            free = (occ == u64.EMPTY) | _is_tomb(occ)
            fs, fl = slot[free], active[free]
            winner.scatter_reduce_(0, fs, fl, "amin")
            won = torch.zeros_like(free)
            won[free] = winner[fs] == fl
            winner[fs] = n
            write = is_self | won
            wl, ws = active[write], slot[write]
            state.keys[ws] = keys[wl]
            last = merge_mod.last_writer_mask(ws)   # one write a slot, the batch's last
            state.values[ws[last]] = values[wl[last]]
            placed[wl] = True
            active = active[~write]
            d += 1
        return InsertReport(state=state, ok=placed, probes=probes)

    def find(self, state: OAState, keys: torch.Tensor) -> FindReport:
        found, slot_at, probes = self._probe(state, keys)
        vals = torch.where(found[:, None], state.values[slot_at], 0.0)
        return FindReport(values=vals, found=found, probes=probes)

    def assign(self, state: OAState, keys: torch.Tensor, values: Any) -> OAState:
        """Write values of existing keys in place; misses are no-ops."""
        found, slot, _probes = self._probe(state, keys)
        w = found & merge_mod.last_writer_mask(keys)
        state.values[slot[w]] = _rows(values, keys.device)[w]
        return state

    def erase(self, state: OAState, keys: torch.Tensor) -> OAState:
        """Tombstone found keys (probe chains through them stay intact)."""
        found, slot, _probes = self._probe(state, keys)
        state.keys[slot[found]] = TOMB
        state.values[slot[found]] = 0.0
        return state

    # -- maintenance sweeps (predicate over keys; no score metadata) -----------

    def sweep_mask(self, state: OAState, pred) -> torch.Tensor:
        """bool [C]: live (neither EMPTY nor tombstone) slots matching
        `pred`.  Dictionary tables carry no scores; the predicate sees a
        zero score plane."""
        k = state.keys
        live = (k != u64.EMPTY) & ~_is_tomb(k)
        return pred.matches(k, torch.zeros_like(k)) & live

    def erase_mask(self, state: OAState, mask: torch.Tensor) -> OAState:
        """Tombstone every slot where mask (the bulk form of `erase`)."""
        state.keys.masked_fill_(mask, TOMB)
        state.values.masked_fill_(mask[:, None], 0.0)
        return state

    def rank_rows(self, state: OAState, mask: torch.Tensor, budget: int):
        return _rank_rows_flat(state.keys, mask, budget)


# =============================================================================
# Bucketed power-of-two choices (BGHT / BP2HT family, 16-slot buckets)
# =============================================================================


class P2CState(NamedTuple):
    keys: torch.Tensor      # int64 [B, slots]: EMPTY free; live slots packed first
    values: torch.Tensor    # float32 [B * slots, D]


@dataclasses.dataclass(frozen=True)
class BucketedP2CTable:
    """BGHT/BP2HT-like: two candidate 16-slot buckets per key, load-based
    choice, NO eviction: when both are full the insert fails (the BP2HT
    λ 1.0 regime where only 48% of inserts succeed)."""

    capacity: int
    dim: int
    slots: int = 16

    def __post_init__(self):
        if self.capacity % self.slots != 0:
            raise ValueError(f"capacity {self.capacity} must be a multiple of {self.slots}")

    @property
    def num_buckets(self) -> int:
        return self.capacity // self.slots

    def create(self, device=None) -> P2CState:
        """An empty table on `device` (default: the card)."""
        device = table_mod.resolve_device(device)
        b, s = self.num_buckets, self.slots
        return P2CState(keys=torch.full((b, s), u64.EMPTY, dtype=torch.int64, device=device),
                        values=torch.zeros((b * s, self.dim), dtype=torch.float32, device=device))

    def _buckets(self, keys: torch.Tensor):
        h1, h2 = u64.hash_pair(keys)
        return u64.bucket_from_hash(h1, self.num_buckets), u64.bucket_from_hash(h2, self.num_buckets)

    def _match(self, state: P2CState, bucket: torch.Tensor, keys: torch.Tensor):
        hit = state.keys[bucket] == keys[:, None]
        return hit.any(dim=1), hit.to(torch.uint8).argmax(dim=1)

    def _locate(self, state: P2CState, keys: torch.Tensor):
        """(hit in bucket 1, found, row) over both candidate buckets."""
        valid = keys != u64.EMPTY
        b1, b2 = self._buckets(keys)
        h1, s1 = self._match(state, b1, keys)
        h2, s2 = self._match(state, b2, keys)
        row = torch.where(h1, b1 * self.slots + s1, b2 * self.slots + s2)
        return h1, (h1 | h2) & valid, row

    def insert(self, state: P2CState, keys: torch.Tensor, values: Any) -> InsertReport:
        """Update the keys present (two bucket loads), then place the
        misses by load-based two choice, rank-resolved within the batch.
        Placement runs in rounds, so keys bounced from an overfull round-1
        target retry against the refreshed occupancy, emulating the
        sequential CAS race the GPU baselines run."""
        s, nb = self.slots, self.num_buckets
        dev = keys.device
        values = _rows(values, dev)
        valid = keys != u64.EMPTY
        b1, b2 = self._buckets(keys)
        _h1, hit, row = self._locate(state, keys)
        upd = hit & merge_mod.last_writer_mask(keys)
        state.values[row[upd]] = values[upd]
        miss0 = valid & ~hit
        pending = miss0.clone()
        rounds, progress = 0, True
        while rounds < _P2C_ROUNDS and progress:
            act = torch.nonzero(pending)[:, 0]
            if not act.numel():
                break
            occ = (state.keys != u64.EMPTY).sum(dim=1)
            ab1, ab2 = b1[act], b2[act]
            target = torch.where(occ[ab2] < occ[ab1], ab2, ab1)
            order = torch.argsort(target, stable=True)
            tb = target[order]
            m = tb.numel()
            iota = torch.arange(m, device=dev)
            is_new = torch.ones(m, dtype=torch.bool, device=dev)
            is_new[1:] = tb[1:] != tb[:-1]
            rank = iota - torch.cummax(torch.where(is_new, iota, -1), dim=0).values
            free_slot = occ[tb] + rank
            ok = free_slot < s
            wl, wb, ws = act[order][ok], tb[ok], free_slot[ok]
            state.keys[wb, ws] = keys[wl]
            state.values[wb * s + ws] = values[wl]
            pending[wl] = False
            progress = bool(ok.any())
            rounds += 1
        ok = hit | (miss0 & ~pending)
        probes = torch.where(valid, 2 + miss0.to(torch.int32), 0).to(torch.int32)
        return InsertReport(state=state, ok=ok, probes=probes)

    def find(self, state: P2CState, keys: torch.Tensor) -> FindReport:
        valid = keys != u64.EMPTY
        h1, found, row = self._locate(state, keys)
        # structural cost: two bucket loads (b1 then b2) unless b1 hits
        probes = (torch.where(h1, 1, 2) * valid).to(torch.int32)
        vals = torch.where(found[:, None], state.values[row.clamp(0, self.capacity - 1)], 0.0)
        return FindReport(values=vals, found=found, probes=probes)

    def assign(self, state: P2CState, keys: torch.Tensor, values: Any) -> P2CState:
        """Write values of existing keys in place; misses are no-ops."""
        _h1, found, row = self._locate(state, keys)
        w = found & merge_mod.last_writer_mask(keys)
        state.values[row[w]] = _rows(values, keys.device)[w]
        return state

    def _compact(self, state: P2CState) -> P2CState:
        """Stable per-bucket compaction: live slots first, order kept; it
        restores the invariant `insert` relies on (a new entry lands at the
        slot index equal to the bucket's occupancy)."""
        b, s = self.num_buckets, self.slots
        order = torch.argsort((state.keys == u64.EMPTY).to(torch.uint8), dim=1, stable=True)
        rows = (torch.arange(b, device=order.device)[:, None] * s + order).reshape(-1)
        state.keys.copy_(torch.take_along_dim(state.keys, order, dim=1))
        state.values.copy_(state.values[rows])
        return state

    def erase(self, state: P2CState, keys: torch.Tensor) -> P2CState:
        """Remove found keys, then pack every bucket densely again (the
        invariant a sequential CAS table keeps by swapping with the last
        live slot)."""
        _h1, found, row = self._locate(state, keys)
        state.keys.view(-1)[row[found]] = u64.EMPTY
        state.values[row[found]] = 0.0
        return self._compact(state)

    # -- maintenance sweeps (predicate over keys; no score metadata) -----------

    def sweep_mask(self, state: P2CState, pred) -> torch.Tensor:
        """bool [B, S]: live slots matching `pred` (a zero score plane)."""
        k = state.keys
        return pred.matches(k, torch.zeros_like(k)) & (k != u64.EMPTY)

    def erase_mask(self, state: P2CState, mask: torch.Tensor) -> P2CState:
        """Bulk erase by [B, S] mask, then pack every bucket."""
        state.keys.masked_fill_(mask, u64.EMPTY)
        state.values.masked_fill_(mask.reshape(-1)[:, None], 0.0)
        return self._compact(state)

    def rank_rows(self, state: P2CState, mask: torch.Tensor, budget: int):
        return _rank_rows_flat(state.keys.reshape(-1), mask.reshape(-1), budget)


# =============================================================================
# The KVTable-protocol handle over either baseline (repro_torch.core.api.KVTable)
# =============================================================================


class DictUpsert(NamedTuple):
    table: "DictKVTable"
    ok: torch.Tensor        # bool [N]: placement success (dictionary semantics)
    probes: torch.Tensor    # int32 [N]


class DictFindOrInsert(NamedTuple):
    table: "DictKVTable"
    values: torch.Tensor    # [N, dim]: stored row on a hit, the init row otherwise
    found: torch.Tensor     # bool [N]: key existed before the op
    ok: torch.Tensor        # bool [N]: key present after the op
    probes: torch.Tensor    # int32 [N]


class DictSweep(NamedTuple):
    table: "DictKVTable"
    swept: torch.Tensor     # int64 []: entries removed


class DictEvictIf(NamedTuple):
    table: "DictKVTable"
    evicted: EvictionStream  # rank-aligned; scores zero (no metadata)
    count: torch.Tensor     # int64 []


@dataclasses.dataclass(frozen=True)
class DictKVTable:
    """A baseline's state bound to its implementation: the `KVTable`
    protocol of ``repro_torch.HKVTable``, so one harness drives HKV and the
    dictionary-semantic baselines.  The capability gap the paper measures
    shows through `.ok`: at capacity these tables FAIL inserts where HKV
    evicts in place.  Ops change the state in place; an op's `.table` is
    this handle.

        t = DictKVTable.bucketed_p2c(capacity=2**20, dim=32, device="cpu")
        r = t.insert_or_assign(keys, values)     # r.ok, r.probes
        f = t.find(keys)                         # f.values, f.found, f.probes
    """

    state: Any               # OAState | P2CState
    impl: Any                # OpenAddressingTable | BucketedP2CTable

    # -- construction ----------------------------------------------------------

    @classmethod
    def open_addressing(cls, capacity: int, dim: int, *, device=None, **kw) -> "DictKVTable":
        impl = OpenAddressingTable(capacity=capacity, dim=dim, **kw)
        return cls(state=impl.create(device), impl=impl)

    @classmethod
    def bucketed_p2c(cls, capacity: int, dim: int, *, device=None, **kw) -> "DictKVTable":
        impl = BucketedP2CTable(capacity=capacity, dim=dim, **kw)
        return cls(state=impl.create(device), impl=impl)

    def with_state(self, state) -> "DictKVTable":
        return dataclasses.replace(self, state=state)

    # -- views -----------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.impl.capacity

    @property
    def dim(self) -> int:
        return self.impl.dim

    @property
    def device(self) -> torch.device:
        return self.state.keys.device

    def keys(self, keys: Any) -> torch.Tensor:
        """The normalization point (``normalize_keys`` onto the table's device)."""
        return normalize_keys(keys, self.device)

    # -- KVTable protocol ------------------------------------------------------

    def find(self, keys: Any) -> FindReport:
        return self.impl.find(self.state, self.keys(keys))

    def insert_or_assign(self, keys: Any, values: Any) -> DictUpsert:
        """Dedupe at the handle (the batch's last writer wins), as HKV's
        closure does: the batched claim emulations would otherwise place a
        key repeated in the batch twice."""
        k = self.keys(keys)
        d = merge_mod.dedupe_keys(k)
        rep = self.impl.insert(self.state, d.unique, _rows(values, self.device)[d.last_index])
        return DictUpsert(table=self, ok=rep.ok[d.inverse] & (k != u64.EMPTY),
                          probes=rep.probes[d.inverse])

    def find_or_insert(self, keys: Any, init_values: Any) -> DictFindOrInsert:
        """Lookup; insert `init_values` for missing keys (no admission
        control: dictionary semantics; a full table FAILS the insert and
        `ok` is False where the key is absent afterwards)."""
        k = self.keys(keys)
        d = merge_mod.dedupe_keys(k)
        f = self.impl.find(self.state, d.unique)
        init_u = _rows(init_values, self.device)[d.last_index]
        miss = ~f.found & (d.unique != u64.EMPTY)
        rep = self.impl.insert(self.state, torch.where(miss, d.unique, u64.EMPTY), init_u)
        vals_u = torch.where(f.found[:, None], f.values, init_u)
        valid = k != u64.EMPTY
        return DictFindOrInsert(
            table=self, values=vals_u[d.inverse], found=f.found[d.inverse] & valid,
            ok=(f.found | rep.ok)[d.inverse] & valid,
            # one chain scan a key (the insert's probe pass walks the slots
            # this find already scanned)
            probes=f.probes[d.inverse])

    def assign(self, keys: Any, values: Any) -> "DictKVTable":
        """Updater: write values of existing keys; misses are no-ops."""
        d = merge_mod.dedupe_keys(self.keys(keys))
        self.impl.assign(self.state, d.unique, _rows(values, self.device)[d.last_index])
        return self

    def erase(self, keys: Any) -> "DictKVTable":
        self.impl.erase(self.state, self.keys(keys))
        return self

    def clear(self) -> "DictKVTable":
        self.state.keys.fill_(u64.EMPTY)
        self.state.values.zero_()
        return self

    def contains(self, keys: Any) -> torch.Tensor:
        return self.find(keys).found

    # -- maintenance (the KVTable sweep surface) ---------------------------------
    #
    # Dictionary tables carry no score metadata: predicates see zero score
    # planes (key predicates work unchanged), and evict_if's "coldest
    # first" order is ascending key.

    def erase_if(self, pred) -> DictSweep:
        m = self.impl.sweep_mask(self.state, pred)
        swept = m.sum()
        self.impl.erase_mask(self.state, m)
        return DictSweep(table=self, swept=swept)

    def evict_if(self, pred, budget: int) -> DictEvictIf:
        c = self.capacity
        if budget < 1:
            raise ValueError(f"budget must be >= 1; got {budget}")
        budget = min(budget, c)
        m = self.impl.sweep_mask(self.state, pred)
        rows, lane = self.impl.rank_rows(self.state, m, budget)
        keys_f = self.state.keys.reshape(-1)
        vals = self.state.values[torch.where(lane, rows, 0)]
        z = torch.zeros(budget, dtype=torch.int64, device=self.device)
        stream = EvictionStream(keys=torch.where(lane, keys_f[rows], 0),
                                values=torch.where(lane[:, None], vals, torch.zeros_like(vals)),
                                scores=z, mask=lane)
        em = torch.zeros(c, dtype=torch.bool, device=self.device)
        em[rows[lane]] = True
        self.impl.erase_mask(self.state, em.reshape(m.shape))
        return DictEvictIf(table=self, evicted=stream, count=lane.sum())

    def _live(self) -> torch.Tensor:
        k = self.state.keys
        return (k != u64.EMPTY) & ~_is_tomb(k)

    def stats(self):
        """`TableStats` over the export view's buckets (no scores: the
        quantiles report zero)."""
        from repro_torch.maintenance import stats as stats_mod  # maintenance sits above core

        keys = self.state.keys.reshape(-1)
        w = self.impl.slots if isinstance(self.impl, BucketedP2CTable) else _OA_EXPORT_SLOTS
        pad = (-keys.numel()) % w
        if pad:
            keys = torch.cat([keys, torch.full((pad,), u64.EMPTY, dtype=torch.int64,
                                               device=keys.device)])
        k2 = keys.reshape(-1, w)
        return stats_mod.stats_from_planes(k2, live=(k2 != u64.EMPTY) & ~_is_tomb(k2))

    def size(self) -> int:
        return int(self._live().sum())

    def load_factor(self) -> float:
        return self.size() / self.capacity

    # -- export (checkpoint and publisher path) ----------------------------------

    @property
    def num_buckets(self) -> int:
        """Export-view bucket count (open addressing: 128-slot chunks of the
        flat array; P2C: its own 16-slot buckets)."""
        if isinstance(self.impl, BucketedP2CTable):
            return self.impl.num_buckets
        return -(-self.capacity // _OA_EXPORT_SLOTS)

    def export_batch(self, bucket_start: int, bucket_count: int) -> ExportResult:
        """A copy of a contiguous bucket range (no scores: zeros)."""
        w = self.impl.slots if isinstance(self.impl, BucketedP2CTable) else _OA_EXPORT_SLOTS
        sl = slice(bucket_start * w, (bucket_start + bucket_count) * w)
        keys = self.state.keys.reshape(-1)[sl].clone()
        return ExportResult(keys=keys, values=self.state.values[sl].clone(),
                            scores=torch.zeros_like(keys),
                            mask=(keys != u64.EMPTY) & ~_is_tomb(keys))
