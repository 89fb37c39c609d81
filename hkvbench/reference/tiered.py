"""The plain reference of the tier hierarchy that `HKVEmbedding(hot_capacity=...)`
trains through (the port's `TieredHKVTable`), for the cell `tiered.train_zipf`.

Two tables of the contract in `table.py`, sharing the row width:

  hot   an LRU table (`RefTable`'s semantics) whose batched upsert also
        hands back its eviction stream: each displaced key with its full
        row and its score;
  cold  a 'custom'-score table: each pair comes with its admission score.
        A hit takes the pair's score (and row); the missing keys of a
        target bucket, by score descending then key ascending, pair with
        its slots in victim order, and the r-th takes the r-th slot if that
        slot is free or its score is strictly below the pair's.

`lookup_train` of a batch, in this order:
  1. the hot locate of the batch's distinct keys;
  2. the cold probe of the distinct hot misses, with full-width rows;
  3. each key's admission row: its cold row where the cold tier holds it,
     else its init row (a zero optimizer column);
  4. the hot find_or_insert of the batch with those rows (a hit keeps its
     row, every key touched or admitted gets the hot clock);
  5. the demotion into the cold tier of the hot eviction stream and of the
     keys the hot tier rejected that the cold tier did not hold, the
     latter with their admission rows and the hot tier's clock of this
     batch as their score;
  6. the readback: the hot row of every key resident in the hot tier
     after the op, the admission row of the rest.
`ingest` (the prefill) is steps 1-5.  `apply_grads` trains the keys
resident in the hot tier only, as `embedding.apply_grads` does a flat table.

Counted, per batch: promoted (cold hits admitted into the hot tier),
demoted (pairs the cold tier placed: updated, inserted or evicting) and
dropped (pairs it rejected plus the pairs its own evictions pushed out of
the hierarchy), and the work the roofline needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hkvbench.reference.embedding import default_rows, keys_of
from hkvbench.reference.table import (
    EMPTY,
    EVICTED,
    INSERTED,
    REJECTED,
    UPDATED,
    RefTable,
    flip,
    pad,
)


class Admit(NamedTuple):
    status: torch.Tensor       # int8 [N]
    present: torch.Tensor      # bool [N] present after the op
    row: torch.Tensor          # int64 [N] value row after the op (0 where absent)
    evicted_keys: torch.Tensor     # int64 [E] the keys the op displaced
    evicted_rows: torch.Tensor     # float32 [E, width] their full rows
    evicted_scores: torch.Tensor   # int64 [E] their scores
    counts: dict


class Tier(RefTable):
    """One tier: `RefTable`'s planes and probes, with an upsert that takes
    'custom' admission scores and returns the displaced entries."""

    def __init__(self, capacity: int, width: int, buckets_per_key: int,
                 device: torch.device, score_policy: str):
        if score_policy not in ("lru", "custom"):
            raise ValueError(f"a tier of the hierarchy's reference scores by 'lru' or "
                             f"'custom', not {score_policy!r}: another policy needs a "
                             f"reference of its own, a new file in hkvbench/reference/")
        super().__init__(capacity, width, buckets_per_key, device)
        self.custom = score_policy == "custom"

    def admit(self, keys: torch.Tensor, rows: torch.Tensor, scores: torch.Tensor | None = None,
              write_hits: bool = True) -> Admit:
        """Upsert `keys` [N] with `rows` [N, width] (a group takes its last
        lane's row and, under 'custom', its last lane's score)."""
        n, s = keys.numel(), self.slots
        dev = keys.device
        self.clock += 1
        if self.custom:
            live = scores[keys != EMPTY]
            if live.numel() and (int(live.min()) < 0 or int(live.max()) >= 2**31):
                raise ValueError("the reference's score word holds scores in [0, 2^31)")
        uf, inv = torch.unique(flip(keys), return_inverse=True)
        uk = flip(uf)                                    # distinct keys, unsigned ascending
        u = uk.numel()
        last = torch.full((u,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, inv, torch.arange(n, device=dev), "amax")
        score_u = scores[last] if self.custom else torch.full((u,), self.clock, device=dev)
        valid = uk != EMPTY
        found, found1, bucket, slot = self.locate(uk)
        hb, hs = bucket[found], slot[found]
        self.scores[hb, hs] = score_u[found]
        if write_hits:
            self.values[hb * s + hs] = rows[last[found]]

        miss = valid & ~found
        mi = miss.nonzero()[:, 0]                       # ascending key order
        mi = mi[torch.argsort(flip(score_u[mi]), descending=True, stable=True)]
        b1, b2, dg = self.probe(uk[mi])
        target = self._target(b1, b2)
        perm = torch.argsort(target, stable=True)       # by target, score desc, key asc
        mi, tb, dg, sc = mi[perm], target[perm], dg[perm], score_u[mi][perm]
        m = mi.numel()
        first = torch.ones(m, dtype=torch.bool, device=dev)
        first[1:] = tb[1:] != tb[:-1]
        run = torch.cumsum(first, 0) - 1
        start = first.nonzero()[:, 0]
        rank = torch.arange(m, device=dev) - start[run]
        order, rk, rs = self._victims(tb[first])
        vslot = order[run, rank.clamp(max=s - 1)]
        vkey = rk[run, vslot]
        vlive = vkey != EMPTY
        vscore = rs[run, vslot]
        admit = (rank < s) & (~vlive | (flip(vscore) < flip(sc)))
        evicts = admit & vlive
        ev_keys, ev_scores = vkey[evicts], vscore[evicts]
        ev_rows = self.values[tb[evicts] * s + vslot[evicts]]      # before they are overwritten
        ab, aslot, ai = tb[admit], vslot[admit], mi[admit]
        self.keys[ab, aslot] = uk[ai]
        self.digests[ab, aslot] = dg[admit].to(torch.uint8)
        self.scores[ab, aslot] = sc[admit]
        self.values[ab * s + aslot] = rows[last[ai]]

        status_u = torch.zeros(u, dtype=torch.int8, device=dev)
        status_u[found] = UPDATED
        status_u[mi] = torch.where(admit, torch.where(vlive, EVICTED, INSERTED),
                                   REJECTED).to(torch.int8)
        # a hit whose slot an admitted pair took in the same batch ('custom':
        # its new score may be the bucket's lowest) is present no more
        present = found & (self.keys[bucket, slot] == uk)
        present[ai] = True
        row_u = torch.where(present, bucket * s + slot, 0)
        row_u[ai] = ab * s + aslot
        counts = {"lanes": n, "distinct": int(valid.sum()), "hits": int(found.sum()),
                  "hits_primary": int(found1.sum()), "admitted": int(admit.sum()),
                  "evicted": int(evicts.sum()),
                  "miss_rows": int(torch.unique(torch.cat([b1, b2])).numel()) if m else 0}
        return Admit(status=status_u[inv], present=present[inv], row=row_u[inv],
                     evicted_keys=ev_keys, evicted_rows=ev_rows, evicted_scores=ev_scores,
                     counts=counts)


class RefHierarchy:
    """A hot LRU tier of `hot_capacity` slots over a 'custom'-score cold
    tier of `capacity` slots, both of float32 rows of `width` columns."""

    def __init__(self, hot_capacity: int, capacity: int, width: int, buckets_per_key: int,
                 device: torch.device, score_policy: str = "lru",
                 cold_score_policy: str = "custom", value_dtype: str = "float32"):
        if (score_policy, cold_score_policy) != ("lru", "custom"):
            raise ValueError(f"the hierarchy's reference models an 'lru' hot tier over a "
                             f"'custom' cold tier, not {score_policy!r} over "
                             f"{cold_score_policy!r}: another pair needs a reference of its "
                             f"own, a new file in hkvbench/reference/")
        if value_dtype != "float32":
            raise ValueError(f"the hierarchy's reference holds float32 rows, not {value_dtype}: "
                             f"another type needs a reference that rounds as it does, a new "
                             f"file in hkvbench/reference/")
        self.hot = Tier(hot_capacity, width, buckets_per_key, device, score_policy)
        self.cold = Tier(capacity, width, buckets_per_key, device, cold_score_policy)

    def find_or_insert(self, keys: torch.Tensor, init: torch.Tensor):
        """(rows [N, dim] of the readback, the batch's counts) for keys [N]
        and their init rows [N, dim]."""
        hot, cold = self.hot, self.cold
        dim = init.shape[1]
        uf, inv = torch.unique(flip(keys), return_inverse=True)
        uk = flip(uf)
        valid = uk != EMPTY
        in_hot = hot.locate(uk)[0]
        probed = valid & ~in_hot
        q = uk[probed]
        c_found, c_found1, c_bucket, c_slot = cold.locate(q)
        cold_hit = torch.zeros_like(valid)
        cold_hit[probed] = c_found
        last = torch.full_like(uk, -1).scatter_reduce_(
            0, inv, torch.arange(keys.numel(), device=keys.device), "amax")
        admit_u = pad(init[last], hot.values.shape[1])
        admit_u[cold_hit] = cold.values[(c_bucket * cold.slots + c_slot)[c_found]]
        rows = admit_u[inv]
        res = hot.admit(keys, rows, write_hits=False)

        status_u = torch.zeros_like(uk, dtype=torch.int8)
        status_u[inv] = res.status
        rejected = valid & (status_u == REJECTED) & ~cold_hit
        down_keys = torch.cat([res.evicted_keys, uk[rejected]])
        down_rows = torch.cat([res.evicted_rows, admit_u[rejected]])
        down_scores = torch.cat([res.evicted_scores,
                                 torch.full((int(rejected.sum()),), hot.clock, device=uk.device)])
        dem = cold.admit(down_keys, down_rows, down_scores, write_hits=True)
        handed = down_keys.numel()
        refused = int((dem.status == REJECTED).sum())
        promoted = int((cold_hit & ((status_u == INSERTED) | (status_u == EVICTED))).sum())

        readback = torch.where(res.present[:, None], hot.values[res.row, :dim], rows[:, :dim])
        lanes_valid = keys != EMPTY
        counts = dict(res.counts)
        counts.update(
            valid_lanes=int(lanes_valid.sum()),
            hot_hit_lanes=int(in_hot[inv][lanes_valid].sum()),
            cold_hit_lanes=int(cold_hit[inv][lanes_valid].sum()),
            cold_probed=int(probed.sum()), cold_hits=int(c_found.sum()),
            cold_hits_primary=int(c_found1.sum()),
            rejected_cold_hits=int((valid & (status_u == REJECTED) & cold_hit).sum()),
            promoted=promoted, handed=handed, demoted=handed - refused,
            cold_rejected=refused, cold_evicted=dem.counts["evicted"],
            dropped=refused + dem.counts["evicted"],
            demote_hits=dem.counts["hits"], demote_hits_primary=dem.counts["hits_primary"],
            demote_admitted=dem.counts["admitted"], demote_miss_rows=dem.counts["miss_rows"])
        return readback, counts

    def free(self) -> None:
        self.hot.free()
        self.cold.free()


def ingest(ref: RefHierarchy, tokens: torch.Tensor, dim: int) -> dict:
    keys = keys_of(tokens)
    return ref.find_or_insert(keys, default_rows(keys, dim))[1]


def lookup_train(ref: RefHierarchy, tokens: torch.Tensor, dim: int):
    """(rows [N, dim], the batch's counts)."""
    keys = keys_of(tokens)
    return ref.find_or_insert(keys, default_rows(keys, dim))
