"""The plain reference of the table semantics that the benchmark's cells drive.

A straightforward, vectorised PyTorch implementation of the HKV contract
(paper §3.1-§3.4, Algorithms 1-3) for the LRU score policy, written for
speed on the card and for reading, not for generality.  It imports
nothing of the program: the hash, the bucket choice, the victim order and
the statuses are worked out here again from the keys and rows that the
benchmark generated.

The table: B buckets of S = 128 slots; per slot a 64-bit key (the
all-ones word marks a free slot), an 8-bit digest and a 64-bit score;
value row b*S + s belongs to slot (b, s).  64-bit words are held as
int64 bit patterns and compared in unsigned order through `flip`.

One batched upsert (``upsert``):
  1. the batch clock advances by one; every key it touches or admits
     gets the clock as its score (LRU);
  2. duplicate keys form one group; its last lane's row is the group's;
  3. keys present (the digest and the full key match in the primary
     bucket, else in the secondary) are hits: score touched, row written
     unless the op keeps hit rows;
  4. each missing key picks a target: the bucket with fewer live slots
     while either has a free one, else the one whose least score is
     lower; ties go to the primary;
  5. per target bucket the missing keys, in ascending key order, pair
     with the bucket's slots in victim order (free first, then score,
     key and slot ascending): the r-th key takes the r-th slot if that
     slot is free or its score is strictly lower than the clock;
  6. status per lane: 1 updated, 2 inserted, 3 evicted, 4 rejected, 0
     for padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = -1                     # the all-ones key as an int64
EMPTY_DIGEST = 0xFF
SIGN = -(2**63)
INT64_MAX = 2**63 - 1
M32 = 0xFFFFFFFF
UPDATED, INSERTED, EVICTED, REJECTED = 1, 2, 3, 4


def flip(x: torch.Tensor) -> torch.Tensor:
    """Unsigned order of int64 bit patterns as signed order."""
    return x ^ SIGN


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3's 32-bit finalizer on int64 holding 32 bits (a product may
    wrap the int64 range; the low 32 bits kept are exact)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def hash_pair(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two 32-bit hashes of 64-bit keys: h1 gives the primary bucket
    and the digest (its bits 31:24), h2 the secondary bucket."""
    hi, lo = (keys >> 32) & M32, keys & M32
    a = fmix32(hi ^ 0x9E3779B9)
    b = fmix32(lo ^ 0x7FEB352D)
    return fmix32(a ^ lo), fmix32(b ^ hi ^ 0x9E3779B9)


class Upsert(NamedTuple):
    status: torch.Tensor       # int8 [N]
    present: torch.Tensor      # bool [N] present after the op
    row: torch.Tensor          # int64 [N] value row after the op (0 where absent)
    counts: dict               # the batch's work, for the roofline


class RefTable:
    """Planes as the contract defines them, on `device`."""

    def __init__(self, capacity: int, width: int, buckets_per_key: int,
                 device: torch.device, slots: int = 128, score_policy: str = "lru",
                 value_dtype: str = "float32"):
        if capacity % slots or buckets_per_key not in (1, 2):
            raise ValueError("capacity must be whole buckets; 1 or 2 buckets a key")
        if score_policy != "lru":
            raise ValueError(f"the reference models the 'lru' score policy only, not "
                             f"{score_policy!r}: a configuration with it needs a reference "
                             f"of its own, a new file in hkvbench/reference/")
        if value_dtype != "float32":
            raise ValueError(f"the reference holds float32 value planes, not {value_dtype}: "
                             f"a configuration with them needs a reference that rounds as "
                             f"they do, a new file in hkvbench/reference/")
        self.slots, self.nb, self.dual = slots, capacity // slots, buckets_per_key == 2
        self.keys = torch.full((self.nb, slots), EMPTY, dtype=torch.int64, device=device)
        self.digests = torch.full((self.nb, slots), EMPTY_DIGEST, dtype=torch.uint8,
                                  device=device)
        self.scores = torch.zeros((self.nb, slots), dtype=torch.int64, device=device)
        self.values = torch.zeros((capacity, width), dtype=torch.float32, device=device)
        self.clock = 0

    # -- probing ---------------------------------------------------------------

    def _bucket(self, h: torch.Tensor) -> torch.Tensor:
        return h % self.nb

    def probe(self, keys: torch.Tensor):
        h1, h2 = hash_pair(keys)
        b1 = self._bucket(h1)
        return b1, (self._bucket(h2) if self.dual else b1), (h1 >> 24) & 0xFF

    def _match(self, keys, bucket, digest):
        m = (self.keys[bucket] == keys[:, None]) & (self.digests[bucket] == digest[:, None])
        return m.any(dim=1), m.to(torch.uint8).argmax(dim=1)

    def locate(self, keys: torch.Tensor):
        """(found, found in the primary bucket, bucket, slot) of distinct
        keys; a miss reports its primary bucket and slot 0."""
        b1, b2, dg = self.probe(keys)
        valid = keys != EMPTY
        hit1, slot1 = self._match(keys, b1, dg)
        hit1 &= valid
        if not self.dual:
            return hit1, hit1, b1, torch.where(hit1, slot1, 0)
        hit2, slot2 = self._match(keys, b2, dg)
        hit2 &= valid & ~hit1
        return (hit1 | hit2, hit1, torch.where(hit2, b2, b1),
                torch.where(hit1, slot1, torch.where(hit2, slot2, 0)))

    # -- the batched upsert -----------------------------------------------------

    def _target(self, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
        if not self.dual:
            return b1

        def stats(k, s):
            live = k != EMPTY
            return live.sum(dim=1), torch.where(live, flip(s), INT64_MAX).min(dim=1).values

        if 2 * b1.numel() > self.nb:            # many misses: every bucket's stats once
            count, least = stats(self.keys, self.scores)
            n1, least1, n2, least2 = count[b1], least[b1], count[b2], least[b2]
        else:
            n1, least1 = stats(self.keys[b1], self.scores[b1])
            n2, least2 = stats(self.keys[b2], self.scores[b2])
        free = (n1 < self.slots) | (n2 < self.slots)
        return torch.where(torch.where(free, n2 < n1, least2 < least1), b2, b1)

    def _victims(self, buckets: torch.Tensor):
        """Each row's slots in victim order: free first, then score, key
        and slot ascending (a stable sort by key, then by score).  Live
        LRU scores are clocks from 1 below 2^31, so the score pass sorts
        int32 words in which a free slot's -1 comes first."""
        k, s = self.keys[buckets], self.scores[buckets]
        if self.clock >= 2**31:
            raise ValueError("the reference's score word holds clocks below 2^31")
        order = torch.argsort(flip(k), dim=1, stable=True)
        word = torch.where(k != EMPTY, s, -1).to(torch.int32).gather(1, order)
        return order.gather(1, torch.argsort(word, dim=1, stable=True)), k, s

    def upsert(self, keys: torch.Tensor, rows: torch.Tensor, write_hits: bool = True) -> Upsert:
        """Insert or assign `keys` [N] with `rows` [N, width] (a group takes
        its last lane's row); with `write_hits` False a hit keeps its row
        (find_or_insert and ingest)."""
        n, s = keys.numel(), self.slots
        dev = keys.device
        self.clock += 1
        clock = self.clock
        uf, inv = torch.unique(flip(keys), return_inverse=True)
        uk = flip(uf)                                    # distinct keys, unsigned ascending
        u = uk.numel()
        last = torch.full((u,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, inv, torch.arange(n, device=dev), "amax")
        valid = uk != EMPTY
        found, found1, bucket, slot = self.locate(uk)
        hb, hs = bucket[found], slot[found]
        self.scores[hb, hs] = clock
        if write_hits:
            self.values[hb * s + hs] = rows[last[found]]

        miss = valid & ~found
        mi = miss.nonzero()[:, 0]                       # ascending key order
        b1, b2, dg = self.probe(uk[mi])
        target = self._target(b1, b2)
        perm = torch.argsort(target, stable=True)       # by target, then key
        mi, tb, dg = mi[perm], target[perm], dg[perm]
        m = mi.numel()
        first = torch.ones(m, dtype=torch.bool, device=dev)
        first[1:] = tb[1:] != tb[:-1]
        run = torch.cumsum(first, 0) - 1
        start = first.nonzero()[:, 0]
        rank = torch.arange(m, device=dev) - start[run]
        order, rk, rs = self._victims(tb[first])
        vslot = order[run, rank.clamp(max=s - 1)]
        vlive = rk[run, vslot] != EMPTY
        vscore = rs[run, vslot]
        admit = (rank < s) & (~vlive | (flip(vscore) < flip(torch.full_like(vscore, clock))))
        ab, aslot, ai = tb[admit], vslot[admit], mi[admit]
        self.keys[ab, aslot] = uk[ai]
        self.digests[ab, aslot] = dg[admit].to(torch.uint8)
        self.scores[ab, aslot] = clock
        self.values[ab * s + aslot] = rows[last[ai]]

        status_u = torch.zeros(u, dtype=torch.int8, device=dev)
        status_u[found] = UPDATED
        status_u[mi] = torch.where(admit, torch.where(vlive, EVICTED, INSERTED),
                                   REJECTED).to(torch.int8)
        present = found.clone()
        present[ai] = True
        row_u = torch.where(found, bucket * s + slot, 0)
        row_u[ai] = ab * s + aslot
        counts = {"lanes": n, "distinct": int(valid.sum()), "hits": int(found.sum()),
                  "hits_primary": int(found1.sum()), "admitted": int(admit.sum()),
                  "miss_rows": int(torch.unique(torch.cat([b1, b2])).numel()) if m else 0}
        return Upsert(status=status_u[inv], present=present[inv], row=row_u[inv], counts=counts)

    # -- readers and the gradient step ------------------------------------------

    def find(self, keys: torch.Tensor, dim: int):
        """(found, rows [N, dim], scores, counts): rows and scores are 0 on a
        miss; the table does not change."""
        found, found1, bucket, slot = self.locate(keys)
        rows = torch.where(found[:, None], self.values[bucket * self.slots + slot, :dim], 0.0)
        scores = torch.where(found, self.scores[bucket, slot], 0)
        counts = {"lanes": keys.numel(), "hits": int(found.sum()),
                  "hits_primary": int(found1.sum())}
        return found, rows, scores, counts

    def free(self) -> None:
        del self.keys, self.digests, self.scores, self.values


def readback(table: RefTable, res: Upsert, init: torch.Tensor, dim: int) -> torch.Tensor:
    """find_or_insert's rows: the stored row of a key present after the
    op, the caller's init row where it was rejected."""
    return torch.where(res.present[:, None], table.values[res.row, :dim], init[:, :dim])


def pad(rows: torch.Tensor, width: int) -> torch.Tensor:
    """Rows zero-padded to the plane's width (the optimizer's columns)."""
    return torch.cat([rows.float(), rows.new_zeros((rows.shape[0], width - rows.shape[1]),
                                                   dtype=torch.float32)], dim=1)

