"""Sequential Python oracle of the HKV contract (Algorithms 1–3): the
port's copy of ``repro/core/oracle.py``, numpy only.

A slow, obviously-correct host implementation used by property tests to
validate the batch-synchronous closure (`core/merge.py`).  It applies
the paper's per-key algorithms one key at a time, in the *canonical batch
order* the closure is defined against (DESIGN.md §2):

  1. dedupe the batch (last value wins, multiplicities counted);
  2. apply all hit-updates;
  3. apply misses bucket-by-bucket in descending incoming-score order
     (ties: ascending key), with existing-wins-ties admission.

Under that order the sequential outcome equals the top-S union merge, which
is what `merge.upsert` computes vectorially.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.u64 import EMPTY_KEY as EMPTY, hash_pair_np


@dataclasses.dataclass
class OracleEntry:
    key: int
    score: int
    value: np.ndarray


class OracleTable:
    """Dict-of-buckets cache-semantic table with exact HKV hashing."""

    def __init__(self, capacity: int, dim: int, slots_per_bucket: int = 128,
                 buckets_per_key: int = 1, policy: str = "lru"):
        assert capacity % slots_per_bucket == 0
        self.num_buckets = capacity // slots_per_bucket
        self.slots = slots_per_bucket
        self.dual = buckets_per_key == 2
        self.policy = policy
        self.dim = dim
        self.buckets: List[Dict[int, OracleEntry]] = [dict() for _ in range(self.num_buckets)]
        self.clock = 0
        self.epoch = 0

    # -- routing (must match core/u64.py's hash_pair exactly) ----------------

    def route(self, key: int) -> Tuple[int, int]:
        h1, h2 = hash_pair_np(np.asarray([key], np.uint64))
        nb = self.num_buckets
        if nb & (nb - 1) == 0:
            b1, b2 = int(h1[0]) & (nb - 1), int(h2[0]) & (nb - 1)
        else:
            b1, b2 = int(h1[0]) % nb, int(h2[0]) % nb
        return b1, (b2 if self.dual else b1)

    def locate(self, key: int) -> Optional[int]:
        b1, b2 = self.route(key)
        if key in self.buckets[b1]:
            return b1
        if self.dual and key in self.buckets[b2]:
            return b2
        return None

    # -- scoring --------------------------------------------------------------

    def init_score(self, count: int, custom: Optional[int]) -> int:
        if self.policy == "lru":
            return self.clock
        if self.policy == "lfu":
            return count
        if self.policy == "epoch_lru":
            return (self.epoch << 32) | (self.clock & 0xFFFFFFFF)
        if self.policy == "epoch_lfu":
            return (self.epoch << 32) | (count & 0xFFFFFFFF)
        assert custom is not None
        return custom

    def update_score(self, old: int, count: int, custom: Optional[int]) -> int:
        if self.policy == "lru":
            return self.clock
        if self.policy == "lfu":
            return (old + count) & 0xFFFFFFFFFFFFFFFF
        if self.policy == "epoch_lru":
            return (self.epoch << 32) | (self.clock & 0xFFFFFFFF)
        if self.policy == "epoch_lfu":
            if (old >> 32) != self.epoch:
                return (self.epoch << 32) | (count & 0xFFFFFFFF)
            lo = ((old & 0xFFFFFFFF) + count) & 0xFFFFFFFF
            return (self.epoch << 32) | lo
        assert custom is not None
        return custom

    # -- batch ops (canonical order) -------------------------------------------

    def _dedupe(self, keys, values, customs):
        """last-writer-wins values + multiplicities, preserving first-seen order."""
        seen = {}
        for i, k in enumerate(keys):
            k = int(k)
            if k == int(EMPTY):
                continue
            if k not in seen:
                seen[k] = [0, i]
            seen[k][0] += 1
            seen[k][1] = i
        out = []
        for k, (count, last) in seen.items():
            out.append(
                (
                    k,
                    count,
                    None if values is None else np.array(values[last]),
                    None if customs is None else int(customs[last]),
                )
            )
        return out

    def insert_or_assign(self, keys, values, customs=None, write_hit_values=True):
        """Batch upsert in canonical order. Returns status per input position."""
        self.clock += 1
        entries = self._dedupe(keys, values, customs)
        status = {}
        # phase 1: hits
        misses = []
        for k, count, val, cust in entries:
            b = self.locate(k)
            if b is not None:
                e = self.buckets[b][k]
                e.score = self.update_score(e.score, count, cust)
                if write_hit_values:
                    e.value = val
                status[k] = 1
            else:
                misses.append((k, count, val, cust))
        # phase 2: misses, per-bucket descending score then ascending key
        scored = []
        for k, count, val, cust in misses:
            b1, b2 = self.route(k)
            s = self.init_score(count, cust)
            # dual-bucket two-phase selection against *current* state
            if self.dual:
                o1, o2 = len(self.buckets[b1]), len(self.buckets[b2])
                if o1 < self.slots or o2 < self.slots:
                    tb = b2 if o2 < o1 else b1
                else:
                    m1 = min(e.score for e in self.buckets[b1].values())
                    m2 = min(e.score for e in self.buckets[b2].values())
                    tb = b2 if m2 < m1 else b1
            else:
                tb = b1
            scored.append((tb, s, k, count, val))
        scored.sort(key=lambda t: (t[0], -t[1], t[2]))
        for tb, s, k, count, val in scored:
            bucket = self.buckets[tb]
            if len(bucket) < self.slots:
                bucket[k] = OracleEntry(k, s, val)
                status[k] = 2
                continue
            victim = min(bucket.values(), key=lambda e: (e.score, e.key))
            if s > victim.score:  # existing wins ties (batch-closure contract)
                del bucket[victim.key]
                bucket[k] = OracleEntry(k, s, val)
                status[k] = 3
            else:
                status[k] = 4
        return [status.get(int(k), 0) for k in keys]

    def find_or_insert(self, keys, init_values, customs=None):
        st = self.insert_or_assign(keys, init_values, customs, write_hit_values=False)
        vals = []
        for i, k in enumerate(keys):
            b = self.locate(int(k))
            if b is not None:
                vals.append(np.array(self.buckets[b][int(k)].value))
            else:
                vals.append(np.array(init_values[i]))
        return st, np.stack(vals) if vals else np.zeros((0, self.dim))

    def accum_or_assign(self, keys, values, customs=None):
        """Mirrors `ops.accum_or_assign` (the one-shot gradient upsert):
        within-batch duplicates of a key are pre-SUMMED; one += applies on
        hit — with the score updated at count=1, because the engine's
        phase-2 upsert sees the deduped batch — and misses insert the sum,
        admission-controlled in canonical order."""
        self.clock += 1
        sums: Dict[int, list] = {}
        for i, k in enumerate(keys):
            k = int(k)
            if k == int(EMPTY):
                continue
            if k not in sums:
                sums[k] = [np.zeros_like(np.asarray(values[i], np.float64)), None]
            sums[k][0] = sums[k][0] + np.asarray(values[i], np.float64)
            sums[k][1] = None if customs is None else int(customs[i])
        status = {}
        misses = []
        for k, (vsum, cust) in sums.items():
            b = self.locate(k)
            if b is not None:
                e = self.buckets[b][k]
                e.value = (np.asarray(e.value, np.float64) + vsum).astype(
                    np.asarray(e.value).dtype)
                e.score = self.update_score(e.score, 1, cust)
                status[k] = 1
            else:
                misses.append((k, vsum, cust))
        scored = []
        for k, vsum, cust in misses:
            b1, b2 = self.route(k)
            s = self.init_score(1, cust)
            if self.dual:
                o1, o2 = len(self.buckets[b1]), len(self.buckets[b2])
                if o1 < self.slots or o2 < self.slots:
                    tb = b2 if o2 < o1 else b1
                else:
                    m1 = min(e.score for e in self.buckets[b1].values())
                    m2 = min(e.score for e in self.buckets[b2].values())
                    tb = b2 if m2 < m1 else b1
            else:
                tb = b1
            scored.append((tb, s, k, vsum))
        scored.sort(key=lambda t: (t[0], -t[1], t[2]))
        for tb, s, k, vsum in scored:
            bucket = self.buckets[tb]
            if len(bucket) < self.slots:
                bucket[k] = OracleEntry(k, s, vsum.astype(np.float32))
                status[k] = 2
                continue
            victim = min(bucket.values(), key=lambda e: (e.score, e.key))
            if s > victim.score:
                del bucket[victim.key]
                bucket[k] = OracleEntry(k, s, vsum.astype(np.float32))
                status[k] = 3
            else:
                status[k] = 4
        return [status.get(int(k), 0) for k in keys]

    def find(self, keys):
        found, vals = [], []
        for k in keys:
            b = self.locate(int(k))
            if b is None:
                found.append(False)
                vals.append(np.zeros(self.dim, np.float32))
            else:
                found.append(True)
                vals.append(np.array(self.buckets[b][int(k)].value[: self.dim]))
        return np.array(found), np.stack(vals) if vals else np.zeros((0, self.dim))

    def assign(self, keys, values):
        for i, k in enumerate(keys):
            b = self.locate(int(k))
            if b is not None:
                self.buckets[b][int(k)].value = np.array(values[i])

    def contains(self, keys):
        return np.array([self.locate(int(k)) is not None for k in keys])

    # -- predicated sweeps (mirror core/predicates.py `match_planes`) ----------

    @staticmethod
    def _pred_match(kind: str, key: int, score: int, a: int, b: int) -> bool:
        if kind == "always":
            return True
        if kind == "score_lt":
            return score < a
        if kind == "score_ge":
            return score >= a
        if kind == "epoch_lt":
            return (score >> 32) < (a >> 32)
        if kind == "key_range":
            return a <= key < b
        raise ValueError(kind)

    def erase_if(self, kind: str, a: int = 0, b: int = 0) -> int:
        """Remove every entry matching the predicate; returns the count."""
        removed = 0
        for bucket in self.buckets:
            for k in [k for k, e in bucket.items()
                      if self._pred_match(kind, k, e.score, a, b)]:
                del bucket[k]
                removed += 1
        return removed

    def evict_if(self, kind: str, budget: int, a: int = 0, b: int = 0):
        """Remove up to `budget` matching entries, coldest first (ascending
        score then key — the engine's deterministic sweep order); returns
        them as a list of (key, score, value) in eviction rank order."""
        cands = []
        for bi, bucket in enumerate(self.buckets):
            for k, e in bucket.items():
                if self._pred_match(kind, k, e.score, a, b):
                    cands.append((e.score, k, bi))
        cands.sort()
        out = []
        for score, k, bi in cands[:budget]:
            e = self.buckets[bi].pop(k)
            out.append((k, score, np.array(e.value)))
        return out

    def erase(self, keys):
        for k in keys:
            b = self.locate(int(k))
            if b is not None:
                del self.buckets[b][int(k)]

    def clear(self):
        """Drop every entry; the clock/epoch survive (the table contract)."""
        self.buckets = [dict() for _ in range(self.num_buckets)]

    def size(self) -> int:
        return sum(len(b) for b in self.buckets)

    def items(self):
        for b in self.buckets:
            for k, e in b.items():
                yield k, e

    def load_factor(self) -> float:
        return self.size() / (self.num_buckets * self.slots)
