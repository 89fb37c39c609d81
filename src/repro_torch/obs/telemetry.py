"""Op telemetry: typed counters for the core op families (the port's copy
of ``repro/obs/telemetry.py``).

The paper's headline claims are observability claims: find throughput
stable across load factors 0.50-1.00 (under 5% variation), and a full
bucket resolved in place by eviction or rejection instead of a failed
insert.  This module computes the counters that check them, on the
device of the table, as a pure observer over the same probe and match
formulas the ops use (``find.probe_keys`` and the digest/key match of
``find.match_lanes``), so the plain path and the kernels report equal
numbers by construction.

Wiring contract (held in ``tests/test_torch_telemetry.py``):

  * every role-annotated op of ``repro_torch.core.ops`` takes an optional
    keyword-only ``telemetry=`` argument, or is listed in
    ``core.ops.TELEMETRY_EXEMPT`` with its reason;
  * ``telemetry=None`` (the default) is the code path without
    telemetry: this module is not even imported, and no launch is added;
  * ``telemetry=sink`` records one `OpTelemetry` per op call into the
    sink; results stay bit-identical, as the observer never feeds back,
    and it launches no kernel (plain tensor math on the planes).

The port's tables change in place, so an observer cannot read the pre-op
state after the op as the reference does.  The probe part of an
inserter's record (`probe_counters`: lanes, probed buckets and slots,
digest passes, second probes) is taken before the op's first write, and
its status histogram (`observe_upsert`) after.  A keyed erase counts its
hits before it writes.  Updaters move no key, so their probe part is the
same before and after.

Counter semantics (int64 scalars on the table's device; the reference's
are int32, which wraps where a sink sums past 2**31 probed slots, as a
few finds of 2**20 keys at 128 slots do):

  lanes            valid (non-EMPTY) key lanes in the batch
  hits / misses    keys found resident / not (pre-op state for inserters)
  probed_buckets   bucket rows FETCHED by the batch implementation: both
                   candidate rows in dual-bucket mode (1 + [bucket2 !=
                   bucket1] per valid lane), one in single
  probed_slots     probed_buckets x slots_per_bucket
  digest_pass      occupied probed slots passing the 8-bit digest
                   prefilter (the slots that go on to a full 64-bit
                   compare; about hits + 1/256 false positives)
  second_probe     valid lanes whose bucket-1 row did NOT resolve them:
                   the second fetch a sequential implementation would pay
                   (dual-bucket mode only)
  updated/inserted/evicted/rejected
                   the upsert status histogram: in-place update, insert
                   into a free slot, insert by eviction, admission
                   rejection
  swept            entries removed by a predicated sweep or an erase
  promoted/demoted/dropped
                   tier motion (cold->hot promotion, hot->cold demotion,
                   pairs lost at the cold boundary), recorded by the tier
                   hierarchy (``core/tiered.py``)

``psum_telemetry`` sums the shard-local records of a sharded op into one
whole-mesh record (the reference's sum across the mesh's axes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import u64
from repro_torch.core.merge import (STATUS_EVICTED, STATUS_INSERTED, STATUS_REJECTED,
                                    STATUS_UPDATED)
from repro_torch.core.table import HKVConfig, HKVState

_COUNTERS = (
    "lanes", "hits", "misses",
    "probed_buckets", "probed_slots", "digest_pass", "second_probe",
    "updated", "inserted", "evicted", "rejected", "swept",
    "promoted", "demoted", "dropped",
)

# Lanes a probe-counter pass gathers rows for at once.  It gathers each
# lane's 128-byte digest row and the keys of the digest-matching slots
# only: 128 MiB a row pass at 2**20 lanes.  Without the digest filter it
# gathers whole key rows (1 KiB a lane), 2**16 lanes at a time.
CHUNK = 2**20
KEY_CHUNK = 2**16


def _i64(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64).reshape(())
    return torch.tensor(int(v), dtype=torch.int64)


class OpTelemetry(NamedTuple):
    """One op call's counters (int64 scalar tensors on the device that
    computed them)."""

    lanes: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    probed_buckets: torch.Tensor
    probed_slots: torch.Tensor
    digest_pass: torch.Tensor
    second_probe: torch.Tensor
    updated: torch.Tensor
    inserted: torch.Tensor
    evicted: torch.Tensor
    rejected: torch.Tensor
    swept: torch.Tensor
    promoted: torch.Tensor
    demoted: torch.Tensor
    dropped: torch.Tensor

    @classmethod
    def zero(cls) -> "OpTelemetry":
        return cls(*[_i64(0) for _ in _COUNTERS])

    @classmethod
    def of(cls, **counters) -> "OpTelemetry":
        """Build from a subset of named counters (the rest zero)."""
        return cls(**{name: _i64(counters.get(name, 0)) for name in _COUNTERS})

    def merge(self, other: "OpTelemetry") -> "OpTelemetry":
        return OpTelemetry(*[a + b for a, b in zip(self, other)])

    def to_dict(self) -> dict:
        """Host-side {counter: int} (waits for the device values)."""
        return {name: int(v) for name, v in zip(_COUNTERS, self)}

    def rates(self) -> dict:
        """Host-side derived rates (the claim-anchoring numbers):

          probes_per_query    probed_buckets / lanes: exp1's meta_rows
                              term, the λ-stability claim's flat curve
          digest_pass_rate    digest_pass / probed_slots: the prefilter's
                              full-compare escape fraction
          second_probe_rate   second_probe / lanes: dual-bucket serial
                              probe demand
          hit_rate            hits / lanes
        """
        d = self.to_dict()
        lanes = max(d["lanes"], 1)
        return {
            "probes_per_query": d["probed_buckets"] / lanes,
            "digest_pass_rate": d["digest_pass"] / max(d["probed_slots"], 1),
            "second_probe_rate": d["second_probe"] / lanes,
            "hit_rate": d["hits"] / lanes,
        }


class TelemetrySink:
    """Accumulates `OpTelemetry` records keyed by op name.  The records
    stay on the device until `snapshot()` or `to_dict()` reads them."""

    def __init__(self):
        self.by_op: dict[str, OpTelemetry] = {}
        self.calls: dict[str, int] = {}

    def record(self, op: str, tel: OpTelemetry) -> None:
        prev = self.by_op.get(op)
        self.by_op[op] = tel if prev is None else prev.merge(tel)
        self.calls[op] = self.calls.get(op, 0) + 1

    def total(self) -> OpTelemetry:
        tel = OpTelemetry.zero()
        for t in self.by_op.values():
            tel = tel.merge(t)
        return tel

    def snapshot(self) -> dict:
        """Host-side {op: {counter: int}}."""
        return {op: t.to_dict() for op, t in sorted(self.by_op.items())}

    def __bool__(self) -> bool:  # a sink with no records is still a sink
        return True


# =============================================================================
# Observers: plain counter math over (pre-op planes, keys, op outputs)
# =============================================================================


def _row_pass(state: HKVState, cfg: HKVConfig, bucket: torch.Tensor, q: torch.Tensor,
              qd: torch.Tensor, lanes: torch.Tensor):
    """Over rows `bucket` of the lanes in `lanes`: (the occupied slots
    whose digest equals the lane's, bool [n]: the lane's key is in its row
    by the op's match formula).  Only the digest-matching slots' keys are
    gathered, unless the table runs without the digest filter."""
    cand = (state.digests[bucket] == qd[:, None]) & lanes[:, None]
    i, j = torch.nonzero(cand, as_tuple=True)
    kc = state.keys[bucket[i], j]
    passed = (~u64.empty_lanes(kc)).sum()
    if cfg.use_digest:
        hit = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        hit[i[find_mod.match_lanes(kc, q[i])]] = True
    else:
        hit = find_mod.match_lanes(state.keys[bucket], q[:, None]).any(dim=1)
    return passed, hit


def probe_counters(state: HKVState, cfg: HKVConfig, keys: torch.Tensor) -> dict:
    """The probe-side counters every keyed op family shares, from the
    formulas the ops use (``probe_keys`` and the digest/key match).  Call
    it before the op's first write: it reads the key and digest planes.

    `probed_buckets` counts the bucket rows the batch implementation
    fetches (both candidate rows in dual mode: flat across λ);
    `second_probe` counts the lanes bucket 1 did not resolve.  The digest
    rows are gathered `CHUNK` lanes at a time, and keys only where a digest
    matched (whole key rows, `KEY_CHUNK` lanes at a time, without the
    digest filter); the counters are integer sums, so the chunking is
    exact."""
    probe = find_mod.probe_keys(cfg, keys)
    dual = cfg.buckets_per_key == 2
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    digest_pass, second = zero, zero
    chunk = CHUNK if cfg.use_digest else KEY_CHUNK
    for start in range(0, keys.shape[0], chunk):
        sl = slice(start, start + chunk)
        q, qd, valid = keys[sl], probe.digest[sl], probe.valid[sl]
        b1 = probe.bucket1[sl]
        passed, hit1 = _row_pass(state, cfg, b1, q, qd, valid)
        digest_pass = digest_pass + passed
        if dual:
            second = second + (valid & ~hit1).sum()
            b2 = probe.bucket2[sl]
            passed, _ = _row_pass(state, cfg, b2, q, qd, valid & (b2 != b1))
            digest_pass = digest_pass + passed
    n_valid = probe.valid.sum()
    if dual:
        probed = n_valid + (probe.valid & (probe.bucket2 != probe.bucket1)).sum()
    else:
        probed = n_valid
    return {
        "lanes": n_valid,
        "probed_buckets": probed,
        "probed_slots": probed * cfg.slots_per_bucket,
        "digest_pass": digest_pass,
        "second_probe": second,
    }


def _hits(keys: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    return (found & ~u64.empty_lanes(keys)).sum()


def _with_hits(state, cfg, keys, found) -> dict:
    c = probe_counters(state, cfg, keys)
    c["hits"] = _hits(keys, found)
    c["misses"] = c["lanes"] - c["hits"]
    return c


def observe_find(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                 found: torch.Tensor) -> OpTelemetry:
    """Reader-family observer (find / find_ptr / find_rows / contains)."""
    return OpTelemetry.of(**_with_hits(state, cfg, keys, found))


def observe_update(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                   found: torch.Tensor) -> OpTelemetry:
    """Updater-family observer (assign*, update_rows): a resident lane's
    row or score write counts as `updated`."""
    c = _with_hits(state, cfg, keys, found)
    c["updated"] = c["hits"]
    return OpTelemetry.of(**c)


def observe_upsert(probe: dict, keys: torch.Tensor, status: torch.Tensor,
                   found: Optional[torch.Tensor] = None) -> OpTelemetry:
    """Inserter-family observer: `probe`, the `probe_counters` taken
    before the op's first write, plus the merge-status histogram (the
    eviction-vs-rejection split the paper's cache-semantics claim rides
    on).  `found` (when the op reports it, as find_or_insert does)
    overrides the hit count; otherwise a hit is an in-place update."""
    c = dict(probe)
    updated = (status == STATUS_UPDATED).sum()
    c["hits"] = updated if found is None else _hits(keys, found)
    c["misses"] = c["lanes"] - c["hits"]
    c["updated"] = updated
    c["inserted"] = (status == STATUS_INSERTED).sum()
    c["evicted"] = (status == STATUS_EVICTED).sum()
    c["rejected"] = (status == STATUS_REJECTED).sum()
    return OpTelemetry.of(**c)


def observe_erase(state: HKVState, cfg: HKVConfig, keys: torch.Tensor,
                  found: torch.Tensor) -> OpTelemetry:
    """Keyed-erase observer, before the erase writes: each resident key
    removed counts as swept."""
    c = _with_hits(state, cfg, keys, found)
    c["swept"] = c["hits"]
    return OpTelemetry.of(**c)


def observe_sweep(cfg: HKVConfig, swept) -> OpTelemetry:
    """Predicated whole-table sweep (erase_if): every slot is scanned, so
    probed_slots reports the full table pass, not a per-key probe."""
    return OpTelemetry.of(probed_buckets=cfg.num_buckets, probed_slots=cfg.capacity,
                          swept=swept)


def observe_evict_if(cfg: HKVConfig, count) -> OpTelemetry:
    """Budgeted coldest-first eviction sweep."""
    return OpTelemetry.of(probed_buckets=cfg.num_buckets, probed_slots=cfg.capacity,
                          evicted=count, swept=count)


def tier_motion(promoted=0, demoted=0, dropped=0) -> OpTelemetry:
    """Tier-hierarchy motion record (``core/tiered.py`` folds its result
    counters in through this)."""
    return OpTelemetry.of(promoted=promoted, demoted=demoted, dropped=dropped)


def psum_telemetry(records, device: Optional[torch.device] = None) -> OpTelemetry:
    """One whole-mesh record: the shard-local records summed counter by
    counter (the reference's ``psum`` over every mesh axis), on `device`
    (default: the first record's)."""
    records = list(records)
    if device is None:
        device = records[0].lanes.device if records else torch.device("cpu")
    tel = OpTelemetry(*[v.to(device) for v in OpTelemetry.zero()])
    for r in records:
        tel = tel.merge(OpTelemetry(*[v.to(device) for v in r]))
    return tel
