"""TieredHKVTable: tiered key-value separation (§3.6) grown into a two-tier
cache hierarchy (the port of ``repro/core/tiered.py``).

Two full HKV tables behind the `KVTable` protocol:

  hot tier   a small, fast table whose value plane stays in HBM;
  cold tier  a larger table whose value plane uses the 'hmem' placement
             (``HKVConfig.value_tier``): pinned host memory on the card.

Two data motions, both riding the typed `EvictionStream`:

  DEMOTION    every hot-tier structural op runs as `insert_and_evict`;
              its displaced (key, value, score) pairs, plus incoming
              pairs the hot tier REJECTED, upsert into the cold tier with
              scores translated across the per-tier policies
              (`translate_scores`).  Nothing leaves the hierarchy except
              at the cold tier's own admission and eviction boundary, and
              those losses are counted (`.dropped`).
  PROMOTION   hot-tier find misses probe the cold tier; cold hits are
              re-admitted into the hot tier (full-width rows, so the aux
              optimizer columns travel with the embedding), and the hot
              entries they displace cascade back down the same way.  The
              hot tier is an inclusive-on-access cache: a promoted key
              keeps its cold copy, freshened by write-back when the hot
              copy is demoted; reads prefer the hot copy.

As everywhere in the port, the tiers' states change in place: an op's
result carries `.table`, the same hierarchy (`with_tiers` builds another
handle on the given tiers).  Caller keys are normalized once, and the
tiers' ops then run through the op engine (``core.ops``) on the
normalized keys.

Tracing (``repro_torch.obs.trace``): find_or_insert (and so ingest),
insert_or_assign and find each open a ``tier.<name>`` op span, the parent
of the tiers' own op spans, with the stages

  tier.hot_probe   find_or_insert's one hot locate (`find_ptr`)
  tier.cold_probe  the cold tier's `find_rows` of the hot misses
  tier.displaced   the demotion batch: `_dedupe_lanes` and `_displaced`
  tier.demote      the cold tier's `insert_and_evict` of that batch

and, while tracing is live, the counters ``lanes`` (valid key lanes),
``hot_hits`` and ``cold_hits`` (lanes found in that tier before the op;
insert_or_assign probes no cold tier: its hot hits are its in-place
updates, its cold hits 0), ``promoted``, ``demoted`` and ``dropped`` (the
op's own counts): at most four small launches, no host read.  Off, every
span is the shared no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core import u64
from repro_torch.core.api import HKVTable, OpSession
from repro_torch.core.merge import EvictionStream
from repro_torch.core.scores import ScorePolicy
from repro_torch.core.table import HKVConfig, HKVState
from repro_torch.obs.trace import op_span, span


# =============================================================================
# Score translation across per-tier policies
# =============================================================================


def translate_scores(src: ScorePolicy, dst: ScorePolicy,
                     scores: torch.Tensor) -> Optional[torch.Tensor]:
    """Scores of the source tier's policy as admission scores of the
    destination tier.

    * dst 'custom': the source scores pass through.  Every policy's scores
      are unsigned 64-bit words evicted in ascending order, so the
      source's relative hot/coldness carries over unchanged.  This is the
      default cold-tier policy: demoted pairs compete in the cold tier by
      the score that got them evicted.
    * any other dst: None; the destination stamps its own score at
      admission (per-tier clocks are independent, so a foreign clock value
      would corrupt the destination's order).
    """
    if dst.is_custom:
        return scores
    return None


# =============================================================================
# State and result types
# =============================================================================


class TieredState(NamedTuple):
    """Both tiers' states."""

    hot: HKVState
    cold: HKVState


class TieredFind(NamedTuple):
    table: "TieredHKVTable"
    values: torch.Tensor      # [N, dim]: zeros where neither tier holds the key
    found: torch.Tensor       # bool [N]: present in EITHER tier
    hot_hit: torch.Tensor     # bool [N]: served from the hot tier
    promoted: torch.Tensor    # int64 []: cold hits re-admitted into hot
    demoted: torch.Tensor     # int64 []: hot victims cascaded into cold
    dropped: torch.Tensor     # int64 []: UPPER BOUND on pairs that left the
                              #   hierarchy: cold rejections + cold evictions
                              #   (an evicted cold copy may be an inclusive
                              #   duplicate whose hot copy lives on)


class TieredUpsert(NamedTuple):
    table: "TieredHKVTable"
    status: torch.Tensor      # int8 [N]: the hot tier's status codes
    demoted: torch.Tensor     # int64 []: pairs handed down to the cold tier
    dropped: torch.Tensor     # int64 []: upper bound on hierarchy exits
    # bool [N]: the key is present SOMEWHERE after the op: admitted by the
    # hot tier, or hot-rejected and placed by the cold tier
    ok: torch.Tensor


class TieredFindOrInsert(NamedTuple):
    table: "TieredHKVTable"
    values: torch.Tensor      # [N, dim]: stored row (either tier) or init
    found: torch.Tensor       # bool [N]: existed in EITHER tier before the op
    status: torch.Tensor      # int8 [N]: the hot tier's status codes
    promoted: torch.Tensor
    demoted: torch.Tensor
    dropped: torch.Tensor
    ok: torch.Tensor          # bool [N]: resident SOMEWHERE after the op


class _DemoteResult(NamedTuple):
    demoted: torch.Tensor     # int64 []: pairs upserted into the cold tier
    dropped: torch.Tensor     # int64 []: pairs lost at the cold boundary
    placed: torch.Tensor      # bool [N]: the lane's pair is now cold-resident


class TieredDemote(NamedTuple):
    table: "TieredHKVTable"
    demoted: torch.Tensor
    dropped: torch.Tensor


class TieredSweep(NamedTuple):
    table: "TieredHKVTable"
    swept: torch.Tensor       # int64 []: entries removed across BOTH tiers
                              #   (inclusive copies count twice)


class TieredEvictIf(NamedTuple):
    table: "TieredHKVTable"
    evicted: EvictionStream   # 2 * budget lanes: the hot stream, then the
                              #   cold one with stale inclusive copies masked
    count: torch.Tensor       # int64 []: live lanes in the stream


# =============================================================================
# The handle
# =============================================================================


@dataclasses.dataclass(frozen=True)
class TieredHKVTable:
    """The two-tier hierarchy behind the same handle discipline as
    `HKVTable`.

        table = TieredHKVTable.create(hot_capacity=8 * 128,
                                      cold_capacity=64 * 128, dim=32)
        res = table.insert_or_assign(keys, values)   # res.status, res.demoted
        out = table.find(keys)                       # promotes cold hits

    `promote_on_find=False` makes `find` a pure reader (no re-admission);
    the default promotes, which makes the hot tier follow the accesses.
    """

    hot: HKVTable
    cold: HKVTable
    promote_on_find: bool = True

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, *, hot_capacity: int, cold_capacity: int, dim: int,
               score_policy: str = "lru", cold_score_policy: str = "custom",
               cold_value_tier: str = "hmem", promote_on_find: bool = True,
               backend: str = "auto", device=None, **shared_cfg) -> "TieredHKVTable":
        """Allocate both tiers.  The value-row geometry (dim, aux columns,
        dtype, slots per bucket) is shared, so rows move between tiers as
        they are; capacities and score policies are per tier.  The cold
        tier defaults to 'custom' scores (demoted pairs keep their
        translated hot scores) and to the 'hmem' placement."""
        hot_cfg = HKVConfig(capacity=hot_capacity, dim=dim, score_policy=score_policy,
                            **shared_cfg)
        cold_cfg = HKVConfig(capacity=cold_capacity, dim=dim, score_policy=cold_score_policy,
                             value_tier=cold_value_tier, **shared_cfg)
        return cls.from_configs(hot_cfg, cold_cfg, promote_on_find=promote_on_find,
                                backend=backend, device=device)

    @classmethod
    def from_configs(cls, hot_cfg: HKVConfig, cold_cfg: HKVConfig, *,
                     promote_on_find: bool = True, backend: str = "auto",
                     device=None) -> "TieredHKVTable":
        if hot_cfg.total_value_dim != cold_cfg.total_value_dim or (
                hot_cfg.value_dtype != cold_cfg.value_dtype):
            raise ValueError(
                "hot/cold tiers must share value-row geometry; got "
                f"{hot_cfg.total_value_dim}x{hot_cfg.value_dtype} vs "
                f"{cold_cfg.total_value_dim}x{cold_cfg.value_dtype}")
        return cls(hot=HKVTable.create(hot_cfg, device=device, backend=backend),
                   cold=HKVTable.create(cold_cfg, device=device, backend=backend),
                   promote_on_find=promote_on_find)

    @classmethod
    def wrap(cls, state: TieredState, hot_cfg: HKVConfig, cold_cfg: HKVConfig, *,
             promote_on_find: bool = True, backend: str = "auto") -> "TieredHKVTable":
        """Bind existing tier states (no copy)."""
        return cls(hot=HKVTable.wrap(state.hot, hot_cfg, backend=backend),
                   cold=HKVTable.wrap(state.cold, cold_cfg, backend=backend),
                   promote_on_find=promote_on_find)

    # -- views ---------------------------------------------------------------

    @property
    def state(self) -> TieredState:
        return TieredState(hot=self.hot.state, cold=self.cold.state)

    def with_state(self, state: TieredState) -> "TieredHKVTable":
        return dataclasses.replace(self, hot=self.hot.with_state(state.hot),
                                   cold=self.cold.with_state(state.cold))

    def with_tiers(self, hot: HKVTable, cold: HKVTable) -> "TieredHKVTable":
        return dataclasses.replace(self, hot=hot, cold=cold)

    def snapshot(self) -> "TieredHKVTable":
        """An independent copy of both tiers."""
        return self.with_tiers(self.hot.snapshot(), self.cold.snapshot())

    @property
    def device(self) -> torch.device:
        return self.hot.device

    @property
    def backend(self) -> str:
        return self.hot.backend

    @property
    def capacity(self) -> int:
        return self.hot.capacity + self.cold.capacity

    @property
    def hot_fraction(self) -> float:
        return self.hot.capacity / self.capacity

    @property
    def dim(self) -> int:
        return self.hot.dim

    def keys(self, keys: Any) -> torch.Tensor:
        return self.hot.keys(keys)

    # -- readers -------------------------------------------------------------

    def contains(self, keys: Any, *, telemetry=None) -> torch.Tensor:
        """Membership in either tier (never promotes)."""
        k = self.keys(keys)
        in_hot = _contains(self.hot, k, telemetry)
        return in_hot | _contains(self.cold, _mask_keys(k, ~in_hot), telemetry)

    def size(self) -> int:
        """Distinct live keys across the hierarchy: a promoted key's cold
        copy is counted once (the hot key plane is probed against the cold
        tier, a capacity-sized membership scan: a diagnostic op)."""
        hot_keys = self.hot.state.keys.reshape(-1)
        dup = _contains(self.cold, hot_keys) & ~u64.empty_lanes(hot_keys)
        return self.hot.size() + self.cold.size() - int(dup.sum())

    def load_factor(self) -> float:
        return self.size() / self.capacity

    @property
    def num_buckets(self) -> int:
        """Export-space bucket count: hot buckets first, then cold."""
        return self.hot.num_buckets + self.cold.num_buckets

    def export_batch(self, bucket_start: int, bucket_count: int) -> ops_mod.ExportResult:
        """A contiguous range of the CONCATENATED bucket space (hot buckets
        [0, H), cold buckets [H, H + C)).  A cold entry whose key is
        hot-resident is masked out: its copy may be stale."""
        hot_b = self.hot.num_buckets
        end = bucket_start + bucket_count
        parts = []
        if bucket_start < hot_b:
            parts.append(self.hot.export_batch(bucket_start, min(end, hot_b) - bucket_start))
        if end > hot_b:
            c0 = max(bucket_start - hot_b, 0)
            c = self.cold.export_batch(c0, end - hot_b - c0)
            dup = _contains(self.hot, c.keys)
            parts.append(c._replace(mask=c.mask & ~dup))
        if len(parts) == 1:
            return parts[0]
        h, c = parts
        return ops_mod.ExportResult(*[torch.cat([a, b]) for a, b in zip(h, c)])

    # -- the demotion cascade --------------------------------------------------

    def _demote(self, keys: torch.Tensor, values: torch.Tensor, scores: torch.Tensor,
                mask: torch.Tensor) -> _DemoteResult:
        """Upsert displaced pairs into the cold tier; count what it keeps
        and what leaves the hierarchy at its boundary.  Lanes off `mask`
        go in as EMPTY, which every op ignores."""
        cold = self.cold
        with span("tier.demote"):
            cs = translate_scores(self.hot.cfg.policy, cold.cfg.policy, scores)
            res = ops_mod.insert_and_evict(cold.state, cold.cfg, _mask_keys(keys, mask), values,
                                           custom_scores=cs, backend=cold.backend)
            placed = mask & (res.status != ops_mod.STATUS_REJECTED)
            # losses at the cold boundary: rejected demotions and the cold
            # tier's own evictions (pairs pushed out of the last tier)
            dropped = (mask & ~placed).sum() + res.evicted.count()
            return _DemoteResult(demoted=placed.sum(), dropped=dropped, placed=placed)

    def _demote_stream(self, stream: EvictionStream) -> _DemoteResult:
        return self._demote(stream.keys, stream.values, stream.scores, stream.mask)

    def demote(self, stream: EvictionStream) -> TieredDemote:
        """Hand a stream of (key, value, score) pairs down into the cold
        tier: the public form of the cascade (the maintenance rebalancer
        feeds `evict_if`'s hot-tier stream through here)."""
        dem = self._demote_stream(stream)
        return TieredDemote(table=self, demoted=dem.demoted, dropped=dem.dropped)

    # -- inserters -----------------------------------------------------------

    def insert_or_assign(self, keys: Any, values: Any,
                         custom_scores: Optional[Any] = None, *,
                         telemetry=None) -> TieredUpsert:
        """Upsert into the hot tier; displaced pairs (victims evicted by
        admission AND incoming pairs the hot tier rejected) cascade into
        the cold tier.  `status` is the hot tier's verdict; `.ok` also
        covers hot-rejected pairs the cold tier placed."""
        hot = self.hot
        with op_span("tier.insert_or_assign") as sp:
            k, cs = hot.keys(keys), hot._opt_keys(custom_scores)
            values = ops_mod._pad_aux(hot._rows(values), hot.state)
            res = ops_mod.insert_and_evict(hot.state, hot.cfg, k, values, custom_scores=cs,
                                           backend=hot.backend, telemetry=telemetry)
            with span("tier.displaced"):
                first, rep_orig = _dedupe_lanes(k)
                displaced = self._displaced(k, values, res, rej_custom=cs, first=first)
            dem = self._demote(*displaced)
            if sp:
                _count_motion(sp, k, res.status == ops_mod.STATUS_UPDATED, None, 0,
                              dem.demoted, dem.dropped)
            _record_motion(telemetry, demoted=dem.demoted, dropped=dem.dropped)
            return TieredUpsert(table=self, status=res.status, demoted=dem.demoted,
                                dropped=dem.dropped,
                                ok=_hierarchy_ok(res.status, dem.placed, rep_orig))

    def find_or_insert(self, keys: Any, init_values: Any,
                       custom_scores: Optional[Any] = None, *,
                       telemetry=None) -> TieredFindOrInsert:
        """The training path's op: lookup across the hierarchy, admit the
        misses, promote the cold hits.

        Per key: a hot hit returns its stored hot row (score touched); a
        hot miss that hits cold re-admits the cold row into the hot tier
        (promotion) and returns it; a miss in both admits `init_values`.
        Every hot-tier displacement (victims and rejected incoming pairs
        alike) cascades into the cold tier.  `custom_scores` feeds the hot
        tier's admission, promoted cold hits included."""
        hot, cold = self.hot, self.cold
        with op_span("tier.find_or_insert") as sp:
            k, cs = hot.keys(keys), hot._opt_keys(custom_scores)
            # one hot probe, shared with the upsert closure through its `loc`
            # (a locate depends only on the key plane, which the cold reads
            # below do not touch)
            with span("tier.hot_probe"):
                pre = ops_mod.find_ptr(hot.state, hot.cfg, k, backend=hot.backend)
            hot_pre = pre.found
            # the cold tier is probed for hot misses only, full-width rows so
            # that the aux optimizer columns travel with a promoted embedding
            with span("tier.cold_probe"):
                cold_rows = ops_mod.find_rows(cold.state, cold.cfg, _mask_keys(k, ~hot_pre),
                                              backend=cold.backend)
            cold_hit = cold_rows.found
            init_full = ops_mod._pad_aux(hot._rows(init_values), hot.state)
            admit_rows = torch.where(cold_hit[:, None], cold_rows.rows, init_full)
            res = ops_mod.find_or_insert(hot.state, hot.cfg, k, admit_rows, custom_scores=cs,
                                         backend=hot.backend, return_evicted=True, loc=pre,
                                         telemetry=telemetry)
            # a rejected COLD HIT stays where it is: the pair never left the
            # cold tier, and demoting it again would overwrite its cold score
            # with a fresh count-1 init
            with span("tier.displaced"):
                first, rep_orig = _dedupe_lanes(k)
                displaced = self._displaced(k, admit_rows, res, rej_custom=cs, first=first,
                                            already_cold=cold_hit)
            dem = self._demote(*displaced)
            promoted = (cold_hit & first & (res.status >= ops_mod.STATUS_UPDATED)
                        & (res.status <= ops_mod.STATUS_EVICTED)).sum()
            if sp:
                _count_motion(sp, k, hot_pre, cold_hit, promoted, dem.demoted, dem.dropped)
            _record_motion(telemetry, promoted=promoted, demoted=dem.demoted,
                           dropped=dem.dropped)
            return TieredFindOrInsert(
                table=self, values=res.values, found=hot_pre | cold_hit, status=res.status,
                promoted=promoted, demoted=dem.demoted, dropped=dem.dropped,
                # rejected cold hits never left the cold tier: resident
                ok=(_hierarchy_ok(res.status, dem.placed, rep_orig)
                    | ((res.status == ops_mod.STATUS_REJECTED) & cold_hit)))

    def _displaced(self, k: torch.Tensor, values: torch.Tensor, res,
                   rej_custom: Optional[torch.Tensor] = None,
                   first: Optional[torch.Tensor] = None,
                   already_cold: Optional[torch.Tensor] = None):
        """The eviction stream merged with the hot-REJECTED incoming pairs
        into one lane-aligned demotion batch (keys, values, scores, mask).

        A lane either evicted a victim or was rejected, never both, and a
        rejected key equals no victim key (a hot-resident key would have
        been a hit).  Rejected pairs carry their would-be admission score:
        the caller's score under 'custom', else a fresh hot-policy init
        score at the post-op clock (LFU-family counts collapse to 1, the
        reference's documented approximation).  `already_cold` lanes have
        nothing to hand down."""
        st = res.evicted
        rej = (res.status == ops_mod.STATUS_REJECTED) & ~st.mask
        if already_cold is not None:
            rej &= ~already_cold
        # only each key's first lane demotes (duplicates share one verdict)
        rej &= _dedupe_lanes(k)[0] if first is None else first
        policy = self.hot.cfg.policy
        if policy.is_custom:
            rej_sc = rej_custom
        else:
            hs = self.hot.state
            rej_sc = policy.init_score(hs.clock, hs.epoch, torch.ones_like(k), None)
        keys = torch.where(st.mask, st.keys, k)
        vals = torch.where(st.mask[:, None], st.values, values.to(st.values.dtype))
        scores = torch.where(st.mask, st.scores, rej_sc)
        return keys, vals, scores, st.mask | rej

    def ingest(self, keys: Any, init_values: Any,
               custom_scores: Optional[Any] = None, *, telemetry=None) -> TieredUpsert:
        """Admission without the value readback: the whole hierarchy motion
        of find_or_insert (a cold-resident key must be PROMOTED, not
        shadowed by a fresh init row in the hot tier)."""
        r = self.find_or_insert(keys, init_values, custom_scores=custom_scores,
                                telemetry=telemetry)
        return TieredUpsert(table=self, status=r.status, demoted=r.demoted,
                            dropped=r.dropped, ok=r.ok)

    # -- find with miss-path promotion -------------------------------------------

    def find(self, keys: Any, *, promote: Optional[bool] = None,
             telemetry=None) -> TieredFind:
        """Hierarchy lookup.  Hot misses probe the cold tier; cold hits are
        re-admitted into the hot tier (unless promotion is off), whose
        displaced victims cascade back down.  The values returned are the
        rows before the promotion either way."""
        if promote is None:
            promote = self.promote_on_find
        hot, cold = self.hot, self.cold
        with op_span("tier.find") as sp:
            k = hot.keys(keys)
            h = ops_mod.find(hot.state, hot.cfg, k, backend=hot.backend, telemetry=telemetry)
            with span("tier.cold_probe"):
                cold_rows = ops_mod.find_rows(cold.state, cold.cfg, _mask_keys(k, ~h.found),
                                              backend=cold.backend, telemetry=telemetry)
            cold_hit = cold_rows.found
            values = torch.where(h.found[:, None], h.values,
                                 cold_rows.rows[:, :self.dim].to(h.values.dtype))
            found = h.found | cold_hit
            zero = torch.zeros((), dtype=torch.int64, device=k.device)
            if not promote:
                if sp:
                    _count_motion(sp, k, h.found, cold_hit, zero, zero, zero)
                return TieredFind(table=self, values=values, found=found, hot_hit=h.found,
                                  promoted=zero, demoted=zero, dropped=zero)
            # re-admit the cold hits (first occurrence only), with their cold
            # scores across the policy translation.  Every promoted key is a
            # known hot miss, so the closure gets an all-miss locate
            pk = _mask_keys(k, cold_hit & _dedupe_lanes(k)[0])
            cs = translate_scores(cold.cfg.policy, hot.cfg.policy, cold_rows.scores)
            n = pk.shape[0]
            zeros = torch.zeros(n, dtype=torch.int64, device=k.device)
            all_miss = find_mod.Locate(found=torch.zeros(n, dtype=torch.bool, device=k.device),
                                       bucket=zeros, slot=zeros, row=zeros)
            res = ops_mod.insert_and_evict(hot.state, hot.cfg, pk, cold_rows.rows,
                                           custom_scores=cs, backend=hot.backend, loc=all_miss)
            dem = self._demote_stream(res.evicted)
            promoted = ((res.status == ops_mod.STATUS_INSERTED)
                        | (res.status == ops_mod.STATUS_EVICTED)).sum()
            if sp:
                _count_motion(sp, k, h.found, cold_hit, promoted, dem.demoted, dem.dropped)
            _record_motion(telemetry, promoted=promoted, demoted=dem.demoted,
                           dropped=dem.dropped)
            return TieredFind(table=self, values=values, found=found, hot_hit=h.found,
                              promoted=promoted, demoted=dem.demoted, dropped=dem.dropped)

    # -- updaters and sessions -----------------------------------------------------

    def assign(self, keys: Any, values: Any, update_scores: bool = False) -> "TieredHKVTable":
        """Updater on the HOT tier only: in a promote-on-access hierarchy
        the rows just trained or served are hot, and cold copies refresh by
        write-back on demotion."""
        self.hot.assign(keys, values, update_scores=update_scores)
        return self

    def erase(self, keys: Any, *, telemetry=None) -> "TieredHKVTable":
        """Remove keys from BOTH tiers (or a cold copy would resurrect on
        the next miss)."""
        k = self.keys(keys)
        ops_mod.erase(self.hot.state, self.hot.cfg, k, telemetry=telemetry)
        ops_mod.erase(self.cold.state, self.cold.cfg, k, telemetry=telemetry)
        return self

    def clear(self) -> "TieredHKVTable":
        self.hot.clear()
        self.cold.clear()
        return self

    # -- maintenance -----------------------------------------------------------------

    def erase_if(self, pred, *, telemetry=None) -> TieredSweep:
        """Sweep BOTH tiers (an expired key must not resurrect from its cold
        copy).  TTL expiry works on the default policies: demoted scores
        pass verbatim into the cold tier's 'custom' domain."""
        hr = self.hot.erase_if(pred, telemetry=telemetry)
        cr = self.cold.erase_if(pred, telemetry=telemetry)
        return TieredSweep(table=self, swept=hr.swept + cr.swept)

    def evict_if(self, pred, budget: int, *, telemetry=None) -> TieredEvictIf:
        """Remove up to `budget` matching entries a tier, coldest first, as
        one stream (hot lanes first).  A hot-evicted key's stale cold copy
        is erased with it; a cold lane whose key is still hot-resident has
        its slot freed but is masked out of the stream (the hot copy
        rules, as in `export_batch`)."""
        hot, cold = self.hot, self.cold
        hr = ops_mod.evict_if(hot.state, hot.cfg, pred, budget, backend=hot.backend,
                              telemetry=telemetry)
        cr = ops_mod.evict_if(cold.state, cold.cfg, pred, budget, backend=cold.backend,
                              telemetry=telemetry)
        # hot membership as before the sweep: the hot stream's keys were hot
        dup = _contains(hot, cr.evicted.masked_keys()) | _member(cr.evicted.masked_keys(),
                                                                 hr.evicted.masked_keys())
        cmask = cr.evicted.mask & ~dup
        ops_mod.erase(cold.state, cold.cfg, hr.evicted.masked_keys())
        stream = EvictionStream(*[torch.cat([getattr(hr.evicted, f), getattr(cr.evicted, f)])
                                  for f in ("keys", "values", "scores")],
                                mask=torch.cat([hr.evicted.mask, cmask]))
        return TieredEvictIf(table=self, evicted=stream, count=hr.count + cmask.sum())

    def stats(self):
        """Hierarchy-level `TableStats`: histograms summed, size counting
        inclusive copies once (= `size()`); per tier: `tier_stats()`."""
        from repro_torch.maintenance import stats as stats_mod  # maintenance sits above core

        hot, cold = self.tier_stats()
        return stats_mod.combine_stats(hot, cold, size=self.size())

    def tier_stats(self):
        """(hot TableStats, cold TableStats)."""
        return self.hot.stats(), self.cold.stats()

    @property
    def epoch(self) -> int:
        return self.hot.epoch

    def set_epoch(self, epoch: int) -> "TieredHKVTable":
        """Stamp the application epoch on BOTH tiers (one TTL clock)."""
        self.hot.set_epoch(epoch)
        self.cold.set_epoch(epoch)
        return self

    def session(self) -> "TieredSession":
        """An op session over the HOT tier only (the writable set, see
        `assign`); `commit()` returns this hierarchy.  Session reads are
        hot-scoped: use the table's own `find`/`contains` for
        hierarchy-wide reads."""
        return TieredSession(self)


class TieredSession:
    """An `OpSession` over the hot tier whose `commit()` returns the
    hierarchy."""

    def __init__(self, table: TieredHKVTable):
        self._table = table
        self._inner: OpSession = table.hot.session()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def commit(self) -> TieredHKVTable:
        self._inner.commit()
        return self._table


# =============================================================================
# helpers
# =============================================================================


def _contains(t: HKVTable, keys: torch.Tensor, telemetry=None) -> torch.Tensor:
    """Membership of normalized keys in tier `t`.  Normalized keys go to
    the op engine directly: through a handle, a key at or above 2**63 (a
    negative int64) would be taken for padding."""
    return ops_mod.contains(t.state, t.cfg, keys, backend=t.backend, telemetry=telemetry)


def _count_motion(sp, keys: torch.Tensor, hot_hit: torch.Tensor,
                  cold_hit: Optional[torch.Tensor], promoted, demoted, dropped) -> None:
    """A hierarchy op span's counters (a stack and a sum over the op's
    flags, no host read): valid lanes, hot hits and cold hits (0 where
    the op probes no cold tier); the motion counts are the op's own
    tensors."""
    lanes = (keys != u64.EMPTY, hot_hit) + (() if cold_hit is None else (cold_hit,))
    c = torch.stack(lanes).sum(1)
    sp.count(lanes=(c, 0), hot_hits=(c, 1), cold_hits=0 if cold_hit is None else (c, 2),
             promoted=promoted, demoted=demoted, dropped=dropped)


def _record_motion(telemetry, **motion) -> None:
    """The hierarchy's "tier" record: promoted, demoted, dropped."""
    if telemetry is not None:
        telemetry.record("tier", ops_mod._obs().tier_motion(**motion))


def _mask_keys(keys: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """EMPTY where ~keep (every op ignores those lanes)."""
    return torch.where(keep, keys, u64.EMPTY)


def _member(keys: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """bool [N]: keys[i] is a non-EMPTY key of `pool`."""
    return torch.isin(keys, pool[pool != u64.EMPTY]) & (keys != u64.EMPTY)


def _dedupe_lanes(keys: torch.Tensor):
    """(first, rep_orig): `first[i]` says lane i is its key's first
    occurrence (EMPTY lanes excluded); `rep_orig[i]` is the batch position
    of lane i's group representative."""
    d = merge_mod.dedupe_keys(keys)
    n = keys.shape[0]
    first = torch.zeros(n + 1, dtype=torch.bool, device=keys.device)
    first[torch.where(d.rep_mask, d.idx_sorted, n)] = True
    return first[:n], d.idx_sorted[d.inverse]


def _hierarchy_ok(status: torch.Tensor, placed: torch.Tensor,
                  rep_orig: torch.Tensor) -> torch.Tensor:
    """Per-lane residency after an upsert: admitted by the hot tier, or
    hot-rejected and PLACED by the cold tier (its verdict sits at the
    group representative's lane)."""
    hot_ok = (status >= ops_mod.STATUS_UPDATED) & (status <= ops_mod.STATUS_EVICTED)
    return hot_ok | ((status == ops_mod.STATUS_REJECTED) & placed[rep_orig])
