"""The port's maintenance path (``repro_torch.maintenance``: `rebalance`
and `MaintenanceScheduler`) against the JAX package's, on the scenarios of
``tests/test_maintenance.py`` (rebalance, scheduler, engine integration)
and the scheduler cases of ``tests/test_online_engine.py``.

Every scenario runs once through each package on the same numpy keys made
from a seed; the port's tables live on the CPU.  Held bit for bit:
rebalance's moved and dropped counts, every scheduler report but its host
time (expired, demoted, dropped, table version, applied), the scheduler
totals but time, the engines' wave reports but latency, per-request values
and found flags, and the drained state of both tiers.  The JAX side's cold
tier is 'hbm' where the port's is the default 'hmem' (jax 0.9.0 refuses
the 'hmem' placement on the JAX package's sweep paths on the CPU; no
result depends on it).  One case holds the port's one difference by
design: its tables change in place, so publishing the very table that a
losing maintenance offer changed publishes those changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.maintenance as jmaint  # noqa: E402
import repro.serving as jserve  # noqa: E402
import repro_torch  # noqa: E402
from repro.data import zipf_keys  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import maintenance as pmaint  # noqa: E402
from repro_torch import serving as pserve  # noqa: E402

DIM = 4
PAD = 256                                   # the one prefill batch shape
TIER = dict(hot_capacity=2 * 128, cold_capacity=8 * 128, dim=DIM)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


class Jax:
    serving, maintenance = jserve, jmaint

    def flat(self, **kw):
        return jcore.HKVTable.create(**kw)

    def tiered(self, **kw):
        kw.setdefault("cold_value_tier", "hbm")   # see the module docstring
        return jcore.TieredHKVTable.create(**kw)

    def rows(self, x):
        return jnp.asarray(np.asarray(x, np.float32))

    def states(self, t):
        tiers = [t.hot, t.cold] if hasattr(t, "hot") else [t]
        return [{f: np.asarray(getattr(x.state, f)) for f in convert.FIELDS} for x in tiers]


class Port:
    serving, maintenance = pserve, pmaint

    def flat(self, **kw):
        return repro_torch.HKVTable.create(device="cpu", **kw)

    def tiered(self, **kw):
        return repro_torch.TieredHKVTable.create(device="cpu", **kw)

    def rows(self, x):
        return torch.as_tensor(np.asarray(x, np.float32))

    def states(self, t):
        tiers = [t.hot, t.cold] if hasattr(t, "hot") else [t]
        return [convert.state_to_arrays(x.state) for x in tiers]


JAX, PORT = Jax(), Port()


def both(scenario, *args, **kw):
    return scenario(JAX, *args, **kw), scenario(PORT, *args, **kw)


def same_states(sj, sp, ctx):
    for i, (a, b) in enumerate(zip(sj, sp)):
        for f in convert.FIELDS:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f"{ctx}: tier {i} {f}")


def rows(keys, fill=None):
    base = np.asarray(keys, np.float64) if fill is None else np.full(len(keys), fill)
    return (base[:, None] + np.arange(DIM)[None, :]).astype(np.float32)


def put(pkg, t, keys, vals=None):
    """insert_or_assign padded with EMPTY lanes to one batch shape (one
    JAX compile a table configuration); returns the result."""
    n = len(keys)
    k = np.full(PAD, EMPTY, np.uint64)
    k[:n] = keys
    v = np.zeros((PAD, DIM), np.float32)
    v[:n] = rows(keys) if vals is None else vals
    return t.insert_or_assign(k, pkg.rows(v))


def report_fields(rep):
    return tuple(v for k, v in rep._asdict().items() if k not in ("elapsed_s", "latency_s"))


def totals_fields(tot):
    return tuple(v for k, v in tot._asdict().items() if k != "time_s")


# =============================================================================
# test_maintenance.py::TestRebalance
# =============================================================================


def full_hot(pkg):
    t = pkg.tiered(score_policy="lfu", **TIER)
    ids = np.arange(1, 257, dtype=np.uint64)
    t = put(pkg, t, ids).table                  # hot at λ 1.0
    t = put(pkg, t, ids[128:]).table            # heat half
    return t, ids


@pytest.mark.parametrize("case", ["down_to_low", "noop_below_high", "budget_bound",
                                  "headroom_absorbs_admissions"])
def test_rebalance(case):
    def scenario(pkg):
        if case == "noop_below_high":
            t = put(pkg, pkg.tiered(**TIER), np.arange(1, 101, dtype=np.uint64)).table
            ids = None
        else:
            t, ids = full_hot(pkg)
        pre = (int(t.hot.size()), int(t.cold.size()))
        low, high, budget = (0.25, 0.5, 32) if case == "budget_bound" else (0.5, 0.75, 512)
        r = pkg.maintenance.rebalance(t, low_watermark=low, high_watermark=high, budget=budget)
        got = [int(r.moved), int(r.dropped), pre, int(r.table.hot.size())]
        t = r.table
        if case == "headroom_absorbs_admissions":
            res = put(pkg, t, np.arange(1000, 1100, dtype=np.uint64))
            got.append(int(res.demoted))
            t = res.table
        contains = None if ids is None else np.asarray(t.contains(ids))
        return got, contains, pkg.states(t)

    (gj, cj, sj), (gp, cp, sp) = both(scenario)
    assert gp == gj
    same_states(sj, sp, case)
    moved, dropped, (pre_hot, _pre_cold), hot_after = gp[:4]
    if case == "down_to_low":
        assert moved == pre_hot - 128 and hot_after == 128 and dropped == 0
        assert cp.all()
        np.testing.assert_array_equal(cp, cj)
    elif case == "noop_below_high":
        assert moved == 0 and hot_after == 100
    elif case == "budget_bound":
        assert moved == 32
    else:
        assert gp[4] == 0                       # admissions land in swept slots


def test_rebalance_refuses_bad_watermarks():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.maintenance.rebalance(pkg.tiered(**TIER), low_watermark=0.9, high_watermark=0.5)


# =============================================================================
# test_maintenance.py::TestScheduler
# =============================================================================


def test_scheduler_ttl_expires_after_the_window():
    def scenario(pkg):
        t = put(pkg, pkg.tiered(score_policy="epoch_lru", **TIER),
                np.arange(1, 30, dtype=np.uint64)).table
        sched = pkg.maintenance.MaintenanceScheduler(pkg.maintenance.MaintenancePolicy(
            ttl_epochs=2, advance_epoch=True, sweep_budget=64))
        sizes, reps = [], []
        for _ in range(4):
            t, rep = sched.run(t)
            sizes.append(int(t.size()))
            reps.append(report_fields(rep))
        return sizes, reps, totals_fields(sched.totals), pkg.states(t)

    (zj, rj, tj, sj), (zp, rp, tp, sp) = both(scenario)
    assert (zp, rp, tp) == (zj, rj, tj)
    same_states(sj, sp, "ttl")
    assert zp == [29, 29, 0, 0] and tp[1] == 29          # totals.expired


def test_scheduler_ttl_requires_an_epoch_policy():
    for pkg in (JAX, PORT):
        sched = pkg.maintenance.MaintenanceScheduler(pkg.maintenance.MaintenancePolicy(
            ttl_epochs=1))
        with pytest.raises(ValueError, match="epoch"):
            sched.run(pkg.flat(capacity=128, dim=DIM))
        with pytest.raises(ValueError):
            pkg.maintenance.MaintenancePolicy(every_waves=0)
        with pytest.raises(ValueError):
            pkg.maintenance.MaintenancePolicy(sweep_budget=0)


def test_scheduler_cadence_and_source_roundtrip():
    def scenario(pkg):
        t = put(pkg, pkg.tiered(score_policy="epoch_lru", **TIER),
                np.array([1, 2, 3], np.uint64)).table
        src = pkg.serving.StaticSource(t)
        sched = pkg.maintenance.MaintenanceScheduler(pkg.maintenance.MaintenancePolicy(
            every_waves=3, ttl_epochs=1, advance_epoch=True))
        ran = [sched.on_wave(src) is not None for _ in range(6)]
        return ran, int(src.table.size()), src.snapshot()[0], pkg.states(src.table)

    (rj, zj, vj, sj), (rp, zp, vp, sp) = both(scenario)
    assert (rp, zp, vp) == (rj, zj, vj)
    same_states(sj, sp, "cadence")
    assert rp == [False, False, True, False, False, True] and zp == 0


def test_scheduler_offer_loses_to_a_concurrent_publish():
    """The reference's scenario: the trainer publishes the served table
    itself between the scheduler's snapshot and its offer.  Both packages
    reject the offer and count one skipped offer.  The port's difference by
    design: the step changed that table in place (the epoch tick), so the
    publish carries the change, where the reference's immutable handle
    publishes the table as it was."""
    def scenario(pkg):
        t = pkg.tiered(score_policy="epoch_lru", **TIER)
        pub = pkg.serving.TablePublisher(t)
        sched = pkg.maintenance.MaintenanceScheduler(pkg.maintenance.MaintenancePolicy(
            ttl_epochs=1, advance_epoch=True))

        class RacingSource:
            def snapshot(self):
                return pub.snapshot()

            def offer(self, version, table):
                pub.publish(t)                 # the trainer wins the race
                return pub.offer(version, table)

        rep = sched.on_wave(RacingSource())
        return (report_fields(rep), sched.totals.skipped_offers, pub.version,
                pub.table is t, int(pub.table.epoch))

    (rj, kj, vj, ij, ej), (rp, kp, vp, ip, ep) = both(scenario)
    assert (rp, kp, vp, ip) == (rj, kj, vj, ij)
    assert rp[-1] is False and kp == 1 and vp == 1 and ip
    assert ej == 0 and ep == 1                 # the one difference by design


def test_scheduler_step_rebuilds_on_a_signature_change():
    sched = pmaint.MaintenanceScheduler(pmaint.MaintenancePolicy(every_waves=1, sweep_budget=64))
    sched.run(PORT.flat(capacity=2 * 128, dim=DIM))
    sig_flat, fn_flat = sched._step_sig, sched._step_fn
    t2, _rep = sched.run(PORT.tiered(**TIER))
    assert sched._step_sig != sig_flat and sched._step_fn is not fn_flat
    assert isinstance(t2, repro_torch.TieredHKVTable) and sched.totals.runs == 2
    sched.run(t2)
    assert sched._step_fn is not fn_flat and sched.totals.runs == 3


# =============================================================================
# Engine integration (test_maintenance.py::TestEngineIntegration and the
# scheduler cases of test_online_engine.py)
# =============================================================================


def drive(pkg, budget, *, waves=12, wave=256, host_budget_s=None, low=0.5, high=0.8):
    """An admit engine over a tiered table on a Zipf stream; budget=None:
    no scheduler."""
    rng = np.random.default_rng(7)
    table = pkg.tiered(hot_capacity=2 * 128, cold_capacity=8 * 128, dim=8)
    sched = None if budget is None else pkg.maintenance.MaintenanceScheduler(
        pkg.maintenance.MaintenancePolicy(every_waves=1, sweep_budget=budget,
                                          low_watermark=low, high_watermark=high))
    eng = pkg.serving.OnlineEmbeddingEngine(table, wave_size=wave, miss_policy="admit",
                                            scheduler=sched, host_budget_s=host_budget_s)
    stream = zipf_keys(rng, wave * waves, 1.05, 2 * 8 * 128)
    for i in range(waves):
        eng.submit(pkg.serving.EmbeddingRequest(rid=i, keys=stream[i * wave:(i + 1) * wave]))
        eng.step()
    src = eng.source
    return dict(
        reports=[report_fields(r) for r in eng.reports],
        sched=None if sched is None else ([report_fields(r) for r in sched.reports],
                                          totals_fields(sched.totals)),
        values=[r.values for r in eng.completed], found=[r.found for r in eng.completed],
        offers=(src.offered, src.rejected_offers, src.snapshot()[0]),
        states=pkg.states(src.table), metrics=eng.metrics(),
        contains_last=np.asarray(src.table.contains(eng.completed[-1].keys)))


def same_runs(dj, dp, ctx):
    for k in ("reports", "sched", "offers"):
        assert dp[k] == dj[k], (ctx, k)
    for a, b in zip(dj["values"] + dj["found"], dp["values"] + dp["found"]):
        np.testing.assert_array_equal(b, a, err_msg=ctx)
    np.testing.assert_array_equal(dp["contains_last"], dj["contains_last"])
    same_states(dj["states"], dp["states"], ctx)


def test_scheduler_moves_demotions_off_the_serving_path():
    off_j, off_p = both(drive, None)
    on_j, on_p = both(drive, 256)
    same_runs(off_j, off_p, "scheduler off")
    same_runs(on_j, on_p, "scheduler on")
    m_off, m_on = off_p["metrics"], on_p["metrics"]
    assert m_off.demotions_per_wave > 0 and m_off.reactive_demotions > 0
    assert m_off.reactive_demotions == round(m_off.demotions_per_wave * m_off.waves)
    assert m_on.demotions_per_wave < m_off.demotions_per_wave
    assert m_on.hit_rate >= m_off.hit_rate - 1e-9
    assert on_p["sched"][1][2] > 0               # totals.demoted: the work moved
    assert on_p["contains_last"].all()


def test_engine_and_scheduler_offers_interleave_without_clobber():
    def scenario(pkg):
        return drive(pkg, 64, waves=6, wave=16, low=0.7, high=0.9)

    dj, dp = both(scenario)
    same_runs(dj, dp, "interleave")
    offered, rejected, version = dp["offers"]
    runs, skipped, deferred = dp["sched"][1][0], dp["sched"][1][4], dp["sched"][1][5]
    assert version == offered
    assert offered + rejected == len(dp["reports"]) + runs - deferred
    assert skipped == 0 and dp["contains_last"].all()


def test_scheduler_defers_when_staging_spent_the_budget():
    dj, dp = both(drive, 64, waves=5, wave=16, host_budget_s=1e-12)
    runs, deferred = dp["sched"][1][0], dp["sched"][1][5]
    assert runs == 1 and deferred == 4           # the first step seeds the estimate
    same_runs(dj, dp, "deferral")
