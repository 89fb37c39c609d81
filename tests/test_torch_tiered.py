"""The port's TieredHKVTable and tiered HKVEmbedding against the JAX
package, on the scenarios of ``tests/test_tiered.py``.

Every op runs on both packages' hierarchies (the JAX one on its jnp path,
the port's on the CPU, its cold tier on the 'hmem' placement as in the
reference), fed the same numpy batches.  After every op the statuses, the
`promoted` / `demoted` / `dropped` counters, `ok`, found flags, hot-hit
flags and values must be equal, and so must both tiers' full states
(carried across by `repro_torch.convert`): bit for bit, as the hierarchy
moves rows and scores and computes nothing from them.  The scenarios'
own assertions are kept on the port's side.  The training-path cases (the
embedding's sgd step, and a DLRM twin of a few steps with rowwise_adagrad)
hold the values within the tolerances of ``test_torch_embedding.py`` and
``test_torch_dlrm.py``: sgd exact, the DLRM's loss at rtol 1e-5 and its
values at atol 1e-6 (matrix products and row means summed in other
orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import TieredHKVTable as JaxTiered  # noqa: E402
from repro.core import U64  # noqa: E402
from repro.core import translate_scores as jax_translate  # noqa: E402
from repro.core.scores import get_policy as jax_policy  # noqa: E402
from repro.data import zipf_keys  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import KVTable, TieredHKVTable, convert, translate_scores  # noqa: E402
from repro_torch.core import find as pfind  # noqa: E402
from repro_torch.core.scores import get_policy  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys(rng, n, lo=0, hi=2**50):
    return rng.integers(lo, hi, size=n).astype(np.uint64)


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


class Pair:
    """A JAX hierarchy and the port's, driven alike and compared after
    every op."""

    def __init__(self, hot=2 * 128, cold=8 * 128, dim=4, **kw):
        self.dim = dim
        self.j = JaxTiered.create(hot_capacity=hot, cold_capacity=cold, dim=dim, **kw)
        self.p = TieredHKVTable.create(hot_capacity=hot, cold_capacity=cold, dim=dim,
                                       device="cpu", **kw)
        assert self.p.cold.cfg.value_tier == self.j.cold.cfg.value_tier
        self.check("create")

    def check(self, ctx):
        for tier in ("hot", "cold"):
            got = convert.state_to_arrays(getattr(self.p, tier).state)
            want = getattr(self.j, tier).state
            for f in convert.FIELDS:
                _eq(got[f], getattr(want, f), f"{ctx}: {tier}.{f}")

    def _same(self, pr, jr, fields, ctx):
        for f in fields:
            got = getattr(pr, f)
            _eq(got.numpy() if isinstance(got, torch.Tensor) else got, getattr(jr, f),
                f"{ctx}: {f}")

    def insert_or_assign(self, keys, vals, cs=None, ctx="insert_or_assign"):
        jr = self.j.insert_or_assign(keys, jnp.asarray(vals),
                                     None if cs is None else np.asarray(cs, np.uint64))
        pr = self.p.insert_or_assign(keys, vals, cs)
        assert pr.table is self.p
        self.j = jr.table
        self._same(pr, jr, ("status", "demoted", "dropped", "ok"), ctx)
        self.check(ctx)
        return pr

    def find_or_insert(self, keys, init, ctx="find_or_insert"):
        jr = self.j.find_or_insert(keys, jnp.asarray(init))
        pr = self.p.find_or_insert(keys, init)
        self.j = jr.table
        self._same(pr, jr, ("values", "found", "status", "promoted", "demoted", "dropped", "ok"),
                   ctx)
        self.check(ctx)
        return pr

    def find(self, keys, promote=None, ctx="find"):
        jr = self.j.find(keys, promote=promote)
        pr = self.p.find(keys, promote=promote)
        self.j = jr.table
        self._same(pr, jr, ("values", "found", "hot_hit", "promoted", "demoted", "dropped"), ctx)
        self.check(ctx)
        return pr

    def contains(self, keys):
        got = self.p.contains(keys)
        _eq(got.numpy(), self.j.contains(keys), "contains")
        return got.numpy()

    def size(self):
        got = self.p.size()
        assert got == int(self.j.size())
        return got


# =============================================================================
# Demotion cascade (test_tiered.py::TestDemotion)
# =============================================================================


class TestDemotion:
    def test_hot_evictions_land_in_cold_with_values(self):
        t = Pair(hot=128, cold=8 * 128, dim=2)
        rng = np.random.default_rng(0)
        seen = {}
        for step in range(4):
            kb = _keys(rng, 128)
            t.insert_or_assign(kb, np.full((128, 2), float(step + 1), np.float32))
            for k in kb:
                seen[int(k)] = float(step + 1)
        assert t.p.hot.size() == 128 and t.p.cold.size() > 0
        all_k = np.fromiter(seen, np.uint64)
        f = t.find(all_k, promote=False)
        assert bool(f.found.all())
        _eq(f.values[:, 0].numpy(), np.array([seen[int(k)] for k in all_k], np.float32), "values")

    def test_conservation_exact_when_cold_absorbs_everything(self):
        t = Pair(hot=128, cold=16 * 128, dim=2)
        rng = np.random.default_rng(1)
        inserted, dropped = set(), 0
        for _ in range(6):
            kb = _keys(rng, 128)
            dropped += int(t.insert_or_assign(kb, np.ones((128, 2), np.float32)).dropped)
            inserted.update(int(k) for k in kb)
        assert dropped == 0 and t.size() == len(inserted)

    def test_drops_only_at_cold_boundary_and_are_reported(self):
        t = Pair(hot=128, cold=128, dim=2)
        rng = np.random.default_rng(2)
        inserted, dropped = set(), 0
        for _ in range(6):
            kb = _keys(rng, 128)
            dropped += int(t.insert_or_assign(kb, np.ones((128, 2), np.float32)).dropped)
            inserted.update(int(k) for k in kb)
        size = t.size()
        assert dropped > 0 and dropped >= len(inserted) - size and size + dropped >= len(inserted)

    def test_hot_rejected_pairs_are_absorbed_by_cold(self):
        t = Pair(hot=128, cold=8 * 128, dim=2, score_policy="lfu")
        resident = np.arange(1, 129, dtype=np.uint64)
        for _ in range(5):
            t.insert_or_assign(resident, np.ones((128, 2), np.float32))
        burst = np.arange(10_000, 10_128, dtype=np.uint64)
        r = t.insert_or_assign(burst, np.full((128, 2), 7.0, np.float32))
        assert bool((r.status == 4).all()) and int(r.demoted) == 128 and bool(r.ok.all())
        f = t.find(burst, promote=False)
        assert bool(f.found.all()) and not bool(f.hot_hit.any())
        assert bool((f.values == 7.0).all())

    def test_insert_with_aux_columns_pads_like_flat_table(self):
        t = Pair(hot=128, cold=4 * 128, dim=4, aux_value_dim=2)
        rng = np.random.default_rng(10)
        for _ in range(3):
            kb = _keys(rng, 128)
            t.insert_or_assign(kb, np.ones((128, 4), np.float32))
        assert t.p.cold.size() > 0
        f = t.find(kb, promote=False)
        assert bool(f.found.all()) and bool((f.values == 1.0).all())

    def test_ok_is_false_when_both_tiers_reject(self):
        t = Pair(hot=128, cold=128, dim=2, score_policy="lfu")
        strong = np.arange(1, 129, dtype=np.uint64)
        for _ in range(4):
            t.insert_or_assign(strong, np.ones((128, 2), np.float32))
        burst = np.repeat(np.arange(1000, 1032, dtype=np.uint64), 4)
        t.insert_or_assign(burst, np.ones((128, 2), np.float32))
        cold_full = t.p.cold.size()
        weak = np.repeat(np.arange(5000, 5064, dtype=np.uint64), 2)
        r = t.insert_or_assign(weak, np.ones((128, 2), np.float32))
        assert bool((r.status == 4).all())
        _eq(r.ok.numpy(), t.contains(weak), "ok is the ground truth")
        if cold_full + 64 > 128:
            assert not bool(r.ok.all())

    def test_demotion_write_back_freshens_stale_cold_copy(self):
        t = Pair(hot=128, cold=8 * 128, dim=2)
        key = np.array([42], np.uint64)
        t.insert_or_assign(key, np.full((1, 2), 1.0, np.float32))
        t.insert_or_assign(np.arange(100, 356, dtype=np.uint64), np.zeros((256, 2), np.float32))
        t.find(key)
        assert bool(t.find(key, promote=False).hot_hit.all())
        t.j = t.j.assign(key, jnp.full((1, 2), 9.0))
        assert t.p.assign(key, np.full((1, 2), 9.0, np.float32)) is t.p
        t.check("assign")
        t.insert_or_assign(np.arange(500, 756, dtype=np.uint64), np.zeros((256, 2), np.float32))
        f = t.find(key, promote=False)
        assert bool(f.found.all()) and bool((f.values == 9.0).all())


# =============================================================================
# Miss-path promotion (TestPromotion)
# =============================================================================


class TestPromotion:
    def _overflowed(self, rng, dim=2):
        t = Pair(hot=128, cold=8 * 128, dim=dim)
        early = _keys(rng, 128, lo=1, hi=2**30)
        t.insert_or_assign(early, np.full((128, dim), 3.0, np.float32))
        t.insert_or_assign(_keys(rng, 256, lo=2**31, hi=2**32), np.zeros((256, dim), np.float32))
        cold_resident = ~t.find(early, promote=False).hot_hit.numpy()
        return t, early[cold_resident]

    def test_find_promotes_cold_hits_into_hot(self):
        t, cold_keys = self._overflowed(np.random.default_rng(3))
        assert len(cold_keys) > 0
        probe = cold_keys[:64]
        r = t.find(probe)
        assert bool(r.found.all()) and bool((r.values == 3.0).all())
        assert int(r.promoted) == len(probe)
        assert bool(t.find(probe, promote=False).hot_hit.all())
        assert bool(t.p.cold.contains(probe).all())

    def test_promotion_victims_cascade_down(self):
        t, cold_keys = self._overflowed(np.random.default_rng(4))
        pre = t.size()
        r = t.find(cold_keys[:64])
        assert int(r.demoted) > 0 and int(r.dropped) == 0 and t.size() == pre

    def test_promote_false_is_a_pure_reader(self):
        t, cold_keys = self._overflowed(np.random.default_rng(5))
        before = convert.tiered_state_to_arrays(t.p.state)
        r = t.find(cold_keys[:32], promote=False)
        assert r.table is t.p
        after = convert.tiered_state_to_arrays(t.p.state)
        for tier in ("hot", "cold"):
            for f in convert.FIELDS:
                _eq(after[tier][f], before[tier][f], f"{tier}.{f}")

    def test_find_or_insert_returns_cold_value_not_init(self):
        t, cold_keys = self._overflowed(np.random.default_rng(6))
        probe = cold_keys[:32]
        r = t.find_or_insert(probe, np.full((32, 2), -5.0, np.float32))
        assert bool(r.found.all()) and bool((r.values == 3.0).all())
        assert int(r.promoted) == len(probe)
        f2 = t.find(probe, promote=False)
        assert bool(f2.hot_hit.all()) and bool((f2.values == 3.0).all())

    def test_find_or_insert_fresh_misses_admit_init(self):
        t = Pair()
        fresh = np.arange(1, 33, dtype=np.uint64)
        r = t.find_or_insert(fresh, np.full((32, 4), 2.5, np.float32))
        assert not bool(r.found.any()) and bool((r.values == 2.5).all())
        assert t.contains(fresh).all()

    def test_rejected_cold_hit_keeps_its_cold_score(self):
        t = Pair(hot=128, cold=4 * 128, dim=2, score_policy="lfu")
        strong = np.arange(1, 129, dtype=np.uint64)
        for _ in range(5):
            t.insert_or_assign(strong, np.ones((128, 2), np.float32))
        t.insert_or_assign(np.repeat(np.array([777], np.uint64), 3), np.ones((3, 2), np.float32))
        t.insert_or_assign(np.repeat(np.arange(1000, 1016, dtype=np.uint64), 8),
                           np.ones((128, 2), np.float32))
        xk = np.array([777], np.uint64)
        assert bool(t.p.cold.contains(xk).all())
        before = int(t.p.cold.find(xk).scores[0])
        r = t.find_or_insert(xk, np.zeros((1, 2), np.float32))
        assert int(r.status[0]) == 4 and bool(r.ok[0])
        assert int(t.p.cold.find(xk).scores[0]) == before

    def test_find_or_insert_single_hot_probe(self, monkeypatch):
        """One hot locate shared with the closure: the hot pre-pass, the
        cold find_rows and the demotion's own cold locate, nothing more."""
        t = Pair(hot=128, cold=4 * 128, dim=2)
        t.insert_or_assign(np.arange(1, 65, dtype=np.uint64), np.ones((64, 2), np.float32))
        calls = {"n": 0}
        real = pfind.locate

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        monkeypatch.setattr(pfind, "locate", counting)
        t.p.find_or_insert(np.arange(1, 65, dtype=np.uint64), np.zeros((64, 2), np.float32))
        assert calls["n"] == 3

    def test_duplicate_keys_promote_once(self):
        t, cold_keys = self._overflowed(np.random.default_rng(7))
        r = t.find(np.repeat(cold_keys[:8], 4))
        assert bool(r.found.all()) and int(r.promoted) == 8


# =============================================================================
# Hit-rate uplift (TestHitRateUplift)
# =============================================================================


class TestHitRateUplift:
    def test_tiered_beats_same_hot_capacity_single_under_zipf(self):
        rng = np.random.default_rng(42)
        hot_cap, cold_cap, batch, steps = 128, 8 * 128, 256, 12
        stream = zipf_keys(rng, batch * steps, 1.05, 2 * cold_cap)
        t = Pair(hot=hot_cap, cold=cold_cap, dim=4)
        single = repro_torch.HKVTable.create(capacity=hot_cap, dim=4, device="cpu")
        init = np.zeros((batch, 4), np.float32)
        hits_t, hits_s = [], []
        for i in range(steps):
            kb = stream[i * batch:(i + 1) * batch]
            hits_t.append(float(t.find_or_insert(kb, init, ctx=f"step {i}").found.float().mean()))
            hits_s.append(float(single.find_or_insert(kb, init).found.float().mean()))
        hr_t, hr_s = np.mean(hits_t[steps // 2:]), np.mean(hits_s[steps // 2:])
        assert hr_t > hr_s + 0.03, (hr_t, hr_s)


# =============================================================================
# Score translation (TestScoreTranslation)
# =============================================================================


class TestScoreTranslation:
    def test_custom_destination_passes_scores_through(self):
        sc = torch.tensor([1, 2], dtype=torch.int64)
        assert translate_scores(get_policy("lru"), get_policy("custom"), sc) is sc
        jsc = U64(jnp.asarray([0, 0], jnp.uint32), jnp.asarray([1, 2], jnp.uint32))
        assert jax_translate(jax_policy("lru"), jax_policy("custom"), jsc) is jsc

    def test_non_custom_destination_restamps(self):
        sc = torch.zeros(2, dtype=torch.int64)
        for dst in ("lru", "lfu", "epoch_lru", "epoch_lfu"):
            assert translate_scores(get_policy("custom"), get_policy(dst), sc) is None

    def test_demoted_pairs_keep_relative_order_in_custom_cold(self):
        t = Pair(hot=128, cold=128, dim=2, score_policy="lfu")
        hot_keys = np.arange(1, 129, dtype=np.uint64)
        for _ in range(3):
            t.insert_or_assign(hot_keys, np.ones((128, 2), np.float32))
        t.insert_or_assign(np.repeat(np.arange(1000, 1032, dtype=np.uint64), 4),
                           np.ones((128, 2), np.float32))
        cold_before = t.p.cold.contains(hot_keys).numpy()
        assert cold_before.sum() > 0
        r = t.insert_or_assign(np.arange(5000, 5128, dtype=np.uint64),
                               np.ones((128, 2), np.float32))
        assert t.p.cold.contains(hot_keys).numpy()[cold_before].all()
        assert int(r.dropped) > 0


# =============================================================================
# Protocol and handle behaviour (TestTieredProtocol)
# =============================================================================


class TestTieredProtocol:
    def test_isinstance_kvtable(self):
        assert isinstance(Pair().p, KVTable)

    def test_handles_share_or_copy_the_tiers(self):
        """wrap and with_state bind the same states; snapshot copies them
        (the port's counterpart of the reference's pytree round trip)."""
        t = Pair(dim=2, score_policy="lfu")
        t.insert_or_assign(np.arange(1, 300, dtype=np.uint64), np.ones((299, 2), np.float32))
        p = t.p
        w = TieredHKVTable.wrap(p.state, p.hot.cfg, p.cold.cfg, promote_on_find=False)
        assert w.hot.state is p.hot.state and w.cold.state is p.cold.state
        assert not w.promote_on_find and w.hot.cfg == p.hot.cfg and w.cold.cfg == p.cold.cfg
        assert p.with_state(p.state).cold.state is p.cold.state
        snap = p.snapshot()
        p.clear()
        assert p.size() == 0 and snap.size() == 299
        assert p.capacity == 10 * 128 and p.hot_fraction == 0.2 and p.num_buckets == 10

    def test_repeated_find_or_insert(self):
        """The reference's jit/scan case: the same batch three times, found
        from the second on."""
        t = Pair(dim=2)
        keys = np.arange(1, 33, dtype=np.uint64)
        assert not bool(t.find_or_insert(keys, np.ones((32, 2), np.float32)).found.any())
        for step in range(3):
            assert bool(t.find_or_insert(keys, np.ones((32, 2), np.float32),
                                         ctx=f"step {step}").found.all())

    def test_erase_kills_both_copies(self):
        rng = np.random.default_rng(8)
        t = Pair(hot=128, cold=8 * 128, dim=2)
        keys = _keys(rng, 128, lo=1, hi=2**30)
        t.insert_or_assign(keys, np.ones((128, 2), np.float32))
        t.insert_or_assign(_keys(rng, 128, lo=2**31, hi=2**32), np.zeros((128, 2), np.float32))
        t.find(keys[:16])
        t.j = t.j.erase(keys[:16])
        assert t.p.erase(keys[:16]) is t.p
        t.check("erase")
        assert not t.contains(keys[:16]).any()
        assert not bool(t.find(keys[:16]).found.any())

    def test_geometry_mismatch_rejected(self):
        with pytest.raises(ValueError, match="geometry"):
            TieredHKVTable.from_configs(repro_torch.HKVConfig(capacity=128, dim=4),
                                        repro_torch.HKVConfig(capacity=256, dim=8), device="cpu")

    def test_session_update_rows_hits_hot_rows(self):
        t = Pair(dim=2)
        keys = np.arange(1, 17, dtype=np.uint64)
        t.insert_or_assign(keys, np.full((16, 2), 2.0, np.float32))
        js, ps = t.j.session(), t.p.session()
        js.update_rows(keys, lambda rows: rows * 3.0)
        ps.update_rows(keys, lambda rows: rows * 3.0)
        t.j = js.commit()
        assert ps.commit() is t.p
        t.check("session")
        assert bool((t.find(keys, promote=False).values == 6.0).all())

    def test_sweeps_stats_and_epoch_match_jax(self):
        """erase_if, evict_if (the hot stream then the cold one, stale
        inclusive copies masked), export_batch over the concatenated bucket
        space, stats and set_epoch on both packages.  The cold tier keeps
        its values in HBM here: the reference's sweeps on an 'hmem' plane
        mix memory spaces in one JAX op, which some JAX versions refuse
        (the port's 'hmem' sweeps are held against its 'hbm' ones in
        test_torch_tier.py)."""
        from repro.core.predicates import SweepPredicate as JaxPredicate

        rng = np.random.default_rng(11)
        t = Pair(hot=128, cold=4 * 128, dim=3, score_policy="epoch_lru", cold_value_tier="hbm")
        for step in range(4):
            t.j, _ = t.j.set_epoch(step), t.p.set_epoch(step)
            assert t.p.epoch == int(t.j.epoch)
            t.insert_or_assign(_keys(rng, 128, hi=2**20), rng.normal(size=(128, 3))
                               .astype(np.float32), ctx=f"fill {step}")
            t.find(_keys(rng, 64, hi=2**20), ctx=f"promote {step}")
        # a range spanning both tiers is held against the reference's two
        # one-tier exports joined (joining a host-tier and a device array in
        # one JAX op depends on the JAX version's memory spaces)
        hb, cb = t.p.hot.num_buckets, t.p.cold.num_buckets
        for start, count, parts in ((0, hb + cb, ((0, hb), (hb, cb))), (0, 1, ((0, 1),)),
                                    (hb + 1, cb - 1, ((hb + 1, cb - 1),))):
            jr = [t.j.export_batch(a, c) for a, c in parts]
            got = convert.export_to_arrays(t.p.export_batch(start, count))
            for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
                want = np.concatenate([np.asarray(getattr(r, f)) for r in jr])
                _eq(got[f], want, f"export({start}, {count}).{f}")
        js, ps = t.j.stats(), t.p.stats()
        _eq(ps.size, js.size, "stats.size")
        _eq(ps.occupancy_hist.numpy(), js.occupancy_hist, "stats.hist")
        _eq(ps.score_q.numpy().view(np.uint64), _u64(js.score_q_hi, js.score_q_lo), "stats.q")
        _eq(ps.load_factor.numpy(), js.load_factor, "stats.load_factor")
        jp = JaxPredicate.expire_before(2)
        jr, pr = t.j.erase_if(jp), t.p.erase_if(convert.predicate_from_arrays(jp))
        t.j = jr.table
        _eq(pr.swept.numpy(), jr.swept, "erase_if.swept")
        t.check("erase_if")
        jr = t.j.evict_if(JaxPredicate.always(), 48)
        pr = t.p.evict_if(convert.predicate_from_arrays(JaxPredicate.always()), 48)
        t.j = jr.table
        got = convert.stream_to_arrays(pr.evicted)
        for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
            _eq(got[f], getattr(jr.evicted, f), f"evict_if.{f}")
        _eq(pr.count.numpy(), jr.count, "evict_if.count")
        t.check("evict_if")
        t.j, _ = t.j.clear(), t.p.clear()
        t.check("clear")


# =============================================================================
# The embedding over a tiered table (TestTieredEmbedding)
# =============================================================================


def _emb_pair(opt="sgd", lr=1.0, **kw):
    from repro.embedding.dynamic import HKVEmbedding as JaxEmbedding
    from repro.embedding.sparse_opt import SparseOptimizer as JaxOpt
    from repro_torch.embedding import HKVEmbedding, SparseOptimizer

    kw = {**dict(capacity=8 * 128, dim=8, hot_capacity=2 * 128), **kw}
    # the reference keeps its cold tier's values in device memory here: its
    # 'hmem' placement on the CPU mixes memory spaces in one JAX op on the
    # training path, which some JAX versions refuse, and no result depends
    # on the placement; the port's cold tier is 'hmem'
    return (JaxEmbedding(optimizer=JaxOpt(opt, lr=lr), backend="jnp", cold_value_tier="hbm",
                         **kw),
            HKVEmbedding(optimizer=SparseOptimizer(opt, lr=lr), **kw))


def _check_tiers(jt, pt, ctx, atol=0.0):
    for tier in ("hot", "cold"):
        got = convert.state_to_arrays(getattr(pt, tier).state)
        want = getattr(jt, tier).state
        for f in convert.FIELDS:
            if f == "values" and atol:
                np.testing.assert_allclose(got[f], np.asarray(want.values), rtol=0, atol=atol,
                                           err_msg=f"{ctx}: {tier}.values")
            else:
                _eq(got[f], getattr(want, f), f"{ctx}: {tier}.{f}")


class TestTieredEmbedding:
    def test_config_surface_matches(self):
        from repro.embedding.dynamic import HKVEmbedding as JaxEmbedding
        from repro_torch.embedding import HKVEmbedding

        kw = dict(capacity=8 * 128, dim=8, hot_capacity=2 * 128)
        jemb, pemb = JaxEmbedding(**kw), HKVEmbedding(**kw)
        assert pemb.is_tiered and pemb.total_capacity == jemb.total_capacity == 10 * 128
        assert pemb.cold_config().value_tier == "hmem"
        for a, b in ((pemb.config(), jemb.config()), (pemb.cold_config(), jemb.cold_config())):
            for f in ("capacity", "dim", "buckets_per_key", "score_policy", "value_tier",
                      "aux_value_dim"):
                assert getattr(a, f) == getattr(b, f), f
        t = pemb.create(device="cpu")
        assert isinstance(t, TieredHKVTable)
        w = pemb.wrap(t.state)
        assert isinstance(w, TieredHKVTable) and w.hot.state is t.hot.state

    def test_train_serve_grads_cycle(self):
        jemb, pemb = _emb_pair()
        jt, pt = jemb.create(), pemb.create(device="cpu")
        toks = np.random.default_rng(0).integers(0, 4096, size=(2, 32))
        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, rows = pemb.lookup_train(pt, torch.from_numpy(toks))
        _eq(rows.numpy(), jrows, "lookup_train rows")
        _check_tiers(jt, pt, "lookup_train")
        g = np.ones(rows.shape, np.float32)
        jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.asarray(g))
        assert pemb.apply_grads(pt, torch.from_numpy(toks), torch.from_numpy(g)) is pt
        _check_tiers(jt, pt, "apply_grads")
        served = pemb.lookup_serve(pt, torch.from_numpy(toks))
        _eq(served.numpy(), jemb.lookup_serve(jt, jnp.asarray(toks)), "lookup_serve")
        assert served.shape == rows.shape and float((served - rows).abs().max()) > 0.5
        _check_tiers(jt, pt, "lookup_serve is a pure reader")

    def test_trained_value_survives_demotion_and_promotion(self):
        jemb, pemb = _emb_pair()
        jt, pt = jemb.create(), pemb.create(device="cpu")
        toks = np.arange(64).reshape(1, 64)
        jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, rows = pemb.lookup_train(pt, torch.from_numpy(toks))
        jt = jemb.apply_grads(jt, jnp.asarray(toks), jnp.ones_like(jrows))
        pemb.apply_grads(pt, torch.from_numpy(toks), torch.ones_like(rows))
        trained = pemb.lookup_serve(pt, torch.from_numpy(toks))
        churn = np.arange(10_000, 10_000 + 1024).reshape(1, 1024)
        jt, _ = jemb.lookup_train(jt, jnp.asarray(churn))
        pt, _ = pemb.lookup_train(pt, torch.from_numpy(churn))
        _check_tiers(jt, pt, "churn")
        assert not bool(pt.find(pemb.keys_of(torch.from_numpy(toks)), promote=False)
                        .hot_hit.all())
        jt, jrows2 = jemb.lookup_train(jt, jnp.asarray(toks))
        pt, rows2 = pemb.lookup_train(pt, torch.from_numpy(toks))
        _eq(rows2.numpy(), jrows2, "promoted rows")
        _check_tiers(jt, pt, "promotion")
        np.testing.assert_allclose(rows2.numpy(), trained.numpy(), rtol=1e-6)

    def test_dlrm_steps_on_a_tiered_embedding_match_jax(self):
        """A DLRM twin on a tiered embedding (rowwise_adagrad, dual bucket,
        a hot tier an eighth of the cold one): the loss at rtol 1e-5, the
        statuses-bearing planes exact and the values at atol 1e-6 after
        every step (see test_torch_dlrm.py for the model and its loop)."""
        from repro.models.common import dense_init
        from repro_torch.data import zipf_keys as pzipf
        from repro_torch.models.dlrm import DLRM
        from test_torch_dlrm import LR, _batch, _jax_loss_and_grad

        jemb, pemb = _emb_pair("rowwise_adagrad", lr=0.01, dim=8, capacity=8 * 128,
                               hot_capacity=128)
        jt, pt = jemb.create(), pemb.create(device="cpu")
        nf, dense, d = 6, 13, 8
        ks = jax.random.split(jax.random.PRNGKey(0), 4)
        params = {"bottom1": dense_init(ks[0], dense, 64), "bottom2": dense_init(ks[1], 64, d),
                  "top1": dense_init(ks[2], d + nf * (nf + 1) // 2, 64),
                  "top2": dense_init(ks[3], 64, 1)}
        model = DLRM(d, nf, dense, device="cpu")
        model.load_state_dict(convert.dlrm_params_from_jax(
            {k: np.asarray(v) for k, v in params.items()}))
        grad_fn = _jax_loss_and_grad(nf)
        jrng, prng = np.random.default_rng(1), np.random.default_rng(1)
        demoted = 0
        for step in range(4):
            toks, dense_x, labels = _batch(jrng, nf, dense, zipf_keys)
            ptoks, pdense, plabels = _batch(prng, nf, dense, pzipf)
            jk = jemb.keys_of(jnp.asarray(toks))
            jr = jt.find_or_insert(jk, jemb.default_rows(jk))
            pr = pt.snapshot().find_or_insert(pemb.keys_of(torch.from_numpy(ptoks)),
                                              pemb.default_rows(pemb.keys_of(
                                                  torch.from_numpy(ptoks))))
            for f in ("status", "found", "promoted", "demoted", "dropped", "ok"):
                _eq(getattr(pr, f).numpy(), getattr(jr, f), f"step {step}: {f}")
            demoted += int(pr.demoted)
            jt, jrows = jemb.lookup_train(jt, jnp.asarray(toks))
            jloss, (gp, ge) = grad_fn(params, jrows, jnp.asarray(dense_x), jnp.asarray(labels))
            params = jax.tree.map(lambda p, g: p - LR * g, params, gp)
            jt = jemb.apply_grads(jt, jnp.asarray(toks), ge)
            pt, rows = pemb.lookup_train(pt, torch.from_numpy(ptoks))
            rows = rows.detach().requires_grad_(True)
            loss = model.loss(rows, torch.from_numpy(pdense), torch.from_numpy(plabels))
            loss.backward()
            model.sgd_(LR)
            pemb.apply_grads(pt, torch.from_numpy(ptoks), rows.grad)
            np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
            _check_tiers(jt, pt, f"step {step}", atol=1e-6)
        assert demoted > 0
