"""``tests/test_kvtable_conformance.py``'s contract suite over the port's
`KVTable` implementations.

The one parametrized contract every table family keeps, with the same
capability table:

  hkv        `repro_torch.HKVTable` on the CPU (the plain path)
  hkv_card   the same on the card, backend 'auto' (the CUDA kernels);
             marked `cuda`, it skips without a card
  dict_oa    `DictKVTable` over open addressing (WarpCore family)
  dict_p2c   `DictKVTable` over bucketed power-of-two choices (BGHT)
  tiered     `TieredHKVTable` (hot tier over a cold 'hmem' tier)
  sharded    `ShardedHKVTable` on a 1-shard mesh on the CPU
  sharded_card  the same on a ("data", "model") (2, 4) mesh on the card,
             eight shards sharing it; marked `cuda`

The port's tables change in place: an op's `.table` is the same handle,
so the helpers below chain as the reference's do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import (HKVTable, KVTable, ShardedHKVTable, SweepPredicate,  # noqa: E402
                         TieredHKVTable, make_dev_mesh, make_mesh, normalize_keys)
from repro_torch.baselines import DictKVTable  # noqa: E402
from repro_torch.core import ops as core_ops  # noqa: E402
from repro_torch.embedding.sparse_opt import SparseOptimizer  # noqa: E402

BATCH = 64
DIM = 4
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

IMPLS = ["hkv", pytest.param("hkv_card", marks=pytest.mark.cuda), "dict_oa", "dict_p2c",
         "tiered", "sharded", pytest.param("sharded_card", marks=pytest.mark.cuda)]

HKV_CAPS = dict(has_export=True, caller_init=True, has_scores=True, has_find_rows=True,
                has_row_update=True)
# sharded: owners recompute the init rows (no caller init); no full-row
# reads or structured row updates through the handle
SHARDED_CAPS = dict(has_export=True, caller_init=False, has_scores=True, has_find_rows=False,
                    has_row_update=False)
CAPS = {
    # the reference's capability table
    "hkv": HKV_CAPS,
    "hkv_card": HKV_CAPS,
    "dict_oa": dict(has_export=True, caller_init=True, has_scores=False,
                    has_find_rows=False, has_row_update=False),
    "dict_p2c": dict(has_export=True, caller_init=True, has_scores=False,
                     has_find_rows=False, has_row_update=False),
    "tiered": dict(has_export=True, caller_init=True, has_scores=True,
                   has_find_rows=False, has_row_update=False),
    "sharded": SHARDED_CAPS,
    "sharded_card": SHARDED_CAPS,
}


def make_table(impl: str):
    if impl == "hkv":
        return HKVTable.create(capacity=2 * 128, dim=DIM, device="cpu")
    if impl == "hkv_card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return HKVTable.create(capacity=2 * 128, dim=DIM)
    if impl == "dict_oa":
        return DictKVTable.open_addressing(capacity=256, dim=DIM, device="cpu")
    if impl == "dict_p2c":
        return DictKVTable.bucketed_p2c(capacity=256, dim=DIM, device="cpu")
    if impl == "tiered":
        return TieredHKVTable.create(hot_capacity=128, cold_capacity=2 * 128, dim=DIM,
                                     device="cpu")
    if impl == "sharded":
        return ShardedHKVTable.create(make_mesh((1,), ("d",), device="cpu"),
                                      capacity=4 * 128, dim=DIM)
    if impl == "sharded_card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return ShardedHKVTable.create(make_dev_mesh(2, 4), capacity=8 * 128, dim=DIM)
    raise AssertionError(impl)


def pad_keys(keys) -> np.ndarray:
    keys = np.asarray(keys, np.uint64)
    out = np.full(BATCH, EMPTY, np.uint64)
    out[: len(keys)] = keys
    return out


def rows_for(keys: np.ndarray) -> torch.Tensor:
    """Deterministic per-key rows (column j = key + j)."""
    base = np.where(keys == EMPTY, 0, keys.astype(np.float64))
    return torch.tensor(base[:, None] + np.arange(DIM)[None, :], dtype=torch.float32)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dev(table, x):
    return x.to(table.device) if isinstance(x, torch.Tensor) else x


def read(table, keys):
    """Pure-reader find: (values, found)."""
    if isinstance(table, (TieredHKVTable, ShardedHKVTable)):
        r = table.find(keys, promote=False)
    else:
        r = table.find(keys)
    return _np(r.values[:, :DIM]), _np(r.found)


def contains(table, keys):
    return _np(table.contains(keys))


def upsert(table, keys, values):
    r = table.insert_or_assign(keys, _dev(table, values))
    return r.table, _np(r.ok)


def find_or_insert(table, keys, init):
    if CAPS_CURRENT["caller_init"]:
        r = table.find_or_insert(keys, _dev(table, init))
    else:
        r = table.find_or_insert(keys)
    return r.table, _np(r.values[:, :DIM]), _np(r.found)


def assign(table, keys, values):
    return table.assign(keys, _dev(table, values))


def size(table) -> int:
    return int(table.size())


_OPT = SparseOptimizer("sgd", lr=0.5)   # lr 0.5 x integer grads: exact
SWEEP_BUDGET = 32

CAPS_CURRENT = None


@pytest.fixture(params=IMPLS)
def impl(request):
    global CAPS_CURRENT
    CAPS_CURRENT = CAPS[request.param]
    return request.param


@pytest.fixture
def table(impl):
    return make_table(impl)


KEYS = np.arange(1, 25, dtype=np.uint64) * np.uint64(7919)  # 24 distinct keys


class TestReaderContract:
    def test_empty_table_reads(self, table):
        k = pad_keys(KEYS)
        vals, found = read(table, k)
        assert not found.any() and np.allclose(vals, 0.0)
        assert not contains(table, k).any()
        assert size(table) == 0 and table.capacity > 0

    def test_find_agrees_with_contains(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        _, found = read(t, k)
        assert np.array_equal(found, contains(t, k))


class TestInserterContract:
    def test_insert_find_roundtrip(self, table):
        k = pad_keys(KEYS)
        v = rows_for(k)
        t, ok = upsert(table, k, v)
        assert ok[: len(KEYS)].all()
        assert not ok[len(KEYS):].any()       # EMPTY padding is never "ok"
        vals, found = read(t, k)
        assert found[: len(KEYS)].all() and not found[len(KEYS):].any()
        assert np.allclose(vals[: len(KEYS)], v.numpy()[: len(KEYS)])
        assert size(t) == len(KEYS)

    def test_overwrite_updates_in_place(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        t, ok = upsert(t, k, rows_for(k) + 100.0)
        assert ok[: len(KEYS)].all()
        vals, _ = read(t, k)
        assert np.allclose(vals[: len(KEYS)], rows_for(k).numpy()[: len(KEYS)] + 100.0)
        assert size(t) == len(KEYS)

    def test_duplicate_lanes_last_writer_wins(self, table):
        key = np.uint64(4242)
        k = pad_keys([key, key, key])
        v = torch.zeros(BATCH, DIM)
        v[0], v[1], v[2] = 1.0, 2.0, 3.0
        t, _ = upsert(table, k, v)
        vals, found = read(t, pad_keys([key]))
        assert found[0] and np.allclose(vals[0], 3.0)
        assert size(t) == 1

    def test_find_or_insert_admits_then_hits(self, table):
        k = pad_keys(KEYS)
        init = rows_for(k) + 0.5
        t, vals1, found1 = find_or_insert(table, k, init)
        assert not found1[: len(KEYS)].any()
        if CAPS_CURRENT["caller_init"]:
            assert np.allclose(vals1[: len(KEYS)], init.numpy()[: len(KEYS)])
        t, vals2, found2 = find_or_insert(t, k, rows_for(k) - 9.0)
        assert found2[: len(KEYS)].all()
        assert np.allclose(vals2[: len(KEYS)], vals1[: len(KEYS)])
        assert size(t) == len(KEYS)


class TestFusedReadContract:
    """find_rows and session-fused read mixes agree lane for lane with
    find and contains (on the card: the fused find kernel against the
    locate and gather kernels)."""

    def _mixed(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        t = t.erase(pad_keys(KEYS[:6]))
        return t, pad_keys(np.concatenate([KEYS, np.array([999983], np.uint64)]))

    def test_find_rows_matches_find(self, table):
        if not CAPS_CURRENT["has_find_rows"]:
            pytest.skip("no full-row read surface on this impl")
        t, q = self._mixed(table)
        vals, found = read(t, q)
        r = t.find_rows(q)
        np.testing.assert_array_equal(_np(r.found), found)
        np.testing.assert_array_equal(_np(r.rows[:, :DIM]), vals)
        score = _np(r.scores).view(np.uint64)
        assert (score[found] > 0).all() and (score[~found] == 0).all()

    def test_session_read_matches_unfused(self, table):
        if not CAPS_CURRENT["has_find_rows"]:
            pytest.skip("no session find_rows surface on this impl")
        t, q = self._mixed(table)
        vals, found = read(t, q)
        s = t.session()
        f, c, r = s.find(q), s.contains(q), s.find_rows(q)
        s.commit()
        np.testing.assert_array_equal(_np(f.get().found), found)
        np.testing.assert_array_equal(_np(c.get()), found)
        np.testing.assert_array_equal(_np(f.get().values[:, :DIM]), vals)
        np.testing.assert_array_equal(_np(r.get().rows[:, :DIM]), vals)


class TestUpdaterContract:
    def test_assign_writes_existing_only(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        half = len(KEYS) // 2
        wk = pad_keys(np.concatenate([KEYS[:half], np.array([999983], np.uint64)]))
        t2 = assign(t, wk, torch.full((BATCH, DIM), -5.0))
        vals, _ = read(t2, k)
        assert np.allclose(vals[:half], -5.0)
        assert np.allclose(vals[half: len(KEYS)], rows_for(k).numpy()[half: len(KEYS)])
        _, f999 = read(t2, pad_keys([999983]))
        assert not f999[0]
        assert size(t2) == len(KEYS)

    def test_row_update_trains_residents_only(self, table):
        if not CAPS_CURRENT["has_row_update"]:
            pytest.skip("no structured row-update surface on this impl")
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        before = rows_for(k).numpy()
        q = pad_keys(np.concatenate([KEYS[:8], np.array([999983], np.uint64)]))
        g = torch.full((BATCH, DIM), 2.0, device=t.device)
        solo = t.snapshot()
        s = t.session()
        f = s.find(q)
        r = s.update_rows(q, core_ops.RowUpdate(_OPT, g))
        c = s.contains(q)
        t2 = s.commit()
        found = _np(r.get().found)
        assert found[:8].all() and not found[8:].any()
        np.testing.assert_array_equal(_np(f.get().values[:8, :DIM]), before[:8])
        np.testing.assert_array_equal(_np(c.get()), found)
        vals, _ = read(t2, k)
        np.testing.assert_array_equal(vals[:8], before[:8] - 1.0)   # 0.5 * 2
        np.testing.assert_array_equal(vals[8: len(KEYS)], before[8: len(KEYS)])
        _, f999 = read(t2, pad_keys([999983]))
        assert not f999[0] and size(t2) == len(KEYS)
        # the solo structured route (one update_scan launch on the card)
        s3 = solo.session()
        r3 = s3.update_rows(q, core_ops.RowUpdate(_OPT, g))
        t3 = s3.commit()
        np.testing.assert_array_equal(_np(r3.get().found), found)
        np.testing.assert_array_equal(read(t3, k)[0], vals)


class TestStructuralContract:
    def test_erase_removes_and_is_idempotent(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        half = len(KEYS) // 2
        gone = pad_keys(np.concatenate([KEYS[:half], np.array([999983], np.uint64)]))
        t2 = t.erase(gone)
        _, found = read(t2, k)
        assert not found[:half].any() and found[half: len(KEYS)].all()
        assert size(t2) == len(KEYS) - half
        t3 = t2.erase(gone)
        assert size(t3) == len(KEYS) - half
        t4, ok = upsert(t3, pad_keys(KEYS[:half]), rows_for(pad_keys(KEYS[:half])))
        assert ok[:half].all()
        assert read(t4, k)[1][: len(KEYS)].all()

    def test_clear_empties_and_reuses(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        t2 = t.clear()
        assert size(t2) == 0 and not read(t2, k)[1].any()
        t3, ok = upsert(t2, k, rows_for(k))
        assert ok[: len(KEYS)].all() and size(t3) == len(KEYS)


class TestMaintenanceContract:
    def test_erase_if_key_range(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        lo, hi = int(KEYS[4]), int(KEYS[12])
        r = t.erase_if(SweepPredicate.key_in_range(lo, hi))
        inside = (KEYS >= lo) & (KEYS < hi)
        assert int(r.swept) == inside.sum()
        _, found = read(r.table, k)
        np.testing.assert_array_equal(found[: len(KEYS)], ~inside)
        assert size(r.table) == len(KEYS) - inside.sum()
        _, ok = upsert(r.table, k, rows_for(k))
        assert ok[: len(KEYS)].all()

    def test_erase_if_score_threshold(self, table):
        if not CAPS_CURRENT["has_scores"]:
            pytest.skip("dictionary tables carry no score metadata")
        a, b = pad_keys(KEYS[:12]), pad_keys(KEYS[12:])
        t, _ = upsert(table, a, rows_for(a))       # clock 1
        t, _ = upsert(t, b, rows_for(b))           # clock 2
        r = t.erase_if(SweepPredicate.score_below(2))
        assert int(r.swept) >= 12                  # tiered: inclusive cold copies
        _, found = read(r.table, pad_keys(KEYS))
        assert not found[:12].any() and found[12: len(KEYS)].all()

    def test_evict_if_returns_the_removed_entries(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        lo, hi = int(KEYS[0]), int(KEYS[8])
        want = {int(x) for x in KEYS[(KEYS >= lo) & (KEYS < hi)]}
        r = t.evict_if(SweepPredicate.key_in_range(lo, hi), SWEEP_BUDGET)
        assert int(r.count) == len(want)
        mask = _np(r.evicted.mask)
        keys = _np(r.evicted.keys).view(np.uint64)
        assert {int(keys[i]) for i in np.nonzero(mask)[0]} == want
        vals = _np(r.evicted.values)
        for i in np.nonzero(mask)[0]:
            np.testing.assert_allclose(vals[i, :DIM],
                                       rows_for(np.array([keys[i]])).numpy()[0])
        _, found = read(r.table, k)
        np.testing.assert_array_equal(found[: len(KEYS)], ~((KEYS >= lo) & (KEYS < hi)))

    def test_stats_sanity(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        s = t.stats()
        assert int(s.size) == len(KEYS)
        assert 0.0 < float(s.load_factor) <= 1.0
        hist = _np(s.occupancy_hist)
        assert (hist >= 0).all() and (hist * np.arange(len(hist))).sum() >= len(KEYS)
        q = s.score_quantiles()
        assert q.shape == (5,) and (np.diff(q.astype(np.int64)) >= 0).all()

    def test_empty_table_stats(self, table):
        s = table.stats()
        assert int(s.size) == 0 and float(s.load_factor) == 0.0


class TestExportContract:
    def test_export_batch_streams_the_live_set(self, table):
        k = pad_keys(KEYS)
        t, _ = upsert(table, k, rows_for(k))
        t = t.erase(pad_keys(KEYS[:4]))
        seen = {}
        for b in range(t.num_buckets):
            exp = t.export_batch(b, 1)
            mask, keys, vals = _np(exp.mask), _np(exp.keys).view(np.uint64), _np(exp.values)
            for i in np.nonzero(mask)[0]:
                assert int(keys[i]) not in seen, "duplicate key in export stream"
                seen[int(keys[i])] = vals[i, :DIM]
        assert sorted(seen) == sorted(int(x) for x in KEYS[4:])
        fv, _ = read(t, k)
        for j, key in enumerate(KEYS):
            if int(key) in seen:
                assert np.allclose(seen[int(key)], fv[j])


def protocol_roundtrip(table):
    """The one code path a harness runs over any KVTable."""
    assert isinstance(table, KVTable)
    keys = np.arange(1, 65, dtype=np.uint64)
    vals = torch.arange(64, dtype=torch.float32)[:, None].expand(64, table.dim) + 1.0
    rep = table.insert_or_assign(keys, _dev(table, vals))
    assert bool(rep.ok.all())
    table = rep.table
    assert int(table.size()) == 64 and 0.0 < float(table.load_factor()) <= 1.0
    f = table.find(keys)
    assert bool(f.found.all())
    np.testing.assert_allclose(_np(f.values), vals.numpy())
    miss = table.find(np.arange(1000, 1010, dtype=np.uint64))
    assert not bool(miss.found.any()) and not _np(miss.values).any()
    assert bool(table.contains(keys).all())
    return table


class TestKeyNormalization:
    def test_key_forms_are_equivalent(self, table):
        ids = [3, 17, 255]
        t, _ = upsert(table, pad_keys(np.array(ids, np.uint64)),
                      rows_for(pad_keys(np.array(ids, np.uint64))))
        as_list = list(ids) + [-1] * (BATCH - len(ids))
        _, found = read(t, normalize_keys(np.array(as_list, np.int64)))
        assert found[: len(ids)].all() and not found[len(ids):].any()

    def test_protocol_isinstance_and_roundtrip(self, table):
        assert isinstance(table, KVTable)
        protocol_roundtrip(table)
        assert repro_torch.table_signature(table)


def test_sharded_over_tiered_protocol_conformance():
    """tests/test_tiered.py's sharded-over-tiered case: each shard a
    TieredHKVTable, driven through the one protocol path."""
    from repro_torch.embedding import HKVEmbedding

    table = ShardedHKVTable.create(
        make_mesh((1,), ("data",), device="cpu"),
        HKVEmbedding(capacity=4 * 128, dim=3, hot_capacity=128,
                     optimizer=SparseOptimizer("sgd")))
    assert isinstance(table.shards[0], TieredHKVTable)
    table = protocol_roundtrip(table)
    r = table.find_or_insert(np.arange(1, 65, dtype=np.uint64))
    assert bool(r.found.all())
