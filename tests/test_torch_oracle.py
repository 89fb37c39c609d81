"""The port's sequential oracle (``repro_torch.core.oracle``) against the
JAX package's, and the port's batch closure against the oracle.

* The two packages' `OracleTable`s take the same seeded op sequences
  (every op of the oracle, five score policies, both bucket modes): the
  statuses, find results, sweep counts and eviction lists, and every entry
  (key, score, value) after every op, are equal.
* The port's numpy `hash_pair_np` equals its torch `hash_pair` bit for bit.
* ``tests/test_core_oracle.py``'s property tests, with the port's
  ``merge.upsert`` (through ``ops``) in place of the JAX package's: the
  hypothesis versions where hypothesis is installed, and the same checks on
  fixed seeds everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.oracle import OracleTable as JOracle  # noqa: E402

from repro_torch.core import ops, table, u64  # noqa: E402
from repro_torch.core.oracle import OracleTable  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:       # pragma: no cover - the card's machine has it
    HAVE_HYPOTHESIS = False

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")


def _entries(orc):
    return {k: (e.score, np.asarray(e.value).tobytes()) for k, e in orc.items()}


@pytest.mark.parametrize("dual", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_oracle_equals_the_reference_oracle(policy, dual):
    rng = np.random.default_rng(2 * POLICIES.index(policy) + dual)
    kw = dict(buckets_per_key=dual, policy=policy)
    mine, ref = OracleTable(256, 2, slots_per_bucket=16, **kw), \
        JOracle(256, 2, slots_per_bucket=16, **kw)
    for step in range(40):
        op = rng.integers(0, 9)
        n = int(rng.integers(1, 40))
        keys = rng.integers(0, 400, size=n).astype(np.uint64)
        if rng.random() < 0.3:
            keys[0] = EMPTY
        if rng.random() < 0.2:
            keys[-1] = np.uint64(2**63 + int(rng.integers(0, 5)))
        vals = rng.normal(size=(n, 2)).astype(np.float32)
        cust = rng.integers(0, 60, size=n).astype(np.uint64)
        if step % 7 == 3:
            mine.epoch = ref.epoch = step // 7
        if op == 0:
            assert mine.insert_or_assign(keys, vals, cust) == ref.insert_or_assign(keys, vals, cust)
        elif op == 1:
            a, b = mine.find_or_insert(keys, vals, cust), ref.find_or_insert(keys, vals, cust)
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        elif op == 2:
            assert mine.accum_or_assign(keys, vals, cust) == ref.accum_or_assign(keys, vals, cust)
        elif op == 3:
            a, b = mine.find(keys), ref.find(keys)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(mine.contains(keys), ref.contains(keys))
        elif op == 4:
            mine.assign(keys, vals)
            ref.assign(keys, vals)
        elif op == 5:
            mine.erase(keys)
            ref.erase(keys)
        elif op == 6:
            lo = int(rng.integers(0, 300))
            assert mine.erase_if("key_range", lo, lo + 50) == ref.erase_if("key_range", lo, lo + 50)
        elif op == 7:
            a, b = mine.evict_if("always", 5), ref.evict_if("always", 5)
            assert [(k, s) for k, s, _ in a] == [(k, s) for k, s, _ in b]
            for (_, _, x), (_, _, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif step % 13 == 12:
            mine.clear()
            ref.clear()
        assert _entries(mine) == _entries(ref), f"{policy} dual={dual} step {step}"
        assert (mine.size(), mine.load_factor()) == (ref.size(), ref.load_factor())


def test_hash_pair_np_equals_the_torch_hash():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 2**64 - 1, size=20000, dtype=np.uint64),
                           np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                                     2**64 - 2, 2**64 - 1], np.uint64)])
    h1, h2 = u64.hash_pair_np(keys)
    t1, t2 = u64.hash_pair(u64.from_numpy_u64(keys))
    assert h1.dtype == h2.dtype == np.uint32
    np.testing.assert_array_equal(h1.astype(np.int64), t1.numpy())
    np.testing.assert_array_equal(h2.astype(np.int64), t2.numpy())


# =============================================================================
# tests/test_core_oracle.py on the port's closure
# =============================================================================


def _drain(state, cfg):
    """{key: (score, value)} of the live table contents."""
    exp = ops.export_batch(state, cfg, 0, cfg.num_buckets)
    mask = exp.mask.numpy()
    keys = exp.keys.numpy().view(np.uint64)
    scores = exp.scores.numpy().view(np.uint64)
    vals = exp.values.numpy()
    return {int(k): (int(s), vals[i, :cfg.dim])
            for i, (k, s, m) in enumerate(zip(keys, scores, mask)) if m}


def _run_pair(policy, dual, capacity, dim, batches, key_space, seed):
    rng = np.random.default_rng(seed)
    cfg = table.HKVConfig(capacity=capacity, dim=dim, buckets_per_key=2 if dual else 1,
                          score_policy=policy)
    state = table.create(cfg, "cpu")
    orc = OracleTable(capacity, dim, buckets_per_key=2 if dual else 1, policy=policy)
    for bi, n in enumerate(batches):
        keys_np = rng.integers(0, key_space, size=n).astype(np.uint64)
        if n >= 4 and rng.random() < 0.5:  # sentinel padding lanes
            keys_np[rng.integers(0, n, size=2)] = EMPTY
        vals_np = rng.normal(size=(n, dim)).astype(np.float32)
        res = ops.insert_or_assign(state, cfg, u64.from_numpy_u64(keys_np),
                                   torch.from_numpy(vals_np))
        want = np.asarray(orc.insert_or_assign(keys_np, vals_np), np.int8)
        got = res.status.numpy()
        assert np.array_equal(got, want), f"batch {bi}: {np.nonzero(got != want)[0][:8]}"
    mine = _drain(state, cfg)
    theirs = {k: (e.score, e.value) for k, e in orc.items()}
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k][0] == theirs[k][0], f"score mismatch for key {k}"
        np.testing.assert_array_equal(mine[k][1], theirs[k][1])


def _custom_scores(seed, dual):
    rng = np.random.default_rng(seed)
    cfg = table.HKVConfig(capacity=128, dim=2, buckets_per_key=2 if dual else 1,
                          score_policy="custom")
    state = table.create(cfg, "cpu")
    orc = OracleTable(128, 2, buckets_per_key=2 if dual else 1, policy="custom")
    for _ in range(5):
        keys_np = rng.integers(0, 4000, size=64).astype(np.uint64)
        vals_np = rng.normal(size=(64, 2)).astype(np.float32)
        scores_np = rng.integers(0, 50, size=64).astype(np.uint64)  # tie-heavy
        res = ops.insert_or_assign(state, cfg, u64.from_numpy_u64(keys_np),
                                   torch.from_numpy(vals_np),
                                   custom_scores=u64.from_numpy_u64(scores_np))
        want = np.asarray(orc.insert_or_assign(keys_np, vals_np, scores_np), np.int8)
        assert np.array_equal(res.status.numpy(), want)
    mine = _drain(state, cfg)
    theirs = {k: (e.score, e.value) for k, e in orc.items()}
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k][0] == theirs[k][0]


def _find_or_insert(seed, dual):
    rng = np.random.default_rng(seed)
    cfg = table.HKVConfig(capacity=2 * 128, dim=2, buckets_per_key=2 if dual else 1,
                          score_policy="lru")
    state = table.create(cfg, "cpu")
    orc = OracleTable(2 * 128, 2, buckets_per_key=2 if dual else 1, policy="lru")
    for _ in range(6):
        keys_np = rng.integers(0, 700, size=48).astype(np.uint64)
        inits = rng.normal(size=(48, 2)).astype(np.float32)
        res = ops.find_or_insert(state, cfg, u64.from_numpy_u64(keys_np),
                                 torch.from_numpy(inits))
        want_st, want_vals = orc.find_or_insert(keys_np, inits)
        assert np.array_equal(res.status.numpy(), np.asarray(want_st, np.int8))
        np.testing.assert_array_equal(res.values.numpy(), want_vals)


SEEDS = (0, 1, 2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("policy", ["lru", "lfu", "epoch_lru", "epoch_lfu"])
def test_merge_matches_oracle_seeded(policy, dual, seed):
    _run_pair(policy, dual, 2 * 128, 2, [48] * 8, (50, 300, 5000)[seed], seed)


@pytest.mark.parametrize("dual", [False, True])
def test_merge_matches_oracle_oversubscribed_seeded(dual):
    _run_pair("lru", dual, 128, 2, [200, 200, 200], 100_000, 7)


def test_merge_matches_oracle_heavy_duplicates_seeded():
    _run_pair("lfu", False, 128, 2, [64] * 6, 12, 11)


@pytest.mark.parametrize("dual", [False, True])
def test_custom_scores_match_oracle_seeded(dual):
    _custom_scores(5, dual)


@pytest.mark.parametrize("dual", [False, True])
def test_find_or_insert_matches_oracle_seeded(dual):
    _find_or_insert(9, dual)


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None)
    @given(policy=st.sampled_from(["lru", "lfu", "epoch_lru", "epoch_lfu"]),
           dual=st.booleans(), seed=st.integers(0, 2**31),
           key_space=st.sampled_from([50, 300, 5000]))
    def test_merge_matches_oracle(policy, dual, seed, key_space):
        _run_pair(policy, dual, 2 * 128, 2, [48] * 8, key_space, seed)

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2**31), dual=st.booleans())
    def test_merge_matches_oracle_oversubscribed(seed, dual):
        _run_pair("lru", dual, 128, 2, [200, 200, 200], 100_000, seed)

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2**31))
    def test_merge_matches_oracle_heavy_duplicates(seed):
        _run_pair("lfu", False, 128, 2, [64] * 6, 12, seed)

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 2**31), dual=st.booleans())
    def test_custom_scores_match_oracle(seed, dual):
        _custom_scores(seed, dual)

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2**31), dual=st.booleans())
    def test_find_or_insert_matches_oracle(seed, dual):
        _find_or_insert(seed, dual)
