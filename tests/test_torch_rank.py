"""The closure's rank stage (``merge.run_rank``) and the closure's
rejections by rank.

* ``run_rank`` equals the scan formula it replaced,
  ``iota - cummax(where(is_new, iota, -1))``, on sorted inputs of every
  shape the closure can hand it: empty, one lane, one run, all distinct,
  runs longer than a bucket, a tail of the non-miss sentinel.
* The same on the card, at an ingest batch's 2^20 lanes (marked `cuda`,
  skips without a card).
* ``merge.upsert`` on the plain stages, when more misses target one bucket
  than it has slots, against the port's sequential oracle: the statuses of
  every batch and all four planes, bucket by bucket, after every batch.

Imports no JAX, so the card's machine runs it whole:

    PYTHONPATH=src python -m pytest tests/test_torch_rank.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import find as find_mod  # noqa: E402
from repro_torch.core import merge, ops, table, u64  # noqa: E402
from repro_torch.core.oracle import OracleTable  # noqa: E402

S = 128   # slots per bucket


def _scan_rank(sorted_ids):
    """The closure's rank before run_rank: a max-scan of run starts."""
    n = sorted_ids.shape[0]
    iota = torch.arange(n, device=sorted_ids.device)
    is_new = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return iota - torch.cummax(torch.where(is_new, iota, -1), 0).values


def _sorted(ids, sentinel=None, tail=0):
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    if tail:
        ids = torch.cat([ids, torch.full((tail,), sentinel, dtype=torch.int64)])
    return torch.sort(ids).values


def _random_runs(n, distinct, seed, sentinel=None, tail=0):
    g = np.random.default_rng(seed)
    return _sorted(g.integers(0, distinct, size=n), sentinel, tail)


CASES = {
    "empty": lambda: _sorted([]),
    "one_lane": lambda: _sorted([7]),
    "one_sentinel_lane": lambda: _sorted([], sentinel=4, tail=1),
    "one_run": lambda: _sorted([3] * 300),
    "all_distinct": lambda: _sorted(np.arange(257) * 5),
    "run_past_a_bucket": lambda: _sorted([0] * 5 + [1] * (3 * S + 17) + [2] * S + [9]),
    "sentinel_tail": lambda: _sorted([0, 0, 2, 3, 3, 3], sentinel=4, tail=200),
    "all_sentinel": lambda: _sorted([], sentinel=64, tail=1000),
    "few_distinct": lambda: _random_runs(1000, 3, 0),
    "many_distinct": lambda: _random_runs(1000, 10_000, 1),
    "ingest_like": lambda: _random_runs(65_536, 512, 2, sentinel=512, tail=4096),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_rank_equals_the_scan_formula(case):
    ids = CASES[case]()
    got, want = merge.run_rank(ids), _scan_rank(ids)
    assert got.dtype == torch.int64 and got.shape == ids.shape
    assert torch.equal(got, want)
    if case == "run_past_a_bucket":      # ranks ≥ S stay exact: admission tests rank < S
        assert int(got.max()) == 3 * S + 16


@pytest.mark.cuda
def test_run_rank_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # An ingest batch: 2^20 miss lanes over 2^20 buckets of a 2^27-slot
    # table, the sentinel b on the lanes that did not miss.
    b = 2**20
    ids = _random_runs(2**20 - 2**14, b, 3, sentinel=b, tail=2**14)
    got = merge.run_rank(ids.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), merge.run_rank(ids))
    assert torch.equal(got.cpu(), _scan_rank(ids))


# =============================================================================
# the closure's rejections by rank, against the oracle
# =============================================================================


def _keys_routed(cfg, bucket, count, rng, to=True):
    """`count` distinct keys whose every candidate bucket is `bucket`
    (`to`), or none of whose candidates is."""
    out = np.empty(0, np.uint64)
    while out.size < count:
        cand = rng.integers(0, 2**63, size=64 * count, dtype=np.uint64)
        p = find_mod.probe_keys(cfg, u64.from_numpy_u64(cand))
        there = ((p.bucket1 == bucket) & (p.bucket2 == bucket) if to
                 else (p.bucket1 != bucket) & (p.bucket2 != bucket))
        out = np.unique(np.concatenate([out, cand[there.numpy()]]))
    return rng.permutation(out)[:count]


def _assert_planes_match(state, cfg, orc):
    """Keys, digests, scores and values of every bucket, as sets of slots."""
    keys = state.keys.numpy().view(np.uint64)
    scores = state.scores.numpy().view(np.uint64)
    digests = state.digests.numpy()
    values = state.values.numpy()
    for bkt in range(cfg.num_buckets):
        live = keys[bkt] != u64.EMPTY_KEY
        want = orc.buckets[bkt]
        assert sorted(int(k) for k in keys[bkt][live]) == sorted(want), bkt
        lk = keys[bkt][live]
        want_dig = find_mod.probe_keys(cfg, u64.from_numpy_u64(lk)).digest.numpy()
        np.testing.assert_array_equal(digests[bkt][live], want_dig.astype(digests.dtype))
        for k, sc, row in zip(lk, scores[bkt][live], values[bkt * S:(bkt + 1) * S][live]):
            e = want[int(k)]
            assert int(sc) == e.score
            np.testing.assert_array_equal(row[:cfg.dim], e.value)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_upsert_rejects_by_rank_as_the_oracle(policy, dual):
    """More misses than slots target bucket 1 of four: the lanes ranked S
    and past are refused whatever the victim at the clipped rank holds."""
    rng = np.random.default_rng(17 + dual)
    bpk = 2 if dual else 1
    cfg = table.HKVConfig(capacity=4 * S, dim=3, buckets_per_key=bpk, score_policy=policy)
    state = table.create(cfg, "cpu")
    orc = OracleTable(4 * S, 3, buckets_per_key=bpk, policy=policy)
    hot = _keys_routed(cfg, 1, 3 * S, rng)
    cold = _keys_routed(cfg, 1, 3 * 40, rng, to=False)
    batches = [hot[:S + 72],                                 # an empty bucket: 72 by rank
               np.concatenate([hot[S:2 * S + 40], hot[:30]]),  # past λ 1 with hits
               hot[S // 2:]]
    rejected = []
    for i, keys_np in enumerate(batches):
        # lanes elsewhere in the table, and a sentinel lane, around the hot run
        keys_np = np.concatenate([keys_np, cold[40 * i:40 * (i + 1)],
                                  np.array([u64.EMPTY_KEY], np.uint64)])
        keys_np = rng.permutation(keys_np)
        vals_np = rng.normal(size=(keys_np.size, 3)).astype(np.float32)
        res = ops.insert_or_assign(state, cfg, u64.from_numpy_u64(keys_np),
                                   torch.from_numpy(vals_np))
        want = np.asarray(orc.insert_or_assign(keys_np, vals_np), np.int8)
        got = res.status.numpy()
        assert np.array_equal(got, want), f"batch {i}: {np.nonzero(got != want)[0][:8]}"
        rejected.append(int((got == merge.STATUS_REJECTED).sum()))
        _assert_planes_match(state, cfg, orc)
    assert rejected[0] == 72           # the bucket was empty: refused by rank alone
    assert min(rejected[1:]) > 0
