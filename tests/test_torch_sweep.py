"""The port's predicated sweeps (erase_if, evict_if) and SweepPredicate
against the JAX package.

Tables are filled by the same seeded batches on both sides (JAX backend
'jnp', the port on the CPU), then swept with each of the five predicate
kinds; the swept counts, evict_if's coldest-first stream (with `budget`
and `limit`) and the full drained state must be bit-identical, in single
and dual bucket mode under all five score policies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import normalize_keys as jax_keys  # noqa: E402
from repro.core.predicates import SweepPredicate as JaxPredicate  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import SweepPredicate, convert  # noqa: E402
from repro_torch.core import predicates  # noqa: E402

POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")
CAPACITY, DIM, BATCH = 4 * 128, 4, 256


def _pair(policy, dual, seed):
    rng = np.random.default_rng(seed)
    kw = dict(capacity=CAPACITY, dim=DIM, buckets_per_key=2 if dual else 1,
              score_policy=policy)
    jt = JaxTable.create(backend="jnp", **kw)
    pt = repro_torch.HKVTable.create(device="cpu", **kw)
    for step in range(4):
        if policy.startswith("epoch"):
            jt, pt = jt.set_epoch(step), pt.set_epoch(step)
        keys = rng.integers(0, 4 * CAPACITY, size=BATCH).astype(np.uint64)
        keys[rng.integers(0, BATCH, size=BATCH // 8)] |= np.uint64(1 << 63)
        keys[::37] = np.uint64(2**64 - 1)
        vals = rng.normal(size=(BATCH, DIM)).astype(np.float32)
        cs = None
        if policy == "custom":
            cs = rng.integers(0, 2**64 - 1, size=BATCH, dtype=np.uint64)
        jt = jt.insert_or_assign(jax_keys(keys), jnp.asarray(vals),
                                 None if cs is None else jax_keys(cs)).table
        pt.insert_or_assign(keys, vals, cs)
    return rng, jt, pt


def _check_state(jt, pt, ctx):
    got = convert.state_to_arrays(pt.state)
    for f in convert.FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                      err_msg=f"{ctx}: state.{f}")


def _predicates(rng, pt):
    """One JAX predicate of each kind, thresholds drawn from the table's
    live scores and keys (so every kind matches some entries and not all)."""
    live = pt.state.keys.reshape(-1) != -1
    scores = np.sort(pt.state.scores.reshape(-1)[live].numpy().view(np.uint64))
    keys = np.sort(pt.state.keys.reshape(-1)[live].numpy().view(np.uint64))
    mid = lambda a: int(a[len(a) // 2])
    return [JaxPredicate.always(),
            JaxPredicate.score_below(mid(scores)),
            JaxPredicate.score_at_least(mid(scores)),
            JaxPredicate.expire_before(2),
            JaxPredicate.key_in_range(int(keys[len(keys) // 4]), int(keys[3 * len(keys) // 4]))]


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_erase_if_bit_identical(policy, dual):
    rng, jt, pt = _pair(policy, dual, seed=300 + 10 * POLICIES.index(policy) + dual)
    for jp in _predicates(rng, pt)[1:]:
        pp = convert.predicate_from_arrays(jp)
        jr, pr = jt.erase_if(jp), pt.erase_if(pp)
        jt = jr.table
        assert pr.table is pt
        np.testing.assert_array_equal(pr.swept.item(), np.asarray(jr.swept), err_msg=pp.kind)
        _check_state(jt, pt, f"erase_if {pp.kind}")


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_evict_if_bit_identical(policy, dual):
    """Coldest-first streams under every kind, with budgets below and
    above the match count and a limit below the budget."""
    rng, jt, pt = _pair(policy, dual, seed=400 + 10 * POLICIES.index(policy) + dual)
    for i, jp in enumerate(_predicates(rng, pt)):
        pp = convert.predicate_from_arrays(jp)
        budget = (7, 200, 10 * CAPACITY)[i % 3]
        limit = 3 if i == 1 else None
        jr = jt.evict_if(jp, budget, None if limit is None else jnp.int32(limit))
        pr = pt.evict_if(pp, budget, limit)
        jt = jr.table
        got = convert.stream_to_arrays(pr.evicted)
        for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jr.evicted, f)),
                                          err_msg=f"{pp.kind}: evicted.{f}")
        np.testing.assert_array_equal(pr.count.item(), np.asarray(jr.count), err_msg=pp.kind)
        _check_state(jt, pt, f"evict_if {pp.kind}")
        if pr.count > 1:   # coldest first: scores ascending over the live lanes
            sc = pr.evicted.scores[pr.evicted.mask].numpy().view(np.uint64)
            assert (sc[:-1] <= sc[1:]).all()


def test_evict_if_refuses_an_empty_budget():
    t = repro_torch.HKVTable.create(capacity=128, dim=4, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        t.evict_if(SweepPredicate.always(), 0)


WORDS = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
         np.uint64(0xDEADBEEFCAFEBABE), np.array(2**63 + 5, dtype=np.uint64)]


@pytest.mark.parametrize("x", WORDS, ids=str)
def test_predicate_operands_match_jax(x):
    """The constructors' operands: the port's int64 word has the bits of
    JAX's (hi, lo) pair."""
    for name, args in (("score_below", (x,)), ("score_at_least", (x,)),
                       ("key_in_range", (x, 2**64 - 1))):
        jp, pp = getattr(JaxPredicate, name)(*args), getattr(SweepPredicate, name)(*args)
        assert pp == convert.predicate_from_arrays(jp), name
    epoch = int(np.uint64(x)) & 0xFFFFFFFF
    assert SweepPredicate.expire_before(epoch) == convert.predicate_from_arrays(
        JaxPredicate.expire_before(epoch))


def test_predicate_kinds_and_refusals():
    assert predicates.KINDS == ("always", "score_lt", "score_ge", "epoch_lt", "key_range")
    assert [SweepPredicate(k).kind_index for k in predicates.KINDS] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="unknown predicate kind"):
        SweepPredicate("score_gt")
    with pytest.raises(ValueError, match="unsigned"):
        SweepPredicate.score_below(-1)
    assert SweepPredicate.score_below(torch.tensor(-1)).a == -1   # a 64-bit word keeps its bits
    assert SweepPredicate.score_below(torch.tensor(-1, dtype=torch.int32)).a == 2**32 - 1


@pytest.mark.parametrize("kind", predicates.KINDS)
def test_match_planes_matches_jax(kind):
    """The plain formula on raw planes, wide words included, against the
    JAX package's match_planes."""
    from repro.core import predicates as jpred

    rng = np.random.default_rng(8)
    edge = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1],
                    dtype=np.uint64)
    keys = np.concatenate([edge, rng.integers(0, 2**64 - 1, size=120, dtype=np.uint64)])
    scores = np.concatenate([edge[::-1], rng.integers(0, 2**64 - 1, size=120, dtype=np.uint64)])
    a, b = np.uint64(2**63 + 17), np.uint64(2**64 - 3)
    split = lambda w: (np.uint32(int(w) >> 32), np.uint32(int(w) & 0xFFFFFFFF))
    want = jpred.match_planes(kind, *(jnp.asarray(x) for x in (
        (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32),
        (scores >> np.uint64(32)).astype(np.uint32), scores.astype(np.uint32))),
        *split(a), *split(b))
    got = predicates.match_planes(kind, torch.from_numpy(keys.view(np.int64)),
                                  torch.from_numpy(scores.view(np.int64)),
                                  predicates.to_word(a), predicates.to_word(b))
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(want), keys.shape))
