"""The closure's batch-aligned eviction stream (``core.merge.upsert`` with
``return_evicted``), built from the miss prefix alone.

The misses sort first in the closure, so only the prefix ``[:m]`` can
evict; the stream is written at those lanes' own batch positions, which
are distinct, and every other lane keeps its zero row.  Held here:

* on the CPU, against the JAX package (``jnp`` backend): statuses, the
  stream, ``found`` / rows where the entry point returns them, and the
  full state, bit for bit after every batch, through ``insert_and_evict``,
  ``find_or_insert(return_evicted=True)`` and the kernel wrapper
  ``insert_and_evict_kernel``, in both bucket modes under ``lru``,
  ``lfu`` and ``custom``, over batches that reach the prefix's edges
  (m == 0, m == n, every miss rejected, duplicates and EMPTY padding, a
  hit that loses its slot within the batch);
* the same, on seeded random batches into a table filled past capacity;
* the live ``closure.post`` span counts ``stream_rows == m`` when the
  stream is asked for, nothing otherwise, and is the shared no-op with
  tracing off;
* on the card (marked ``cuda``, skips without one): the kernel path's
  stream equals the plain path's at 2^20 lanes on a 2^20-slot table with
  a V = 65 plane, in HBM and on the 'hmem' tier, with one ``gather_rows``
  launch per upsert.

The JAX package is imported inside the tests that compare with it, so the
card's machine, which has no JAX, runs the ``cuda`` case:

    PYTHONPATH=src python -m pytest tests/test_torch_evict_stream.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import merge as pmerge  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.kernels import ops as pk  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
STREAM = ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask")
UPDATED, INSERTED, EVICTED, REJECTED = 1, 2, 3, 4
DIM = 4


def _jax():
    """The JAX package's modules (imported here, not at collection)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import ops as jops
    from repro.core import table as jtable
    from repro.core import u64 as ju64
    return jnp, jops, jtable, ju64


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def _random_batch(rng, n, key_space, dup_frac=0.25, pad_frac=0.05, live=None):
    """Keys with duplicates and EMPTY padding interleaved; with `live`,
    half of them drawn from the table's keys (hits)."""
    keys = rng.integers(0, key_space, size=n).astype(np.uint64)
    if live is not None and len(live):
        half = rng.random(n) < 0.5
        keys[half] = rng.choice(live, size=int(half.sum()))
    ndup = int(n * dup_frac)
    if ndup:
        keys[rng.integers(0, n, size=ndup)] = rng.choice(keys, size=ndup)
    npad = int(n * pad_frac)
    if npad:
        keys[rng.integers(0, n, size=npad)] = EMPTY
    return keys


def _live_keys(state) -> np.ndarray:
    k = state.keys.reshape(-1).numpy().view(np.uint64)
    return k[k != EMPTY]


def _miss_groups(keys, status) -> int:
    """m: distinct keys of the batch that missed (inserted, evicted or
    rejected)."""
    return len(set(keys[np.isin(status, (INSERTED, EVICTED, REJECTED))].tolist()))


class _Pair:
    """One entry point on both sides: the port (CPU) and the JAX package."""

    def __init__(self, entry, dual, policy):
        jnp, self.jops, jtable, self.ju64 = _jax()
        self.jnp, self.entry = jnp, entry
        kw = dict(capacity=2 * 128, dim=DIM, buckets_per_key=2 if dual else 1,
                  score_policy=policy)
        self.cfg_j, self.cfg_p = jtable.HKVConfig(**kw), ptable.HKVConfig(**kw)
        self.sj, self.sp = jtable.create(self.cfg_j), ptable.create(self.cfg_p, "cpu")

    def step(self, keys, vals, scores, ctx):
        """Run one batch on both sides and hold every output and the state;
        returns the port's (status, stream)."""
        jnp, jops, ju64 = self.jnp, self.jops, self.ju64
        cj = None if scores is None else ju64.from_uint64(scores)
        cp = None if scores is None else pu64.from_numpy_u64(scores)
        kj, kp = ju64.from_uint64(keys), pu64.from_numpy_u64(keys)
        vp = torch.from_numpy(vals)
        if self.entry == "find_or_insert":
            rj = jops.find_or_insert(self.sj, self.cfg_j, kj, jnp.asarray(vals), cj,
                                     backend="jnp", return_evicted=True)
            rp = pops.find_or_insert(self.sp, self.cfg_p, kp, vp, cp, backend="plain",
                                     return_evicted=True)
            _eq(rp.found.numpy(), rj.found, f"{ctx}: found")
            _eq(rp.values.numpy(), rj.values, f"{ctx}: values")
        else:
            rj = jops.insert_and_evict(self.sj, self.cfg_j, kj, jnp.asarray(vals), cj,
                                       backend="jnp")
            if self.entry == "insert_and_evict":
                rp = pops.insert_and_evict(self.sp, self.cfg_p, kp, vp, cp, backend="plain")
            else:
                rp = pk.insert_and_evict_kernel(self.sp, self.cfg_p, kp, vp, custom_scores=cp)
        self.sj = rj.state
        _eq(rp.status.numpy(), rj.status, f"{ctx}: status")
        got = convert.stream_to_arrays(rp.evicted)
        for f in STREAM:
            _eq(got[f], getattr(rj.evicted, f), f"{ctx}: evicted.{f}")
        arrays = convert.state_to_arrays(self.sp)
        for f in convert.FIELDS:
            _eq(arrays[f], getattr(rj.state, f), f"{ctx}: state.{f}")
        ev = rp.evicted
        off = ~ev.mask
        assert not ev.keys[off].any() and not ev.scores[off].any(), ctx
        assert not ev.values[off].any(), ctx
        return rp.status.numpy(), ev


def _scores(policy, n, value):
    return np.full(n, value, np.uint64) if policy == "custom" else None


def _vals(rng, n):
    return rng.normal(size=(n, DIM)).astype(np.float32)


@pytest.mark.parametrize("entry", ["insert_and_evict", "find_or_insert",
                                   "insert_and_evict_kernel"])
@pytest.mark.parametrize("policy", ["lru", "lfu", "custom"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_stream_matches_jax_at_the_prefix_edges(dual, policy, entry):
    rng = np.random.default_rng(101 + 7 * dual + len(policy) + len(entry))
    p = _Pair(entry, dual, policy)
    custom = policy == "custom"

    # fill past capacity: inserts, then evictions and rejections
    for i in range(3):
        keys = _random_batch(rng, 160, 2**40)
        sc = rng.integers(100, 1000, size=160).astype(np.uint64) if custom else None
        p.step(keys, _vals(rng, 160), sc, f"fill {i}")
    assert p.sp.load_factor() == 1.0

    # m == 0: every lane a hit
    live = rng.permutation(_live_keys(p.sp))[:200]
    status, ev = p.step(live, _vals(rng, 200), _scores(policy, 200, 2000), "all hits")
    assert (status == UPDATED).all() and not ev.mask.any()

    # m == 0: every lane EMPTY
    keys = np.full(64, EMPTY, np.uint64)
    status, ev = p.step(keys, _vals(rng, 64), _scores(policy, 64, 2000), "all EMPTY")
    assert (status == 0).all() and not ev.mask.any()

    # m == n: distinct misses into the full table; lru's newer clocks and
    # the custom scores above every resident's evict on every lane, lfu's
    # count of 1 beats no resident (each was touched at least once)
    fresh = rng.choice(2**40, size=64, replace=False).astype(np.uint64) + np.uint64(2**45)
    status, ev = p.step(fresh, _vals(rng, 64), _scores(policy, 64, 10**6), "all misses")
    assert _miss_groups(fresh, status) == 64
    if policy == "lfu":
        assert (status == REJECTED).all() and not ev.mask.any()
    else:
        assert (status == EVICTED).all() and bool(ev.mask.all())

    # m > 0, every miss rejected: custom scores below every victim's
    if custom:
        fresh = rng.choice(2**40, size=64, replace=False).astype(np.uint64) + np.uint64(2**46)
        status, ev = p.step(fresh, _vals(rng, 64), _scores(policy, 64, 1), "all rejected")
        assert (status == REJECTED).all() and not ev.mask.any()

    # duplicates and EMPTY padding interleaved, hits and misses
    for i in range(2):
        keys = _random_batch(rng, 160, 2**40, live=_live_keys(p.sp))
        sc = rng.integers(1, 2**20, size=160).astype(np.uint64) if custom else None
        status, ev = p.step(keys, _vals(rng, 160), sc, f"dups and padding {i}")
        assert (status == 0).any() and 0 < _miss_groups(keys, status) < 160

    # a hit that loses its slot within the batch: every resident touched
    # once (custom: to score 1; lfu: one count more), beside misses that
    # outbid them (custom: score 5000; lfu: more duplicates than any
    # resident's count).  lru's clocks never let it happen.
    live = _live_keys(p.sp)
    top = int(p.sp.scores.max())
    miss = rng.choice(2**40, size=16, replace=False).astype(np.uint64) + np.uint64(2**47)
    reps = 1 if policy != "lfu" else top + 2
    keys = np.concatenate([live, np.repeat(miss, reps)])
    sc = np.concatenate([np.full(len(live), 1, np.uint64),
                         np.full(len(miss) * reps, 5000, np.uint64)]) if custom else None
    status, ev = p.step(keys, _vals(rng, len(keys)), sc, "hit loses its slot")
    lost = set(ev.keys[ev.mask].numpy().view(np.uint64).tolist()) & set(live.tolist())
    assert bool(lost) == (policy != "lru")


ENTRIES = ("insert_and_evict", "find_or_insert", "insert_and_evict_kernel")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["lru", "lfu", "custom"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_stream_matches_jax_on_seeded_batches(dual, policy, seed):
    """Seeded random batches (hits, misses, duplicates and EMPTY padding)
    into a table filled past capacity, each entry point in turn: the
    stream, statuses and state bit for bit the JAX package's."""
    rng = np.random.default_rng(1000 * seed + 10 * dual + len(policy))
    p = _Pair(ENTRIES[seed % 3], dual, policy)
    evicted = 0
    for step in range(6):
        keys = _random_batch(rng, 160, 2**30, live=_live_keys(p.sp))
        sc = rng.integers(1, 2**30, size=160).astype(np.uint64) if policy == "custom" else None
        _, ev = p.step(keys, _vals(rng, 160), sc, f"seed {seed} step {step}")
        evicted += int(ev.mask.sum())
    assert evicted > 0


def _post_spans(tr):
    return [s for s in tr.spans if s.name == "closure.post"]


@pytest.mark.parametrize("entry", ["insert_and_evict", "find_or_insert", "insert_or_assign"])
def test_closure_post_counts_the_stream_rows(entry):
    """Under a Tracer, closure.post carries stream_rows == m when the
    stream is asked for and no stream_rows when it is not."""
    rng = np.random.default_rng(7)
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=DIM, buckets_per_key=2)
    state = ptable.create(cfg, "cpu")
    asks = entry != "insert_or_assign"
    call = {"insert_and_evict": lambda k, v: pops.insert_and_evict(state, cfg, k, v),
            "find_or_insert": lambda k, v: pops.find_or_insert(state, cfg, k, v,
                                                               return_evicted=True),
            "insert_or_assign": lambda k, v: pops.insert_or_assign(state, cfg, k, v)}[entry]
    seen = []
    for step in range(4):
        keys = _random_batch(rng, 160, 2**20, live=_live_keys(state))
        tr = trace.Tracer()
        with trace.install(tr):
            res = call(pu64.from_numpy_u64(keys), torch.from_numpy(_vals(rng, 160)))
        (sp,) = _post_spans(tr)
        got = sp.counters()
        if asks:
            seen.append(got["stream_rows"])
            assert got["stream_rows"] == _miss_groups(keys, res.status.numpy()), step
        else:
            assert "stream_rows" not in got
    if asks:
        assert min(seen) > 0 and max(seen) < 160


def test_closure_post_is_the_noop_with_tracing_off(monkeypatch):
    made = []

    def recording(name):
        sp = trace.span(name)
        made.append((name, sp))
        return sp

    monkeypatch.setattr(pmerge, "span", recording)
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=DIM)
    state = ptable.create(cfg, "cpu")
    before = len(trace.recorded())
    for first in (1, 1001):                        # the second batch evicts
        keys = pu64.from_numpy_u64(np.arange(first, first + 300, dtype=np.uint64))
        res = pops.insert_and_evict(state, cfg, keys, torch.zeros((300, DIM)))
    post = [sp for name, sp in made if name == "closure.post"]
    assert post == [trace.NOOP_SPAN] * 2 and res.evicted.mask.any()
    assert len(trace.recorded()) == before


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["hbm", "hmem"])
def test_kernel_stream_equals_the_plain_stream_on_the_card(tier):
    """2^20 lanes on a 2^20-slot table with a V = 65 plane: the kernel
    path's statuses, stream and state equal the plain path's after a
    prefill and two batches past capacity, each upsert one gather_rows
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    from repro_torch.kernels import _build

    n, dim = 2**20, 64
    cfg = ptable.HKVConfig(capacity=2**20, dim=dim, buckets_per_key=2, value_tier=tier,
                           aux_value_dim=1)
    plain, kern = ptable.create(cfg, "cuda"), ptable.create(cfg, "cuda")
    assert kern.values.shape[1] == 65
    g = torch.Generator(device="cuda").manual_seed(3)
    for step in range(3):
        keys = torch.randint(0, 2**40, (n,), device="cuda", generator=g)
        keys[torch.randint(0, n, (n // 20,), device="cuda", generator=g)] = pu64.EMPTY
        vals = torch.randn((n, dim + 1), device="cuda", generator=g)
        want = pmerge.upsert(plain, cfg, keys, vals, return_evicted=True)
        before = _build.launch_counts["gather_rows"]
        got = pk.insert_and_evict_kernel(kern, cfg, keys, vals)
        torch.cuda.synchronize()
        assert _build.launch_counts["gather_rows"] - before == 1, step
        ctx = f"{tier} step {step}"
        assert torch.equal(got.status, want.status), ctx
        for f, a, b in zip(pmerge.EvictionStream._fields, got.evicted, want.evicted):
            assert torch.equal(a, b), f"{ctx}: evicted.{f}"
        for f in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(kern, f), getattr(plain, f)), f"{ctx}: {f}"
        if step:
            assert bool(got.evicted.mask.any()), ctx
