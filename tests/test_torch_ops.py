"""Every op of the port's HKVTable against the JAX package.

One seeded op sequence runs through `repro.core.HKVTable` (backend 'jnp')
and `repro_torch.HKVTable(device='cpu')`: insert_and_evict,
find_or_insert (with and without the eviction stream), find, find_rows,
find_ptr, contains, assign (with and without score touches), assign_add,
assign_scores, ingest, accum_or_assign, insert_or_assign, erase,
export_batch, export_batch_if, size and clear.  After every op the
results (statuses, eviction streams, find_or_insert values, Locates,
exports) and the full drained state (carried across by
`repro_torch.convert`) must be bit-identical, in single and dual bucket
mode under all five score policies.  Batches hold duplicates, EMPTY and
negative padding and keys at or above 2**63; the float sums of duplicated
keys (assign_add, accum_or_assign) are held exact too, since on the CPU
both packages add in batch order.

The last tests run the JAX package's Pallas kernels (interpret mode) on
the ops that reach gather_rows, digest_scan and sweep_match, against the
same ops of the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import normalize_keys as jax_keys  # noqa: E402
from repro.core.predicates import SweepPredicate as JaxPredicate  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as pt_ops  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")
CAPACITY, DIM, AUX, BATCH = 2 * 128, 4, 2, 192


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def assert_state_equal(jt, pt, ctx):
    got = convert.state_to_arrays(pt.state)
    for f in convert.FIELDS:
        _eq(got[f], getattr(jt.state, f), f"{ctx}: state.{f}")


def assert_stream_equal(js, ps, ctx):
    got = convert.stream_to_arrays(ps)
    for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
        _eq(got[f], getattr(js, f), f"{ctx}: evicted.{f}")


def assert_locate_equal(jl, pl, ctx):
    got = convert.locate_to_arrays(pl)
    for f in ("found", "bucket", "slot", "row"):
        _eq(got[f], getattr(jl, f), f"{ctx}: loc.{f}")


def _scores(r):
    return _u64(r.score_hi, r.score_lo)


class Replay:
    """The two tables and the batches fed to both."""

    def __init__(self, policy, dual, seed, aux=AUX, capacity=CAPACITY, batch=BATCH):
        self.policy, self.batch, self.capacity = policy, batch, capacity
        self.rng = np.random.default_rng(seed)
        kw = dict(capacity=capacity, dim=DIM, buckets_per_key=2 if dual else 1,
                  score_policy=policy, aux_value_dim=aux)
        self.jt = JaxTable.create(backend="jnp", **kw)
        self.pt = repro_torch.HKVTable.create(device="cpu", **kw)

    def keys(self, step, unique=False):
        """A batch from a small key space (so later batches hit earlier
        keys), with duplicates, padding and wide keys; even steps numpy
        uint64 with EMPTY padding, odd steps signed int64 with negative
        padding."""
        n, rng = self.batch, self.rng
        keys = rng.integers(0, 6 * self.capacity, size=n).astype(np.uint64)
        if not unique:
            keys[rng.integers(0, n, size=n // 4)] = rng.choice(keys, size=n // 4)
        wide = rng.integers(0, n, size=n // 8)
        keys[wide] |= np.uint64(1 << 63)
        if unique:
            keys = np.unique(keys)
            keys = np.concatenate([keys, np.full(n - len(keys), EMPTY)])
            rng.shuffle(keys)
        if step % 2 == 0:
            keys[rng.integers(0, n, size=4)] = EMPTY
            return keys
        signed = keys.astype(np.int64)
        signed[rng.integers(0, n, size=4)] = -rng.integers(1, 1000, size=4)
        return signed

    def rows(self, width=DIM):
        return self.rng.normal(size=(self.batch, width)).astype(np.float32)

    def custom(self):
        """Caller scores for the custom policy: a narrow range, so that
        existing entries win ties, and a few at or above 2**63."""
        if self.policy != "custom":
            return None
        cs = self.rng.integers(0, 64, size=self.batch).astype(np.uint64)
        cs[self.rng.integers(0, self.batch, size=8)] |= np.uint64(1 << 63)
        return cs

    def check_state(self, ctx):
        assert_state_equal(self.jt, self.pt, ctx)

    # -- one call of each op on both sides, results compared --------------------

    def insert_and_evict(self, keys, vals, cs, ctx):
        jr = self.jt.insert_and_evict(jax_keys(keys), jnp.asarray(vals), _opt(cs))
        pr = self.pt.insert_and_evict(keys, vals, cs)
        self.jt = jr.table
        _eq(pr.status.numpy(), jr.status, f"{ctx}: status")
        assert_stream_equal(jr.evicted, pr.evicted, ctx)
        _eq(pr.evicted.count().item(), jr.evicted.count(), f"{ctx}: count")
        _eq(convert._split(pr.evicted.masked_keys())[0],
            jr.evicted.masked_keys().hi, f"{ctx}: masked_keys")
        return pr

    def find_or_insert(self, keys, init, cs, return_evicted, ctx):
        jr = self.jt.find_or_insert(jax_keys(keys), jnp.asarray(init), _opt(cs),
                                    return_evicted=return_evicted)
        pr = self.pt.find_or_insert(keys, init, cs, return_evicted=return_evicted)
        self.jt = jr.table
        for f in ("values", "found", "status"):
            _eq(getattr(pr, f).numpy(), getattr(jr, f), f"{ctx}: {f}")
        assert_stream_equal(jr.evicted, pr.evicted, ctx)
        return pr

    def readers(self, keys, ctx):
        jk = jax_keys(keys)
        jr, pr = self.jt.find(jk), self.pt.find(keys)
        _eq(pr.values.numpy(), jr.values, f"{ctx}: find.values")
        _eq(pr.found.numpy(), jr.found, f"{ctx}: find.found")
        _eq(pr.scores.numpy().view(np.uint64), _scores(jr), f"{ctx}: find.scores")
        jr, pr = self.jt.find_rows(jk), self.pt.find_rows(keys)
        _eq(pr.rows.numpy(), jr.rows, f"{ctx}: find_rows.rows")
        _eq(pr.found.numpy(), jr.found, f"{ctx}: find_rows.found")
        _eq(pr.row.numpy(), jr.row, f"{ctx}: find_rows.row")
        _eq(pr.scores.numpy().view(np.uint64), _scores(jr), f"{ctx}: find_rows.scores")
        assert_locate_equal(self.jt.find_ptr(jk), self.pt.find_ptr(keys), f"{ctx}: find_ptr")
        _eq(self.pt.contains(keys).numpy(), self.jt.contains(jk), f"{ctx}: contains")
        _eq(self.pt.size(), self.jt.size(), f"{ctx}: size")

    def exports(self, threshold, ctx):
        b = self.pt.num_buckets
        assert b == self.jt.num_buckets
        for start, count in ((0, b), (b - 1, 1)):
            for jr, pr in ((self.jt.export_batch(start, count), self.pt.export_batch(start, count)),
                           (self.jt.export_batch_if(start, count, np.uint64(threshold)),
                            self.pt.export_batch_if(start, count, np.uint64(threshold)))):
                got = convert.export_to_arrays(pr)
                for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
                    _eq(got[f], getattr(jr, f), f"{ctx}: export.{f}")


def _opt(x):
    return None if x is None else jax_keys(x)


def _run(replay: Replay, steps: int):
    """The op sequence; returns the statuses seen by insert_and_evict."""
    seen = set()
    r = replay
    for step in range(steps):
        ctx = f"step {step}"
        if r.policy.startswith("epoch") and step == steps // 2:
            r.jt, r.pt = r.jt.set_epoch(5 + step), r.pt.set_epoch(5 + step)
            assert r.pt.epoch == int(r.jt.epoch)
        keys = r.keys(step)
        pr = r.insert_and_evict(keys, r.rows(DIM + AUX if step % 2 else DIM), r.custom(),
                                ctx + " insert_and_evict")
        seen.update(pr.status.tolist())
        r.check_state(ctx + " insert_and_evict")

        mix = r.keys(step + 1)
        mix[: r.batch // 2] = keys[: r.batch // 2].astype(mix.dtype)
        r.find_or_insert(mix, r.rows(), r.custom(), step % 2 == 0, ctx + " find_or_insert")
        r.check_state(ctx + " find_or_insert")

        r.readers(mix, ctx + " readers")

        upd = r.rows(DIM + AUX if step % 2 else DIM)
        update_scores = step % 2 == 1 and r.policy != "custom"
        r.jt = r.jt.assign(jax_keys(mix), jnp.asarray(upd), update_scores=update_scores)
        assert r.pt.assign(mix, upd, update_scores=update_scores) is r.pt
        r.check_state(ctx + " assign")

        deltas = r.rows()
        r.jt = r.jt.assign_add(jax_keys(mix), jnp.asarray(deltas))
        r.pt.assign_add(mix, deltas)
        r.check_state(ctx + " assign_add")

        sc = r.rng.integers(0, 2**64 - 1, size=r.batch, dtype=np.uint64)
        r.jt = r.jt.assign_scores(jax_keys(mix), jax_keys(sc))
        r.pt.assign_scores(mix, sc)
        r.check_state(ctx + " assign_scores")

        k2, cs, init = r.keys(step), r.custom(), r.rows()
        jr = r.jt.ingest(jax_keys(k2), jnp.asarray(init), _opt(cs))
        pr = r.pt.ingest(k2, init, cs)
        r.jt = jr.table
        _eq(pr.status.numpy(), jr.status, ctx + " ingest status")
        _eq(pr.ok.numpy(), jr.ok, ctx + " ingest ok")
        r.check_state(ctx + " ingest")

        k3, v3, cs = r.keys(step), r.rows(), r.custom()
        jr = r.jt.accum_or_assign(jax_keys(k3), jnp.asarray(v3), _opt(cs))
        pr = r.pt.accum_or_assign(k3, v3, cs)
        r.jt = jr.table
        _eq(pr.status.numpy(), jr.status, ctx + " accum_or_assign status")
        r.check_state(ctx + " accum_or_assign")

        k4, v4, cs = r.keys(step), r.rows(), r.custom()
        jr = r.jt.insert_or_assign(jax_keys(k4), jnp.asarray(v4), _opt(cs))
        pr = r.pt.insert_or_assign(k4, v4, cs)
        r.jt = jr.table
        _eq(pr.status.numpy(), jr.status, ctx + " insert_or_assign status")
        r.check_state(ctx + " insert_or_assign")

        r.exports(int(r.rng.integers(0, 2**64 - 1, dtype=np.uint64)) if r.policy == "custom"
                  else int(np.asarray(r.jt.state.clock_lo)) // 2, ctx)

        gone = k4[: r.batch // 3]
        r.jt, _ = r.jt.erase(jax_keys(gone)), r.pt.erase(gone)
        r.check_state(ctx + " erase")
        r.readers(k4, ctx + " readers after erase")

        if step == steps - 2:
            r.jt = r.jt.clear()
            assert r.pt.clear() is r.pt
            r.check_state(ctx + " clear")
    return seen


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_op_sequence_bit_identical(policy, dual):
    replay = Replay(policy, dual, seed=2000 + 10 * POLICIES.index(policy) + dual)
    seen = _run(replay, steps=4)
    assert {pt_ops.STATUS_EVICTED, pt_ops.STATUS_REJECTED} & seen


def test_find_or_insert_reports_a_hit_that_lost_its_slot():
    """A hit whose custom score drops below the batch's admitted misses is
    evicted by them within the same call: find_or_insert must report it
    gone (found-before True, value = the caller's init row), as the
    reference does."""
    r = Replay("custom", dual=False, seed=5, aux=0, capacity=128, batch=130)
    resident = np.arange(1, 129, dtype=np.uint64)
    fill = np.concatenate([resident, [EMPTY, EMPTY]]).astype(np.uint64)
    r.insert_and_evict(fill, r.rows(), np.full(130, 50, np.uint64), "fill")
    keys = np.concatenate([[np.uint64(7)], np.arange(1000, 1129, dtype=np.uint64)])
    cs = np.concatenate([[np.uint64(1)], np.full(129, 100, np.uint64)])
    init = r.rows()
    pr = r.find_or_insert(keys, init, cs, True, "hit loses its slot")
    r.check_state("after")
    assert bool(pr.found[0]) and not bool(r.pt.contains(keys[:1])[0])
    np.testing.assert_array_equal(pr.values[0].numpy(), init[0])


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_loc_seam_equals_the_closures_own_locate(dual):
    """insert_and_evict and find_or_insert with a caller's `loc` (the
    probe-sharing seam) equal the same ops without it."""
    a, b = (Replay("lfu", dual, seed=9) for _ in range(2))
    for step in range(3):
        keys, vals = a.keys(step), a.rows()
        b.keys(step), b.rows()
        loc = a.pt.find_ptr(keys)
        ra = pt_ops.insert_and_evict(a.pt.state, a.pt.cfg, a.pt.keys(keys), torch.from_numpy(vals),
                                     loc=loc)
        rb = b.pt.insert_and_evict(keys, vals)
        assert torch.equal(ra.status, rb.status)
        for x, y in zip(ra.evicted, rb.evicted):
            assert torch.equal(x, y)
        loc = a.pt.find_ptr(keys)
        fa = pt_ops.find_or_insert(a.pt.state, a.pt.cfg, a.pt.keys(keys), torch.from_numpy(vals),
                                   loc=loc)
        fb = b.pt.find_or_insert(keys, vals)
        assert torch.equal(fa.values, fb.values) and torch.equal(fa.status, fb.status)
        for f in convert.FIELDS:
            np.testing.assert_array_equal(convert.state_to_arrays(a.pt.state)[f],
                                          convert.state_to_arrays(b.pt.state)[f])


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_upsert_options_match_jax(policy, dual):
    """merge.upsert with the options no handle op sets (hit scores left
    alone, distinct insertion rows), with and without hit writes, against
    the reference's merge.upsert: statuses, eviction streams, found, the
    post-op locations and the full state."""
    from repro.core import merge as jax_merge
    from repro_torch.core import merge as pt_merge

    r = Replay(policy, dual, seed=70 + 10 * POLICIES.index(policy) + dual)
    for step in range(3):
        r.insert_and_evict(r.keys(step), r.rows(), r.custom(), f"fill {step}")
    for step, write_hit_values in enumerate((True, False)):
        keys = r.keys(step + 3)
        keys[: r.batch // 2] = r.keys(step)[: r.batch // 2].astype(keys.dtype)
        vals, ins, cs = r.rows(DIM + AUX), r.rows(DIM + AUX), r.custom()
        opts = dict(write_hit_values=write_hit_values, update_hit_scores=False,
                    return_evicted=True)
        jr = jax_merge.upsert(r.jt.state, r.jt.cfg, jax_keys(keys), jnp.asarray(vals),
                              custom_scores=_opt(cs), insert_values=jnp.asarray(ins), **opts)
        pr = pt_merge.upsert(r.pt.state, r.pt.cfg, r.pt.keys(keys), torch.from_numpy(vals),
                             custom_scores=r.pt._opt_keys(cs), insert_values=torch.from_numpy(ins),
                             **opts)
        r.jt = JaxTable(state=jr.state, cfg=r.jt.cfg, backend=r.jt.backend)
        ctx = f"write_hit_values={write_hit_values}"
        _eq(pr.status.numpy(), jr.status, f"{ctx}: status")
        _eq(pr.found.numpy(), jr.found, f"{ctx}: found")
        assert_stream_equal(jr.evicted, pr.evicted, ctx)
        assert_locate_equal(jr.loc, pr.loc, ctx)
        r.check_state(ctx)
        assert (pr.status == pt_ops.STATUS_UPDATED).any(), f"{ctx}: no hit in the batch"


def test_dedupe_keys_matches_jax():
    from repro.core.api import dedupe_keys as jax_dedupe

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, size=200).astype(np.uint64)
    keys[::7] = EMPTY
    keys[::11] |= np.uint64(1 << 63)
    jd, pd = jax_dedupe(keys), repro_torch.dedupe_keys(keys)
    np.testing.assert_array_equal(pd.unique.numpy().view(np.uint64), _u64(jd.unique.hi, jd.unique.lo))
    for f in ("idx_sorted", "gid", "rep_mask", "last_index", "inverse"):
        np.testing.assert_array_equal(getattr(pd, f).numpy(), np.asarray(getattr(jd, f)), err_msg=f)


def test_handle_surface():
    t = repro_torch.HKVTable.create(capacity=128, dim=4, device="cpu")
    assert t.num_buckets == 1 and t.epoch == 0 and t.cfg.buckets_per_key == 1
    assert t.set_epoch(3).epoch == 3
    u = t.with_backend("plain")
    assert u.state is t.state and u.backend == "plain"
    w = repro_torch.HKVTable.wrap(t.state, t.cfg)
    assert w.state is t.state
    r = t.insert_or_assign([1, 2, -1], np.ones((3, 4), np.float32))
    assert r.table is t and r.ok.tolist() == [True, True, False]
    assert u.size() == 2
    p = t.probe_keys([1, 2])
    assert p.bucket1.tolist() == [0, 0] and p.valid.all()
    s = t.snapshot()
    t.clear()
    assert t.size() == 0 and s.size() == 2 and t.state.clock == s.state.clock


# -- the JAX package's Pallas kernels (interpret mode) against the port ------


def _kernel_pair(dual, policy="lfu"):
    """A small JAX table on backend 'kernel' and its port twin, filled past
    λ = 1.0 by plain upserts on both sides."""
    r = Replay(policy, dual, seed=31 + dual, aux=0, capacity=4 * 128, batch=64)
    for step in range(12):
        keys, vals = r.keys(step, unique=True), r.rows()
        r.jt = r.jt.insert_or_assign(jax_keys(keys), jnp.asarray(vals)).table
        r.pt.insert_or_assign(keys, vals)
    r.check_state("filled")
    r.jt = r.jt.with_backend("kernel")
    return r


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_digest_scan_path_matches_jax_kernel(dual):
    """find_ptr / contains: JAX's digest_scan locate kernel vs the port."""
    r = _kernel_pair(dual)
    keys = r.keys(0)
    keys[: r.batch // 2] = r.pt.state.keys.reshape(-1)[: r.batch // 2].numpy().view(np.uint64)
    assert_locate_equal(r.jt.find_ptr(jax_keys(keys)), r.pt.find_ptr(keys), "find_ptr kernel")
    _eq(r.pt.contains(keys).numpy(), r.jt.contains(jax_keys(keys)), "contains kernel")


def test_gather_rows_path_matches_jax_kernel():
    """insert_and_evict and find_or_insert on JAX's kernel path (the
    evicted rows and the readback through gather_rows) vs the port."""
    r = _kernel_pair(dual=True)
    keys = r.keys(1)
    r.insert_and_evict(keys, r.rows(), None, "insert_and_evict kernel")
    r.check_state("insert_and_evict kernel")
    mix = r.keys(2)
    mix[:20] = keys[:20]
    r.find_or_insert(mix, r.rows(), None, True, "find_or_insert kernel")
    r.check_state("find_or_insert kernel")


def test_sweep_match_path_matches_jax_kernel():
    """erase_if and evict_if on JAX's sweep kernel vs the port."""
    r = _kernel_pair(dual=False)
    jp = JaxPredicate.key_in_range(0, 3 * 4 * 128)
    jr, pr = r.jt.erase_if(jp), r.pt.erase_if(convert.predicate_from_arrays(jp))
    r.jt = jr.table
    _eq(pr.swept.item(), jr.swept, "swept")
    r.check_state("erase_if kernel")
    jp = JaxPredicate.always()
    jr = r.jt.evict_if(jp, budget=40)
    pr = r.pt.evict_if(convert.predicate_from_arrays(jp), budget=40)
    r.jt = jr.table
    assert_stream_equal(jr.evicted, pr.evicted, "evict_if kernel")
    _eq(pr.count.item(), jr.count, "count")
    r.check_state("evict_if kernel")
