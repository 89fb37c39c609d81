"""The port's sharded table (``repro_torch.distributed``) against the JAX
package's ``repro.distributed.table_sharding``.

  * Routing: the port's `_owner` and `_route` against the reference's on
    the same keys (both are plain functions outside ``shard_map``): send
    buffers and key slots bit for bit, with keys overflowing `cap`.
  * A 1-shard mesh, in-process: every op of the surface on both packages
    (the JAX side through jitted wrappers, as its conformance suite
    drives a sharded table), flat and tiered shards; every result and the
    full state after each op.
  * ("data", "model") (2, 4) and ("data",) (8,) meshes: a JAX subprocess
    with eight forced host devices (JAX must see the flag before it is
    imported, and this process has imported it) runs a scripted sequence
    and writes every input, result and state to an ``.npz``; the port
    replays it on a CPU mesh of the same shape.

The JAX side compiles without XLA's backend optimizations (a third less
compile time, which is most of this file's): its results are the same bit
for bit but for the row mean below, whose summation order it may change.

Keys, digests, scores, statuses, found flags, overflow counts, eviction
streams, export lanes and sizes are held bit for bit, and so are copied
values; values the sparse optimizer computed (rowwise_adagrad's row mean,
a reduction summed in other orders) within a relative 1e-6: each row's
largest difference against its largest magnitude, as in
``test_torch_update.py``.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import U64  # noqa: E402
from repro.core.predicates import SweepPredicate as JPred  # noqa: E402
from repro.distributed.table_sharding import ShardedHKVEmbedding as JSEmb  # noqa: E402
from repro.distributed.table_sharding import ShardedHKVTable as JSharded  # noqa: E402
from repro.embedding.dynamic import HKVEmbedding as JEmb  # noqa: E402
from repro.embedding.sparse_opt import SparseOptimizer as JOpt  # noqa: E402
from repro.maintenance import stats as jstats  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import (KVTable, ShardedHKVTable, SweepPredicate, convert,  # noqa: E402
                         make_dev_mesh, make_mesh)
from repro_torch.core import u64  # noqa: E402
from repro_torch.distributed import all_to_all  # noqa: E402
from repro_torch.distributed import table_sharding as pts  # noqa: E402
from repro_torch.embedding import HKVEmbedding, SparseOptimizer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
DIM = 4
RTOL = 1e-6


def _planes(keys):
    keys = np.asarray(keys, np.uint64)
    return (jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, ctx):
    np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=ctx)


def _close(got, want, ctx, rtol=RTOL):
    """Row-relative: each row's largest difference within `rtol` of its
    largest magnitude (exact where rtol is 0)."""
    got, want = _np(got), np.asarray(want)
    if not rtol:
        np.testing.assert_array_equal(got, want, err_msg=ctx)
        return
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    diff, scale = np.abs(got - want).max(axis=1), np.abs(want).max(axis=1)
    assert (diff <= rtol * scale).all(), f"{ctx}: row error {np.max(diff / np.maximum(scale, 1e-30))}"


def _keys(rng, n, empty_every=0, dup=0):
    """n uint64 keys over the whole 64-bit range (so some are >= 2^63),
    with EMPTY padding every `empty_every` lanes and `dup` repeated keys."""
    k = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64)
    if dup:
        k[n // 2: n // 2 + dup] = k[:dup]
    if empty_every:
        k[::empty_every] = EMPTY
    return k


@pytest.fixture(scope="module", autouse=True)
def _jax_unoptimized():
    """The JAX side's programs compiled without most optimizations (see the
    module note), for this module only."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


# =============================================================================
# Routing units
# =============================================================================


@pytest.mark.parametrize("n_shards,cap,n", [(8, 8, 256), (8, 16, 100), (3, 8, 64),
                                            (1, 8, 50), (8, 64, 256)])
def test_route_matches_the_reference(n_shards, cap, n):
    rng = np.random.default_rng(n_shards * 1000 + cap + n)
    keys = _keys(rng, n, empty_every=7)
    jsemb = JSEmb(emb=JEmb(capacity=8 * 128, dim=DIM), axis_names=("d",))
    psemb = pts.ShardedHKVEmbedding(emb=HKVEmbedding(capacity=8 * 128, dim=DIM),
                                    axis_names=("d",))
    pk = u64.from_numpy_u64(keys)
    _eq(psemb._owner(pk, n_shards), jsemb._owner(U64(*_planes(keys)), n_shards), "owner")
    sh, sl, slot = jsemb._route(U64(*_planes(keys)), n_shards, cap)
    got = psemb._route(pk, n_shards, cap)
    _eq(got.send.numpy().view(np.uint64), _u64(sh, sl), "send buffers")
    _eq(got.key_slot, slot, "key slots")
    if n_shards == 8 and cap == 8:
        assert (got.key_slot.numpy() < 0).sum() > (keys == EMPTY).sum()   # keys overflowed


def test_cap_matches_the_reference():
    jsemb = JSEmb(emb=JEmb(capacity=8 * 128, dim=DIM), axis_names=("d",), capacity_factor=0.5)
    psemb = pts.ShardedHKVEmbedding(emb=HKVEmbedding(capacity=8 * 128, dim=DIM),
                                    axis_names=("d",), capacity_factor=0.5)
    for per, n in [(1, 1), (256, 8), (1000, 3), (32768 * 26 // 8, 8)]:
        assert psemb._cap(per, n) == jsemb._cap(per, n)


def test_all_to_all_on_one_device_and_across_devices():
    """Chunk d of source s lands at position s of destination d; the
    copies between distinct devices (cpu and cpu:0 here) give the same."""
    n, cap = 4, 3
    chunks = [torch.arange(n * cap).reshape(n, cap) + 100 * s for s in range(n)]
    one = all_to_all(chunks, [torch.device("cpu")] * n)
    many = all_to_all(chunks, [torch.device("cpu")] + [torch.device("cpu", 0)] * (n - 1))
    for d in range(n):
        want = torch.stack([chunks[s][d] for s in range(n)])
        assert torch.equal(one[d], want) and torch.equal(many[d], want)


def test_layout_orders_shards_and_picks_replica_zero():
    lay = pts.layout(make_dev_mesh(2, 4, device="cpu"), ("data", "model"))
    assert lay.n_shards == 8 and lay.n_data == 2
    assert lay.chunk == (0, 0, 0, 0, 1, 1, 1, 1) and lay.primaries == (0, 4)
    lay = pts.layout(make_mesh((2, 4), ("model", "data"), device="cpu"), ("model", "data"))
    assert lay.chunk == (0, 1, 2, 3, 0, 1, 2, 3) and lay.primaries == (0, 1, 2, 3)
    with pytest.raises(ValueError, match="shard axis"):
        pts.layout(make_dev_mesh(2, 4, device="cpu"), ("model",))


# =============================================================================
# A 1-shard mesh, in-process, against the reference's jitted ops
# =============================================================================


@jax.jit
def _j_ins(t, kh, kl, v):
    r = t.insert_or_assign(U64(kh, kl), v)
    return r.table, r.status, r.overflow


@jax.jit
def _j_find(t, kh, kl):
    r = t.find(U64(kh, kl))
    return r.table, r.values, r.found, r.overflow


@jax.jit
def _j_find_pure(t, kh, kl):
    r = t.find(U64(kh, kl), promote=False)
    return r.values, r.found, r.overflow


@jax.jit
def _j_foi(t, kh, kl):
    r = t.find_or_insert(U64(kh, kl))
    return r.table, r.values, r.found, r.overflow


@jax.jit
def _j_contains(t, kh, kl):
    return t.contains(U64(kh, kl))


@jax.jit
def _j_assign(t, kh, kl, v):
    return t.assign(U64(kh, kl), v)


@jax.jit
def _j_erase(t, kh, kl):
    return t.erase(U64(kh, kl))


@jax.jit
def _j_erase_if(t, pred):
    r = t.erase_if(pred)
    return r.table, r.swept


@jax.jit
def _j_evict_if(t, pred):
    r = t.evict_if(pred, 16)
    return r.table, r.evicted, r.count


@jax.jit
def _j_size(t):
    return t.size()


@jax.jit
def _j_clear(t):
    return t.clear()


@jax.jit
def _j_lookup(t, toks):
    return t.lookup(toks, train=True)


@jax.jit
def _j_serve(t, toks):       # on tiered shards a serving lookup promotes
    return t.lookup(toks, train=False)


@jax.jit
def _j_grads(t, toks, g):
    return t.apply_grads(toks, g)


@jax.jit
def _j_export(t):            # every bucket range at once: one compilation
    return t.export_batch(0, t.num_buckets)


def _jax_state(t):
    st = t.state
    if hasattr(st, "hot"):
        return {tier: {f: np.asarray(getattr(getattr(st, tier), f)) for f in convert.FIELDS}
                for tier in ("hot", "cold")}
    return {f: np.asarray(getattr(st, f)) for f in convert.FIELDS}


def _same_state(pt, want, ctx, rtol=0.0):
    got = convert.sharded_state_to_arrays(pt.state)
    if "hot" in want:
        for tier in ("hot", "cold"):
            _same_leaves(got[tier], want[tier], f"{ctx}: {tier}", rtol)
    else:
        _same_leaves(got, want, ctx, rtol)


def _same_leaves(got, want, ctx, rtol):
    for f in convert.FIELDS:
        if f == "values":
            _close(got[f], want[f], f"{ctx}: {f}", rtol)
        else:
            _eq(got[f], want[f], f"{ctx}: {f}")


class OneShard:
    """The reference's 1-device-mesh table and the port's, driven alike."""

    def __init__(self, tiered: bool):
        kw = dict(capacity=4 * 128, dim=DIM, optimizer=JOpt("rowwise_adagrad", lr=0.5))
        pkw = dict(capacity=4 * 128, dim=DIM, optimizer=SparseOptimizer("rowwise_adagrad",
                                                                         lr=0.5))
        if tiered:
            # the JAX side's cold tier in 'hbm': jax 0.9.0 refuses 'hmem' in
            # one op with 'hbm' planes; no result depends on the placement
            kw.update(hot_capacity=128, cold_value_tier="hbm")
            pkw.update(hot_capacity=128)
        self.j = JSharded.create(jax.make_mesh((1,), ("d",)), JEmb(**kw))
        self.p = ShardedHKVTable.create(make_mesh((1,), ("d",), device="cpu"),
                                        HKVEmbedding(**pkw))
        self.check("create")

    def check(self, ctx, rtol=0.0):
        _same_state(self.p, _jax_state(self.j), ctx, rtol)

    def ins(self, k, v, ctx):
        self.j, st, ovf = _j_ins(self.j, *_planes(k), jnp.asarray(v))
        r = self.p.insert_or_assign(k, torch.from_numpy(v))
        assert r.table is self.p
        _eq(r.status, st, f"{ctx}: status")
        _eq(r.ok, (np.asarray(st) >= 1) & (np.asarray(st) <= 3), f"{ctx}: ok")
        assert int(r.overflow) == int(ovf)
        self.check(ctx)
        return r

    def find(self, k, ctx, promote=True):
        if promote:
            self.j, vals, found, ovf = _j_find(self.j, *_planes(k))
        else:
            vals, found, ovf = _j_find_pure(self.j, *_planes(k))
        r = self.p.find(k, promote=promote)
        _eq(r.values, vals, f"{ctx}: values")
        _eq(r.found, found, f"{ctx}: found")
        assert int(r.overflow) == int(ovf) and r.table is self.p
        self.check(ctx)
        return r

    def foi(self, k, ctx):
        self.j, vals, found, ovf = _j_foi(self.j, *_planes(k))
        r = self.p.find_or_insert(k)
        _eq(r.values, vals, f"{ctx}: values")
        _eq(r.found, found, f"{ctx}: found")
        assert int(r.overflow) == int(ovf)
        self.check(ctx)
        return r


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_one_shard_every_op_matches_the_reference(tiered):
    rng = np.random.default_rng(11 + tiered)
    t = OneShard(tiered)
    n = 1024          # 256 keys a bucket of 128 slots: some are rejected
    batches = [(_keys(rng, n, empty_every=9, dup=8),
                rng.normal(size=(n, DIM)).astype(np.float32)) for _ in range(3)]
    statuses = [t.ins(k, v, f"insert {i}").status for i, (k, v) in enumerate(batches)]
    hist = np.bincount(np.concatenate([_np(s) for s in statuses]).astype(np.int64),
                       minlength=5)
    assert hist[3] > 0 and hist[4] > 0, hist          # past λ 1.0: evicted and rejected
    k2, k3 = batches[1][0], batches[2][0]
    mix = np.concatenate([k3[: n // 2], k2[: n // 4], _keys(rng, n // 4)])
    t.find(mix, "find (pure)", promote=False)
    t.find(mix, "find")
    t.foi(np.concatenate([k3[: n // 2], _keys(rng, n // 2)]), "find_or_insert")
    _eq(t.p.contains(mix), _j_contains(t.j, *_planes(mix)), "contains")
    w = rng.normal(size=(n, DIM)).astype(np.float32)
    t.j = _j_assign(t.j, *_planes(mix), jnp.asarray(w))
    assert t.p.assign(mix, torch.from_numpy(w)) is t.p
    t.check("assign")
    t.find(mix, "find after assign", promote=False)
    t.j = _j_erase(t.j, *_planes(mix[::2].repeat(2)))
    t.p.erase(mix[::2].repeat(2))
    t.check("erase")
    pred = (2**62, 2**63 + 2**61)
    t.j, swept = _j_erase_if(t.j, JPred.key_in_range(*pred))
    r = t.p.erase_if(SweepPredicate.key_in_range(*pred))
    assert int(r.swept) == int(swept) > 0
    t.check("erase_if")
    t.j, ev, cnt = _j_evict_if(t.j, JPred.always())
    r = t.p.evict_if(SweepPredicate.always(), 16)
    assert int(r.count) == int(cnt) > 0
    got = convert.stream_to_arrays(r.evicted)
    for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
        _eq(got[f], getattr(ev, f), f"evict_if stream {f}")
    t.check("evict_if")
    assert t.p.num_buckets == t.j.num_buckets
    whole = t.p.export_batch(0, t.p.num_buckets)
    got, want = convert.export_to_arrays(whole), _j_export(t.j)
    for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
        _eq(got[f], getattr(want, f), f"export_batch {f}")
    # one shard: bucket by bucket is the whole range in order
    per = [t.p.export_batch(b, 1) for b in range(t.p.num_buckets)]
    for f, x in zip(whole._fields, whole):
        assert torch.equal(torch.cat([getattr(e, f) for e in per]), x), f
    assert t.p.size() == int(_j_size(t.j))
    assert t.p.capacity == t.j.capacity and t.p.n_shards == t.j.n_shards == 1
    _stats_match(t.p, t.j)
    toks = rng.integers(0, 3000, size=(4, 32)).astype(np.int32)
    toks[0, :5] = -1
    t.j, rows, ovf = _j_lookup(t.j, jnp.asarray(toks))
    _pt, prow, povf = t.p.lookup(toks, train=True)
    _eq(prow, rows, "lookup(train=True)")
    assert int(povf) == int(ovf)
    t.check("lookup")
    g = rng.normal(size=(4, 32, DIM)).astype(np.float32)
    t.j = _j_grads(t.j, jnp.asarray(toks), jnp.asarray(g))
    assert t.p.apply_grads(toks, torch.from_numpy(g)) is t.p
    t.check("apply_grads", rtol=RTOL)
    t.j, rows, ovf = _j_serve(t.j, jnp.asarray(toks))
    _close(t.p.lookup(toks, train=False)[1], rows, "lookup(train=False)")
    t.check("lookup(train=False)", rtol=RTOL)
    t.j = _j_clear(t.j)
    t.p.clear()
    t.check("clear", rtol=RTOL)
    assert t.p.size() == 0


def _stats_match(pt, jt):
    """The port's sharded stats() against the reference's stats_from_planes
    on the JAX state's gathered planes (its ShardedHKVTable.stats() fails
    under jax 0.9.0 on a mesh)."""
    def gathered(s):   # the sharded leaves as plain arrays
        return (jnp.asarray(np.asarray(getattr(s, f)))
                for f in ("key_hi", "key_lo", "score_hi", "score_lo"))

    st = jt.state
    if hasattr(st, "hot"):
        hot, cold = (jstats.stats_from_planes(*gathered(s)) for s in (st.hot, st.cold))
        want = jstats.combine_stats(hot, cold, size=jnp.int32(int(_j_size(jt))))
    else:
        want = jstats.stats_from_planes(*gathered(st))
    got = pt.stats()
    assert int(got.size) == int(want.size) and got.capacity == int(want.capacity)
    assert float(got.load_factor) == float(want.load_factor)
    _eq(got.occupancy_hist, want.occupancy_hist, "stats occupancy_hist")
    _eq(got.score_quantiles(), np.asarray(want.score_quantiles()), "stats score quantiles")


def test_sharded_state_round_trips_through_convert():
    rng = np.random.default_rng(5)
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), capacity=8 * 256, dim=DIM)
    t.insert_or_assign(_keys(rng, 1024), torch.randn(1024, DIM))
    arrays = convert.sharded_state_to_arrays(t.state)
    assert arrays["key_hi"].shape == (16, 128)
    back = convert.sharded_state_from_arrays(arrays, [torch.device("cpu")] * 8)
    again = t.with_state(back)
    _same_leaves(convert.sharded_state_to_arrays(again.state), arrays, "round trip", 0.0)
    t.state[3].clock += 1
    with pytest.raises(ValueError, match="clock"):
        convert.sharded_state_to_arrays(t.state)


def test_tiered_sharded_state_round_trips_through_convert():
    t = ShardedHKVTable.create(make_dev_mesh(1, 2, device="cpu"),
                               HKVEmbedding(capacity=4 * 128, dim=DIM, hot_capacity=2 * 128))
    t.insert_or_assign(np.arange(1, 301, dtype=np.uint64), torch.ones(300, DIM))
    arrays = convert.sharded_state_to_arrays(t.state)
    back = t.with_state(convert.sharded_state_from_arrays(arrays, [torch.device("cpu")] * 2))
    assert back.size() == t.size() and bool(back.contains(np.arange(1, 301, dtype=np.uint64))
                                            .all())


# =============================================================================
# (2, 4) and (8,) meshes: a JAX subprocess's scripted sequence, replayed
# =============================================================================

_SCRIPT = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0")
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from repro.core import U64
from repro.core.predicates import SweepPredicate
from repro.distributed.table_sharding import ShardedHKVTable
from repro.embedding.dynamic import HKVEmbedding
from repro.embedding.sparse_opt import SparseOptimizer
from repro.obs.telemetry import TelemetrySink

shape, names, out = json.loads(sys.argv[1]), tuple(json.loads(sys.argv[2])), sys.argv[3]
mesh = jax.make_mesh(tuple(shape), names)
dp = int(np.prod([s for s, a in zip(shape, names) if a in ("pod", "data")]))
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
FIELDS = ("key_hi", "key_lo", "digests", "score_hi", "score_lo", "values",
          "clock_hi", "clock_lo", "epoch")
rng = np.random.default_rng(20260417)
rec = {}
B, DIM = 4096, 4

def planes(k):
    return (jnp.asarray((k >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((k & np.uint64(0xFFFFFFFF)).astype(np.uint32)))

def keys(n):
    k = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64)
    k[n // 2: n // 2 + 16] = k[:16]
    k[::31] = EMPTY
    return k

def save(step, t, **res):
    rec[f"{step}/op"] = np.asarray(step.split(":", 1)[1])
    for f in FIELDS:
        rec[f"{step}/state/{f}"] = np.asarray(getattr(t.state, f))
    for name, v in res.items():
        rec[f"{step}/{name}"] = np.asarray(v)

def tel_dict(tel):
    return {f"tel_{k}": np.asarray(v) for k, v in tel._asdict().items()}

@jax.jit
def j_ins(t, kh, kl, v):
    s = TelemetrySink()
    r = t.insert_or_assign(U64(kh, kl), v, telemetry=s)
    return r.table, r.status, r.overflow, s.by_op["sharded_insert_or_assign"]

@jax.jit
def j_find(t, kh, kl):
    s = TelemetrySink()
    r = t.find(U64(kh, kl), telemetry=s)
    return r.table, r.values, r.found, r.overflow, s.by_op["sharded_find"]

@jax.jit
def j_foi(t, kh, kl):
    s = TelemetrySink()
    r = t.find_or_insert(U64(kh, kl), telemetry=s)
    return r.table, r.values, r.found, r.overflow, s.by_op["sharded_find_or_insert"]

j_contains = jax.jit(lambda t, kh, kl: t.contains(U64(kh, kl)))
j_assign = jax.jit(lambda t, kh, kl, v: t.assign(U64(kh, kl), v))
j_erase = jax.jit(lambda t, kh, kl: t.erase(U64(kh, kl)))
j_erase_if = jax.jit(lambda t, p: (lambda r: (r.table, r.swept))(t.erase_if(p)))
j_evict_if = jax.jit(lambda t, p: (lambda r: (r.table, tuple(r.evicted), r.count))(
    t.evict_if(p, 16)))
j_size = jax.jit(lambda t: t.size())
j_lookup = jax.jit(lambda t, x: t.lookup(x, train=True))
j_serve = jax.jit(lambda t, x: t.lookup(x, train=False))
j_grads = jax.jit(lambda t, x, g: t.apply_grads(x, g))

t = ShardedHKVTable.create(mesh, HKVEmbedding(
    capacity=8 * 256, dim=DIM, optimizer=SparseOptimizer("rowwise_adagrad", lr=0.5)))
step = 0
def nxt(op):
    global step
    step += 1
    return f"{step:02d}:{op}"

ins = []
for i in range(3):
    k, v = keys(B), rng.normal(size=(B, DIM)).astype(np.float32)
    t, st, ovf, tel = j_ins(t, *planes(k), jnp.asarray(v))
    save(nxt("insert_or_assign"), t, keys=k, values=v, status=st, overflow=ovf, **tel_dict(tel))
    ins.append(k)
mix = np.concatenate([ins[2][: B // 2], ins[0][: B // 4], keys(B // 4)])
t, vals, found, ovf, tel = j_find(t, *planes(mix))
save(nxt("find"), t, keys=mix, found=found, out_values=vals, overflow=ovf, **tel_dict(tel))
mix2 = np.concatenate([ins[2][B // 2:], keys(B // 2)])
t, vals, found, ovf, tel = j_foi(t, *planes(mix2))
save(nxt("find_or_insert"), t, keys=mix2, found=found, out_values=vals, overflow=ovf,
     **tel_dict(tel))
save(nxt("contains"), t, keys=mix, found=j_contains(t, *planes(mix)))
w = rng.normal(size=(B, DIM)).astype(np.float32)
t = j_assign(t, *planes(mix), jnp.asarray(w))
save(nxt("assign"), t, keys=mix, values=w)
t, vals, found, ovf, tel = j_find(t, *planes(mix))
save(nxt("find"), t, keys=mix, found=found, out_values=vals, overflow=ovf, **tel_dict(tel))
gone = mix.copy()
gone[1::2] = EMPTY
t = j_erase(t, *planes(gone))
save(nxt("erase"), t, keys=gone)
lo, hi = 2**62, 2**63 + 2**61
t, swept = j_erase_if(t, SweepPredicate.key_in_range(lo, hi))
save(nxt("erase_if"), t, lo=np.uint64(lo), hi=np.uint64(hi), swept=swept)
t, ev, cnt = j_evict_if(t, SweepPredicate.always())
save(nxt("evict_if"), t, count=cnt, **{f"ev_{i}": x for i, x in enumerate(ev)})
e = jax.jit(lambda t: tuple(t.export_batch(0, t.num_buckets)))(t)
save(nxt("export_batch"), t, count=np.int64(t.num_buckets),
     **{f"ex_{i}": x for i, x in enumerate(e)})
save(nxt("size"), t, size=j_size(t))
toks = rng.integers(0, 5000, size=(8, 64)).astype(np.int32)
toks[:, :3] = -1
t, rows, ovf = j_lookup(t, jnp.asarray(toks))
save(nxt("lookup_train"), t, tokens=toks, rows=rows, overflow=ovf)
g = rng.normal(size=(8, 64, DIM)).astype(np.float32)
t = j_grads(t, jnp.asarray(toks), jnp.asarray(g))
save(nxt("apply_grads"), t, tokens=toks, grads=g)
t, rows, ovf = j_serve(t, jnp.asarray(toks))
save(nxt("lookup_serve"), t, tokens=toks, rows=rows, overflow=ovf)

# a second table whose routing budget is half the fair share: cap 16
# against a mean of 32 keys a destination, so keys overflow
t2 = ShardedHKVTable.create(mesh, HKVEmbedding(capacity=8 * 256, dim=DIM),
                            capacity_factor=0.5)
k = keys(256 * dp)
v = rng.normal(size=(256 * dp, DIM)).astype(np.float32)
t2, st, ovf, tel = j_ins(t2, *planes(k), jnp.asarray(v))
save(nxt("overflow:insert_or_assign"), t2, keys=k, values=v, status=st, overflow=ovf,
     **tel_dict(tel))
t2, vals, found, ovf, tel = j_find(t2, *planes(k))
save(nxt("overflow:find"), t2, keys=k, found=found, out_values=vals, overflow=ovf,
     **tel_dict(tel))
np.savez(out, **rec)
print(json.dumps({"steps": step}))
'''

MESHES = {"2x4": ([2, 4], ["data", "model"]), "8": ([8], ["data"])}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Both meshes' JAX runs, started together (each a few tens of
    seconds, mostly compilation)."""
    import os

    out = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "XLA_FLAGS": "",
           "JAX_PLATFORMS": "cpu"}
    procs = {}
    for name, (shape, names) in MESHES.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_SCRIPT), json.dumps(shape),
             json.dumps(names), str(out / f"{name}.npz")],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    recs = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        recs[name] = dict(np.load(out / f"{name}.npz"))
    return recs


def _steps(rec):
    return sorted({k.split("/")[0] for k in rec})


def _state_of(rec, step):
    return {f: rec[f"{step}/state/{f}"] for f in convert.FIELDS}


def _tel_same(sink, op, rec, step):
    got = sink.by_op[op].to_dict()
    want = {k[len(step) + 5:]: int(v) for k, v in rec.items()
            if k.startswith(f"{step}/tel_")}
    assert got == want, (step, got, want)


def _replay(rec, shape, names):
    """The recorded sequence on the port, each result and state compared."""
    mesh = make_mesh(shape, names, device="cpu")
    opt = SparseOptimizer("rowwise_adagrad", lr=0.5)
    tables = {"": ShardedHKVTable.create(mesh, HKVEmbedding(capacity=8 * 256, dim=DIM,
                                                           optimizer=opt)),
              "overflow": ShardedHKVTable.create(mesh, HKVEmbedding(capacity=8 * 256, dim=DIM),
                                                 capacity_factor=0.5)}
    seen = {"status": set(), "overflow": 0}
    trained = False
    for step in _steps(rec):
        op = str(rec[f"{step}/op"])
        which, _, name = op.rpartition(":")
        t = tables[which]
        get = lambda f: rec[f"{step}/{f}"]  # noqa: E731
        sink = repro_torch.obs.TelemetrySink()
        if name == "insert_or_assign":
            r = t.insert_or_assign(get("keys"), torch.from_numpy(get("values")),
                                   telemetry=sink)
            _eq(r.status, get("status"), f"{step}: status")
            assert int(r.overflow) == int(get("overflow")), step
            _tel_same(sink, "sharded_insert_or_assign", rec, step)
            seen["status"] |= set(np.unique(get("status")).tolist())
            seen["overflow"] += int(get("overflow"))
        elif name in ("find", "find_or_insert"):
            r = (t.find(get("keys"), telemetry=sink) if name == "find"
                 else t.find_or_insert(get("keys"), telemetry=sink))
            _eq(r.found, get("found"), f"{step}: found")
            assert int(r.overflow) == int(get("overflow")), step
            _close(r.values, get("out_values"), step, RTOL if trained else 0.0)
            _tel_same(sink, "sharded_" + name, rec, step)
        elif name == "contains":
            _eq(t.contains(get("keys")), get("found"), f"{step}: contains")
        elif name == "assign":
            t.assign(get("keys"), torch.from_numpy(get("values")))
        elif name == "erase":
            t.erase(get("keys"))
        elif name == "erase_if":
            r = t.erase_if(SweepPredicate.key_in_range(int(get("lo")), int(get("hi"))))
            assert int(r.swept) == int(get("swept")) > 0, step
        elif name == "evict_if":
            r = t.evict_if(SweepPredicate.always(), 16)
            assert int(r.count) == int(get("count")) > 0, step
            got = convert.stream_to_arrays(r.evicted)
            for i, f in enumerate(("key_hi", "key_lo", "values", "score_hi", "score_lo",
                                   "mask")):
                _eq(got[f], get(f"ev_{i}"), f"{step}: stream {f}")
        elif name == "export_batch":
            got = convert.export_to_arrays(t.export_batch(0, int(get("count"))))
            for i, f in enumerate(("key_hi", "key_lo", "values", "score_hi", "score_lo",
                                   "mask")):
                _eq(got[f], get(f"ex_{i}"), f"{step}: export {f}")
        elif name == "size":
            assert t.size() == int(get("size")), step
        elif name in ("lookup_train", "lookup_serve"):
            _t, rows, ovf = t.lookup(get("tokens"), train=name == "lookup_train")
            _close(rows, get("rows"), step, RTOL if trained else 0.0)
            assert int(ovf) == int(get("overflow")), step
        elif name == "apply_grads":
            t.apply_grads(get("tokens"), torch.from_numpy(get("grads")))
            trained = True
        else:  # pragma: no cover
            raise AssertionError(op)
        _same_state(t, _state_of(rec, step), step, RTOL if trained and not which else 0.0)
    return tables, seen


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_meshes_replay_the_reference_sequence(recorded, mesh_name):
    shape, names = MESHES[mesh_name]
    tables, seen = _replay(recorded[mesh_name], shape, names)
    assert {3, 4} <= seen["status"], seen           # past λ 1.0: evicted and rejected
    assert seen["overflow"] > 0                     # the half-budget table overflowed
    assert tables[""].n_shards == 8


def test_replicas_agree(monkeypatch):
    """On a (2, 4) mesh each data row's 4 model positions route the same
    keys: results taken from another replica than index 0 are the same,
    and so are the states they leave."""
    rng = np.random.default_rng(3)
    base = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"),
                                  HKVEmbedding(capacity=8 * 256, dim=DIM))
    base.insert_or_assign(_keys(rng, 2048), torch.randn(2048, DIM))
    q = np.concatenate([_keys(rng, 512), convert.export_to_arrays(base.export_batch(0, 1))
                        ["key_lo"][:512].astype(np.uint64)])
    toks = rng.integers(0, 3000, size=(4, 64))
    results = []
    for replica in (0, 1, 3):
        t = base.snapshot()
        real = pts.layout

        def other(mesh, axes, real=real, replica=replica):
            lay = real(mesh, axes)
            return pts._Layout(lay.devices, lay.chunk,
                               tuple(p + replica for p in lay.primaries))

        monkeypatch.setattr(pts, "layout", other)
        f = t.find(q)
        fo = t.find_or_insert(q[::-1].copy())
        st = t.insert_or_assign(q, torch.ones(len(q), DIM))
        rows = t.lookup(toks, train=True)[1]
        monkeypatch.setattr(pts, "layout", real)
        results.append((f.values, f.found, fo.values, fo.found, st.status, rows,
                        convert.sharded_state_to_arrays(t.state)))
    for other_res in results[1:]:
        for a, b in zip(results[0][:-1], other_res[:-1]):
            assert torch.equal(a, b)
        _same_leaves(other_res[-1], results[0][-1], "replica state", 0.0)


def test_sharded_embedding_roundtrip_and_grads():
    """tests/test_distributed.py's first sharded scenario on the port: a
    training lookup inserts, serving agrees, and gradients descend."""
    emb = HKVEmbedding(capacity=8 * 128 * 8, dim=8,
                       optimizer=SparseOptimizer("rowwise_adagrad", lr=0.5))
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), emb)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 5000, size=(4, 32)))
    _t, rows, ovf = t.lookup(toks, train=True)
    _t, served, _ = t.lookup(toks, train=False)
    assert torch.allclose(rows, served, atol=1e-6) and int(ovf) == 0
    target = torch.ones_like(rows)
    loss0 = float(((rows - target) ** 2).mean())
    t.apply_grads(toks, 2 * (rows - target) / rows.numel())
    loss1 = float(((t.lookup(toks, train=False)[1] - target) ** 2).mean())
    assert loss1 < loss0


def test_sharded_lookup_matches_unsharded_init_rows():
    """tests/test_distributed.py's second: cold-start rows are the
    embedding's deterministic init rows."""
    emb = HKVEmbedding(capacity=8 * 128 * 8, dim=4)
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), emb)
    toks = torch.arange(16).reshape(2, 8)
    _t, rows, _ = t.lookup(toks, train=True)
    assert torch.equal(rows, emb.default_rows(emb.keys_of(toks)).reshape(rows.shape))


def test_a_mesh_of_distinct_devices_matches_one_device():
    """The copy path of the all-to-all (distinct devices: cpu and cpu:0)
    gives the single-device mesh's results and states."""
    rng = np.random.default_rng(9)
    one = ShardedHKVTable.create(make_dev_mesh(2, 2, device="cpu"), capacity=4 * 256, dim=DIM)
    many = ShardedHKVTable.create(
        make_dev_mesh(2, 2, device=["cpu", "cpu:0", "cpu:0", "cpu:0"]), capacity=4 * 256,
        dim=DIM)
    for _ in range(3):
        k, v = _keys(rng, 1024, empty_every=5), torch.randn(1024, DIM)
        assert torch.equal(one.insert_or_assign(k, v).status, many.insert_or_assign(k, v).status)
    toks = rng.integers(0, 3000, size=(4, 16))
    assert torch.equal(one.lookup(toks, train=True)[1], many.lookup(toks, train=True)[1])
    g = torch.randn(4, 16, DIM)
    one.apply_grads(toks, g)
    many.apply_grads(toks, g)
    _same_leaves(convert.sharded_state_to_arrays(many.state),
                 convert.sharded_state_to_arrays(one.state), "distinct devices", 0.0)


def test_stats_match_the_reference_planes_for_flat_and_tiered_shards():
    rng = np.random.default_rng(4)
    for emb in (HKVEmbedding(capacity=8 * 256, dim=DIM),
                HKVEmbedding(capacity=8 * 256, dim=DIM, hot_capacity=8 * 128)):
        t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), emb)
        t.insert_or_assign(_keys(rng, 2048), torch.randn(2048, DIM))
        a = convert.sharded_state_to_arrays(t.state)
        if emb.is_tiered:
            hot, cold = (jstats.stats_from_planes(*(jnp.asarray(a[tier][f]) for f in
                                                    ("key_hi", "key_lo", "score_hi",
                                                     "score_lo")))
                         for tier in ("hot", "cold"))
            want = jstats.combine_stats(hot, cold, size=jnp.int32(t.size()))
        else:
            want = jstats.stats_from_planes(*(jnp.asarray(a[f]) for f in
                                              ("key_hi", "key_lo", "score_hi", "score_lo")))
        got = t.stats()
        assert int(got.size) == int(want.size) == t.size()
        assert got.capacity == int(want.capacity)
        assert float(got.load_factor) == float(want.load_factor)
        _eq(got.occupancy_hist, want.occupancy_hist, "occupancy_hist")
        _eq(got.score_quantiles(), np.asarray(want.score_quantiles()), "score quantiles")


def test_handle_surface():
    t = ShardedHKVTable.create(make_dev_mesh(2, 4, device="cpu"), capacity=8 * 128, dim=DIM)
    assert isinstance(t, KVTable) and repro_torch.table_signature(t)
    assert t.n_shards == 8 and t.capacity == 8 * 128 and t.dim == DIM
    assert t.device == torch.device("cpu") and t.num_buckets == 1
    assert all(s.device == torch.device("cpu") for s in t.shards)
    snap = t.snapshot()
    t.insert_or_assign(np.arange(1, 65, dtype=np.uint64), torch.ones(64, DIM))
    assert t.size() == 64 and snap.size() == 0
    with pytest.raises(ValueError, match="does not split"):
        t.find(np.arange(1, 4, dtype=np.uint64))
