"""The port's insert_or_assign + find path against the JAX package.

Seeded op sequences run through `repro.core.HKVTable` (backend 'jnp') and
`repro_torch.HKVTable(device='cpu')`.  After every op the statuses, the
find results and the full drained state (keys, digests, scores, values,
clock, epoch — carried across by `repro_torch.convert`) must be
bit-identical.  The sequences cover single and dual bucket mode, all five
score policies, duplicates in a batch, EMPTY and negative padding, keys at
or above 2**63, and a table driven past λ = 1.0 so that EVICTED and
REJECTED both occur.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import normalize_keys as jax_keys  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import merge as pt_merge  # noqa: E402
from repro_torch.core import ops as pt_ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as pt_kops  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")
CAPACITY, DIM, BATCH = 2 * 128, 4, 320

_jit_upsert = jax.jit(lambda t, k, v: t.insert_or_assign(k, v))
_jit_upsert_custom = jax.jit(lambda t, k, v, c: t.insert_or_assign(k, v, c))
_jit_find = jax.jit(lambda t, k: t.find(k))


def _batch(rng, step):
    """Keys from a small space (so later batches hit earlier keys), with
    duplicates, padding and wide keys.  Even steps are numpy uint64 with
    EMPTY padding and keys >= 2**63; odd steps signed int64 with negative
    padding."""
    keys = rng.integers(0, 8 * CAPACITY, size=BATCH).astype(np.uint64)
    keys[rng.integers(0, BATCH, size=BATCH // 4)] = rng.choice(keys, size=BATCH // 4)
    if step % 2 == 0:
        wide = rng.integers(0, BATCH, size=BATCH // 8)
        keys[wide] |= np.uint64(1 << 63)
        keys[rng.integers(0, BATCH, size=4)] = EMPTY
        return keys
    signed = keys.astype(np.int64)
    signed[rng.integers(0, BATCH, size=4)] = -rng.integers(1, 1000, size=4)
    return signed


def _assert_state_equal(jt, pt, ctx):
    got = convert.state_to_arrays(pt.state)
    for f in convert.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt.state, f)), got[f],
                                      err_msg=f"{ctx}: state.{f}")


def _assert_find_equal(jt, pt, keys, ctx):
    jr = _jit_find(jt, jax_keys(keys))
    pr = pt.find(keys)
    np.testing.assert_array_equal(np.asarray(jr.found), pr.found.numpy(), err_msg=f"{ctx}: found")
    np.testing.assert_array_equal(np.asarray(jr.values), pr.values.numpy(), err_msg=f"{ctx}: values")
    scores = (np.asarray(jr.score_hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(jr.score_lo).astype(np.uint64)
    np.testing.assert_array_equal(scores, pr.scores.numpy().view(np.uint64), err_msg=f"{ctx}: scores")


def _run_sequence(jt, pt, rng, policy, steps):
    seen = set()
    for step in range(steps):
        keys = _batch(rng, step)
        vals = rng.normal(size=(BATCH, DIM)).astype(np.float32)
        if policy.startswith("epoch") and step == steps // 2:
            jt, pt = jt.set_epoch(7), pt.set_epoch(7)
        if policy == "custom":
            # a narrow score range, so that existing entries win ties
            cs = rng.integers(0, 64, size=BATCH).astype(np.uint64)
            cs[rng.integers(0, BATCH, size=8)] |= np.uint64(1 << 63)
            jr = _jit_upsert_custom(jt, jax_keys(keys), jnp.asarray(vals), jax_keys(cs))
            pr = pt.insert_or_assign(keys, vals, cs)
        else:
            jr = _jit_upsert(jt, jax_keys(keys), jnp.asarray(vals))
            pr = pt.insert_or_assign(keys, vals)
        jt, pt = jr.table, pr.table
        np.testing.assert_array_equal(np.asarray(jr.status), pr.status.numpy(),
                                      err_msg=f"step {step}: status")
        _assert_state_equal(jt, pt, f"step {step}")
        _assert_find_equal(jt, pt, keys, f"step {step}")
        seen.update(pr.status.tolist())
    return jt, pt, seen


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_insert_find_sequence_bit_identical(policy, dual):
    rng = np.random.default_rng(1000 + 10 * POLICIES.index(policy) + dual)
    kw = dict(capacity=CAPACITY, dim=DIM, buckets_per_key=2 if dual else 1,
              score_policy=policy)
    jt = JaxTable.create(backend="jnp", **kw)
    pt = repro_torch.HKVTable.create(device="cpu", **kw)
    jt, pt, seen = _run_sequence(jt, pt, rng, policy, steps=10)
    assert pt.load_factor() == 1.0
    assert {pt_ops.STATUS_EVICTED, pt_ops.STATUS_REJECTED} <= seen


def test_port_continues_from_a_carried_jax_state():
    """A JAX state carried across by convert.state_from_arrays, then the
    same ops on both sides."""
    rng = np.random.default_rng(7)
    kw = dict(capacity=CAPACITY, dim=DIM, buckets_per_key=2, score_policy="lfu")
    jt = JaxTable.create(backend="jnp", **kw)
    for step in range(4):
        keys = _batch(rng, step)
        jt = _jit_upsert(jt, jax_keys(keys), jnp.asarray(rng.normal(size=(BATCH, DIM)),
                                                          jnp.float32)).table
    pt = repro_torch.HKVTable(state=convert.state_from_arrays(jt.state, device="cpu"),
                              cfg=repro_torch.HKVConfig(**kw))
    _assert_state_equal(jt, pt, "carried")
    _run_sequence(jt, pt, rng, "lfu", steps=4)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_kernel_stages_on_cpu_run_the_plain_versions(dual):
    """The kernel-backed stages and find on CPU tensors go through the
    kernel wrappers, which take their plain versions there: results equal
    the plain path and no kernel is launched."""
    rng = np.random.default_rng(11)
    kw = dict(capacity=CAPACITY, dim=DIM, buckets_per_key=2 if dual else 1)
    plain = repro_torch.HKVTable.create(device="cpu", backend="plain", **kw)
    kern = repro_torch.HKVTable.create(device="cpu", backend="plain", **kw)
    stages = pt_kops.kernel_stages(kern.cfg, kern.device)
    _build.reset_counts()
    for step in range(6):
        keys = _batch(rng, step)
        vals = rng.normal(size=(BATCH, DIM)).astype(np.float32)
        sp = plain.insert_or_assign(keys, vals).status
        tkeys = repro_torch.normalize_keys(keys, kern.device)
        sk = pt_merge.upsert(kern.state, kern.cfg, tkeys,
                             pt_ops._pad_aux(torch.from_numpy(vals), kern.state),
                             stages=stages).status
        assert torch.equal(sp, sk)
        a, b = convert.state_to_arrays(plain.state), convert.state_to_arrays(kern.state)
        for f in convert.FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"step {step}: {f}")
        fp, fk = plain.find(keys), pt_kops.find_fused_kernel(kern.state, kern.cfg, tkeys)
        assert torch.equal(fp.values, fk.values[:, :DIM]) and torch.equal(fp.found, fk.found)
        assert torch.equal(fp.scores, fk.scores)
    assert sum(_build.launch_counts.values()) == 0


def test_default_stages_are_the_plain_ones():
    assert not pt_ops.uses_kernels("auto", torch.device("cpu"))
    assert pt_ops.uses_kernels("auto", torch.device("cuda"))
    assert not pt_ops.uses_kernels("plain", torch.device("cuda"))
    for unknown in ("jnp", "kernel"):
        with pytest.raises(ValueError):
            pt_ops.uses_kernels(unknown, torch.device("cpu"))
        with pytest.raises(ValueError):
            pt_ops.op_stages(unknown, repro_torch.HKVConfig(capacity=128, dim=4),
                             torch.device("cpu"))
    assert pt_merge.plain_stages().select_target is pt_merge.select_target_bucket
    assert pt_merge.plain_stages() is pt_merge.plain_stages()
    cfg = repro_torch.HKVConfig(capacity=128, dim=4)
    for backend, device in (("auto", "cpu"), ("plain", "cpu"), ("plain", "cuda")):
        assert pt_ops.op_stages(backend, cfg, torch.device(device)) is pt_merge.plain_stages()
    # building the kernel set launches nothing, so the card's set is built here
    kern = pt_ops.op_stages("auto", cfg, torch.device("cuda"))
    assert kern is pt_ops.op_stages("auto", cfg, torch.device("cuda"))
    assert kern is not pt_merge.plain_stages()
    assert kern._fields == pt_merge.plain_stages()._fields


def test_a_float64_plane_is_refused_on_the_card_before_a_write():
    """The card's kernel set is refused for a plane no kernel takes: every
    'auto' op on such a table raises before it touches the planes."""
    cfg = repro_torch.HKVConfig(capacity=128, dim=4, value_dtype=torch.float64)
    for _ in range(2):   # a refusal is not cached
        with pytest.raises(ValueError, match="float64"):
            pt_ops.op_stages("auto", cfg, torch.device("cuda"))
    assert pt_ops.op_stages("plain", cfg, torch.device("cuda")) is pt_merge.plain_stages()
    assert pt_ops.op_stages("auto", cfg, torch.device("cpu")) is pt_merge.plain_stages()


@pytest.mark.parametrize("backend", ["kernel_set", "plain"])
def test_ops_on_one_table_resolve_one_cached_set(backend, monkeypatch):
    """Every op on one table resolves the same set object, and the kernel
    set is built once per (cfg, device) however many ops run (the kernel
    routing is forced on the CPU, where its wrappers take their plain
    versions)."""
    from repro_torch import SweepPredicate
    from repro_torch.embedding.sparse_opt import SparseOptimizer

    if backend == "kernel_set":
        monkeypatch.setattr(pt_ops, "uses_kernels", lambda backend, device: True)
        pt_kops.kernel_stages.cache_clear()
    seen = []
    resolve = pt_ops.op_stages

    def recording(*args):
        seen.append(resolve(*args))
        return seen[-1]

    monkeypatch.setattr(pt_ops, "op_stages", recording)
    rng = np.random.default_rng(5)
    t = repro_torch.HKVTable.create(capacity=CAPACITY, dim=DIM, buckets_per_key=2,
                                    device="cpu", backend="plain")
    cfg, state = t.cfg, t.state
    for step in range(2):
        keys = repro_torch.normalize_keys(_batch(rng, step), "cpu")
        vals = torch.from_numpy(rng.normal(size=(BATCH, DIM)).astype(np.float32))
        pt_ops.insert_or_assign(state, cfg, keys, vals, backend="auto")
        pt_ops.find_or_insert(state, cfg, keys, vals, backend="auto", return_evicted=True)
        pt_ops.find(state, cfg, keys, backend="auto")
        pt_ops.find_rows(state, cfg, keys, backend="auto")
        pt_ops.contains(state, cfg, keys, backend="auto")
        uniq = torch.unique(keys)   # the EMPTY key among them is padding
        pt_ops.update_rows(state, cfg, uniq, torch.ones((uniq.numel(), DIM)),
                           SparseOptimizer("sgd", lr=0.1), backend="auto")
    pt_ops.evict_if(state, cfg, SweepPredicate.score_below(2**62), 8, backend="auto")
    pt_ops.erase_if(state, cfg, SweepPredicate.score_below(2**62), backend="auto")
    assert len(seen) == 14 and all(st is seen[0] for st in seen)   # one resolve an op
    if backend == "kernel_set":
        assert seen[0] is not pt_merge.plain_stages()
        assert pt_kops.kernel_stages.cache_info().misses == 1
    else:
        assert seen[0] is pt_merge.plain_stages()
