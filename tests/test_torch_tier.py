"""The port's host-memory value tier (``value_tier='hmem'``) against the JAX
package and against the port's own 'hbm' tier, on the CPU.

On the CPU the port keeps an 'hmem' plane as an ordinary CPU tensor, as the
reference's CPU container keeps it in place, and its ops cross the tier
through ``core.table``'s ``tier_gather`` / ``tier_scatter`` (plain indexing
here; on the card the kernels read the plane in pinned host memory, held in
``tests/test_torch_cuda.py``).  Held here:

  * every op of HKVTable on an 'hmem' table against the JAX package's
    'hmem' table (the seeded replay of ``test_torch_ops.py``): statuses,
    eviction streams, values, locates, exports and the full state after
    every op, bit for bit, in both bucket modes under lru and custom;
  * update_rows on 'hmem' tables against the JAX package, through the op
    engine, the fused stage and the composed stage (which the 'hmem' tier
    takes on the card): sgd exact, rowwise_adagrad within a relative 1e-6
    (its row mean is a reduction; see ``test_torch_update.py``);
  * the tier crossings against plain indexing, and the 'hmem' table
    against the port's 'hbm' table on the scenarios of
    ``tests/test_tier_crossings.py::TestHmemOpParity`` (the reference's own
    jit gather cases fail and are not the yardstick);
  * the kernel-path stages that route the 'hmem' tier (the locate and
    gather_rows in place of find_scan, the composed updater in place of
    update_scan) against the 'hbm' routes, and a JAX 'hmem' state carried
    across by ``convert``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from test_torch_ops import AUX, DIM, Replay, _run  # noqa: E402
from test_torch_update import (_cfgs, _filled, _grads, _queries, _resident,  # noqa: E402
                               assert_state)

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


class HmemReplay(Replay):
    """test_torch_ops' replay on 'hmem' tables of both packages."""

    def __init__(self, policy, dual, seed):
        super().__init__(policy, dual, seed)
        kw = dict(capacity=self.capacity, dim=DIM, buckets_per_key=2 if dual else 1,
                  score_policy=policy, aux_value_dim=AUX, value_tier="hmem")
        self.jt = JaxTable.create(backend="jnp", **kw)
        self.pt = repro_torch.HKVTable.create(device="cpu", **kw)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", ["lru", "custom"])
def test_every_op_on_hmem_matches_jax(policy, dual):
    r = HmemReplay(policy, dual, seed=3000 + 10 * (policy == "custom") + dual)
    assert r.pt.cfg.value_tier == "hmem" and r.jt.cfg.value_tier == "hmem"
    seen = _run(r, steps=4)
    assert {pops.STATUS_EVICTED, pops.STATUS_REJECTED} & seen


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("opt_name", ["sgd", "rowwise_adagrad"])
def test_update_rows_on_hmem_matches_jax(opt_name, dual):
    """update_rows on an 'hmem' table of each package (the reference runs
    its jnp path): the op engine, the fused stage (which routes the 'hmem'
    tier to the composed step) and the composed stage itself."""
    rng = np.random.default_rng(51 + dual)
    jopt, jcfg, popt, pcfg = _cfgs(opt_name, dual)
    jcfg = dataclasses.replace(jcfg, value_tier="hmem")
    pcfg = dataclasses.replace(pcfg, value_tier="hmem")
    jstate, _ = _filled(rng, jcfg, 650)
    q = _queries(rng, _resident(jstate))
    g = _grads(rng, q.size)
    want = jops.update_rows(jstate, jcfg, ju64.from_uint64(q), jnp.asarray(g), jopt,
                            backend="jnp")
    k = repro_torch.normalize_keys(q)
    for name, run in (
            ("ops", lambda s: pops.update_rows(s, pcfg, k, torch.from_numpy(g), popt).found),
            ("fused stage", lambda s: kops.update_rows_kernel(s, pcfg, k, torch.from_numpy(g),
                                                              popt).found),
            ("composed", lambda s: kops.update_composed_kernel(s, pcfg, k, torch.from_numpy(g),
                                                               popt).found)):
        pstate = convert.state_from_arrays(jstate, device="cpu", value_tier="hmem")
        np.testing.assert_array_equal(run(pstate).numpy(), np.asarray(want.found), err_msg=name)
        assert_state(want.state, pstate, opt_name, name)


# -- the tier crossings against plain indexing --------------------------------


@pytest.mark.parametrize("tier", ["hbm", "hmem"])
def test_tier_gather_matches_plain_indexing(tier):
    rng = np.random.default_rng(0)
    values = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 256, size=64))
    np.testing.assert_array_equal(ptable.tier_gather(tier, values, rows).numpy(),
                                  values.numpy()[rows.numpy()])


@pytest.mark.parametrize("tier", ["hbm", "hmem"])
def test_tier_scatter_then_gather_round_trips(tier):
    rng = np.random.default_rng(1)
    values = torch.zeros(256, 4)
    rows = torch.from_numpy(rng.permutation(256)[:64])
    updates = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    ptable.tier_scatter(tier, values, rows, updates)
    np.testing.assert_array_equal(ptable.tier_gather(tier, values, rows).numpy(), updates.numpy())
    untouched = np.ones(256, bool)
    untouched[rows.numpy()] = False
    assert not values.numpy()[untouched].any()


@pytest.mark.parametrize("tier", ["hbm", "hmem"])
def test_tier_scatter_add_accumulates_and_masking_zeroes(tier):
    values = torch.ones(64, 2)
    ptable.tier_scatter(tier, values, torch.tensor([3, 3, 7]), torch.full((3, 2), 2.0), add=True)
    assert values[3].tolist() == [5.0, 5.0] and values[7].tolist() == [3.0, 3.0]
    assert values[1].tolist() == [1.0, 1.0]
    ptable.tier_scatter(tier, values, torch.tensor([1, 7]), 0)
    assert values[1].tolist() == values[7].tolist() == [0.0, 0.0]
    keep = torch.ones(64, dtype=torch.bool)
    keep[3] = False
    ptable.tier_mask_rows(tier, values, keep)
    assert not values[3].any() and values[5].tolist() == [1.0, 1.0]
    ptable.tier_zero(tier, values, torch.device("cpu"))
    assert not values.any()
    b, s = torch.tensor([0, 2]), torch.tensor([5, 127])
    assert ptable.value_row_index(b, s, 128).tolist() == [5, 383]


def test_hmem_plane_on_the_cpu_is_a_plain_tensor():
    """On the CPU the 'hmem' plane stays where it is, as in the reference's
    CPU container; place_value_tier moves any other plane to the device."""
    t = repro_torch.HKVTable.create(capacity=128, dim=4, device="cpu", value_tier="hmem")
    assert t.state.values.device.type == "cpu" and not t.state.host_values
    v = torch.arange(8.0).reshape(2, 4)
    assert ptable.place_value_tier(v, torch.device("cpu"), "hmem") is v
    assert t.snapshot().state.values.data_ptr() != t.state.values.data_ptr()


# -- the 'hmem' table against the port's 'hbm' table (TestHmemOpParity) -------


def _twins(dim=6, capacity=2 * 128, **kw):
    return tuple(repro_torch.HKVTable.create(capacity=capacity, dim=dim, device="cpu",
                                             value_tier=tier, **kw) for tier in ("hbm", "hmem"))


def _same_state(a, b):
    for f in ("keys", "digests", "scores", "values"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert (a.state.clock, a.state.epoch) == (b.state.clock, b.state.epoch)


def test_find_or_insert_bit_identical_vs_hbm():
    rng = np.random.default_rng(2)
    hbm, hmem = _twins()
    for _ in range(5):   # hits again, inserts, evictions past capacity
        keys = rng.integers(0, 2**14, size=160).astype(np.uint64)
        init = rng.normal(size=(160, 6)).astype(np.float32)
        r1, r2 = hbm.find_or_insert(keys, init), hmem.find_or_insert(keys, init)
        for f in ("found", "status", "values"):
            assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    _same_state(hbm, hmem)


def test_export_batch_bit_identical_vs_hbm():
    rng = np.random.default_rng(3)
    hbm, hmem = _twins()
    keys = rng.integers(0, 2**40, size=200).astype(np.uint64)
    vals = rng.normal(size=(200, 6)).astype(np.float32)
    hbm.insert_or_assign(keys, vals)
    hmem.insert_or_assign(keys, vals)
    nb = hbm.num_buckets
    for (a, b) in ((hbm.export_batch(0, nb), hmem.export_batch(0, nb)),
                   (hbm.export_batch(1, 1), hmem.export_batch(1, 1))):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_insert_and_evict_stream_bit_identical_vs_hbm():
    """The demotion transport is tier-independent: a hot tier would
    otherwise demote other pairs depending on where its values live."""
    rng = np.random.default_rng(4)
    hbm, hmem = _twins(dim=4, capacity=128)
    for _ in range(3):
        keys = rng.integers(0, 2**40, size=128).astype(np.uint64)
        vals = rng.normal(size=(128, 4)).astype(np.float32)
        r1, r2 = hbm.insert_and_evict(keys, vals), hmem.insert_and_evict(keys, vals)
        assert torch.equal(r1.status, r2.status)
        for f in r1.evicted._fields:
            assert torch.equal(getattr(r1.evicted, f), getattr(r2.evicted, f)), f
    assert int(r1.evicted.count()) > 0
    _same_state(hbm, hmem)


def test_sweeps_and_updaters_bit_identical_vs_hbm():
    """The ops whose value writes cross the tier outside the upsert:
    assign (with narrower rows keeping the aux columns), assign_add,
    accum_or_assign, erase, erase_if, evict_if and clear."""
    rng = np.random.default_rng(5)
    hbm, hmem = _twins(dim=4, capacity=4 * 128, aux_value_dim=2, buckets_per_key=2)
    pred = repro_torch.SweepPredicate
    for _ in range(3):
        keys = rng.integers(0, 2**12, size=300).astype(np.uint64)
        vals = rng.normal(size=(300, 4)).astype(np.float32)
        for t in (hbm, hmem):
            t.insert_or_assign(keys, vals)
            t.assign(keys[:100], vals[:100] * 2)
            t.assign_add(keys[:150], vals[:150])
            t.accum_or_assign(keys[50:250], vals[50:250])
            t.erase(keys[:20])
        _same_state(hbm, hmem)
        s1, s2 = hbm.erase_if(pred.key_in_range(0, 2**9)), hmem.erase_if(pred.key_in_range(0, 2**9))
        assert int(s1.swept) == int(s2.swept)
        e1, e2 = hbm.evict_if(pred.always(), 40), hmem.evict_if(pred.always(), 40)
        for f in e1.evicted._fields:
            assert torch.equal(getattr(e1.evicted, f), getattr(e2.evicted, f)), f
        _same_state(hbm, hmem)
    hbm.clear()
    hmem.clear()
    _same_state(hbm, hmem)


# -- the kernel-path routes of the 'hmem' tier --------------------------------


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_hmem_kernel_routes_equal_the_hbm_routes(dual):
    """find_fused_kernel on an 'hmem' config (locate_kernel, then
    gather_rows) against the 'hbm' one (find_scan), and the updater's
    'hmem' route (the composed step) against update_scan's: the same
    table and batch, the plain versions of the kernels on the CPU."""
    rng = np.random.default_rng(61 + dual)
    _, jcfg, popt, pcfg = _cfgs("rowwise_adagrad", dual)
    jstate, _ = _filled(rng, jcfg, 650)
    q = _queries(rng, _resident(jstate))
    k = repro_torch.normalize_keys(q)
    g = torch.from_numpy(_grads(rng, q.size))
    hcfg = dataclasses.replace(pcfg, value_tier="hmem")
    a = convert.state_from_arrays(jstate, device="cpu")
    b = convert.state_from_arrays(jstate, device="cpu", value_tier="hmem")
    fa, fb = kops.find_fused_kernel(a, pcfg, k), kops.find_fused_kernel(b, hcfg, k)
    for f in fa._fields:
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    assert fa.found.any() and not fa.found.all()
    ua = kops.update_rows_kernel(a, pcfg, k, g, popt)
    ub = kops.update_rows_kernel(b, hcfg, k, g, popt)
    assert torch.equal(ua.found, ub.found)
    assert torch.equal(a.values, b.values)


def test_jax_hmem_state_converts_both_ways():
    jt = JaxTable.create(capacity=2 * 128, dim=3, value_tier="hmem", backend="jnp")
    rng = np.random.default_rng(7)
    jt = jt.insert_or_assign(ju64.from_uint64(rng.integers(0, 2**62, size=200).astype(np.uint64)),
                             jnp.asarray(rng.normal(size=(200, 3)), jnp.float32)).table
    ps = convert.state_from_arrays(jt.state, device="cpu", value_tier="hmem")
    back = convert.state_to_arrays(ps)
    for f in convert.FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jt.state, f)), err_msg=f)
    pt = repro_torch.HKVTable.wrap(ps, repro_torch.HKVConfig(capacity=256, dim=3,
                                                             value_tier="hmem"))
    keys = ju64.to_uint64(jt.state.keys).reshape(-1)
    keys = keys[keys != EMPTY]
    jf, pf = jt.find(keys), pt.find(keys)
    np.testing.assert_array_equal(pf.values.numpy(), np.asarray(jf.values))
    assert pf.found.all()
