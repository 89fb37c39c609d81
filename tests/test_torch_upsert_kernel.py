"""The port's upsert wrappers against the JAX package's
(``tests/test_upsert_kernel.py`` on both sides): ``kernels.ops.upsert_kernel``,
``insert_and_evict_kernel`` and ``find_or_insert_kernel``.

On the CPU the port's wrappers run the kernel stages' plain versions (each
kernel wrapper takes its plain version for a CPU tensor); the JAX side runs
its Pallas kernels in interpret mode, as its own tests do.  Every output
(statuses, found flags, values, eviction streams) and the full state are
held bit for bit after every batch, in both bucket modes; the launch
budget is counted on the port's own kernel wrappers.  (On the card the
wrappers are held against these CPU paths in ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 15.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.kernels import ops as jk  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import find as pfind  # noqa: E402
from repro_torch.core import merge as pmerge  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.core.oracle import OracleTable  # noqa: E402
from repro_torch.kernels import ops as pk  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
STREAM = ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask")


def _random_batch(rng, n, key_space, dup_frac=0.25, pad_frac=0.05):
    """test_upsert_kernel.py's batch: duplicates and EMPTY padding."""
    keys = rng.integers(0, key_space, size=n).astype(np.uint64)
    ndup = int(n * dup_frac)
    if ndup:
        keys[rng.integers(0, n, size=ndup)] = rng.choice(keys, size=ndup)
    npad = int(n * pad_frac)
    if npad:
        keys[rng.integers(0, n, size=npad)] = EMPTY
    return keys


def _pair(dual, policy="lru", capacity=2 * 128, dim=4, tier="hbm"):
    kw = dict(capacity=capacity, dim=dim, buckets_per_key=2 if dual else 1, score_policy=policy)
    cfg_j, cfg_p = jtable.HKVConfig(**kw), ptable.HKVConfig(**kw, value_tier=tier)
    return cfg_j, jtable.create(cfg_j), cfg_p, ptable.create(cfg_p, "cpu")


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def _state_eq(js, ps, ctx):
    got = convert.state_to_arrays(ps)
    for f in convert.FIELDS:
        _eq(got[f], getattr(js, f), f"{ctx}: state.{f}")


def _stream_eq(js, ps, ctx):
    got = convert.stream_to_arrays(ps)
    for f in STREAM:
        _eq(got[f], getattr(js, f), f"{ctx}: evicted.{f}")


def _scores(value, n):
    return np.full(n, value, np.uint64)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_upsert_kernel_bit_identical_over_full_table(dual, policy):
    """3x capacity through the table: warm-up inserts, λ 1.0 evictions."""
    rng = np.random.default_rng(17 * (1 + dual) + len(policy))
    cfg_j, sj, cfg_p, sp = _pair(dual, policy, capacity=4 * 128, dim=8)
    for step in range(8):
        keys = _random_batch(rng, 192, 2**50)
        vals = rng.normal(size=(192, 8)).astype(np.float32)
        rj = jk.upsert_kernel(sj, cfg_j, ju64.from_uint64(keys), jnp.asarray(vals),
                              interpret=True)
        rp = pk.upsert_kernel(sp, cfg_p, pu64.from_numpy_u64(keys), torch.from_numpy(vals))
        sj = rj.state
        assert rp.state is sp                      # in place
        _eq(rp.status.numpy(), rj.status, f"step {step} status")
        _eq(rp.found.numpy(), rj.found, f"step {step} found")
        _state_eq(sj, sp, f"step {step}")
    assert sp.load_factor() == 1.0                 # the eviction regime was exercised


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_insert_and_evict_kernel_returns_identical_evictions(dual):
    rng = np.random.default_rng(3)
    cfg_j, sj, cfg_p, sp = _pair(dual)
    evicted = 0
    for step in range(4):                          # past capacity: evictions occur
        keys = _random_batch(rng, 160, 2**40)
        vals = rng.normal(size=(160, 4)).astype(np.float32)
        rj = jk.insert_and_evict_kernel(sj, cfg_j, ju64.from_uint64(keys), jnp.asarray(vals),
                                        interpret=True)
        rp = pk.insert_and_evict_kernel(sp, cfg_p, pu64.from_numpy_u64(keys),
                                        torch.from_numpy(vals))
        sj = rj.state
        _eq(rp.status.numpy(), rj.status, f"step {step}: status")
        _stream_eq(rj.evicted, rp.evicted, f"step {step}")
        _state_eq(sj, sp, f"step {step}")
        evicted += int(rp.evicted.mask.sum())
    assert evicted > 0


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_find_or_insert_kernel_matches_core(dual):
    """The JAX wrapper, the port's wrapper and the port's public op."""
    rng = np.random.default_rng(5)
    cfg_j, sj, cfg_p, sp = _pair(dual, capacity=4 * 128, dim=8)
    so = ptable.create(cfg_p, "cpu")
    for step in range(6):
        keys = _random_batch(rng, 128, 2**18)      # small space: many hits
        init = rng.normal(size=(128, 8)).astype(np.float32)
        k = pu64.from_numpy_u64(keys)
        sj, jv, jf, jst = jk.find_or_insert_kernel(sj, cfg_j, ju64.from_uint64(keys),
                                                   jnp.asarray(init), interpret=True)
        st, pv, pf, pst = pk.find_or_insert_kernel(sp, cfg_p, k, torch.from_numpy(init))
        core = pops.find_or_insert(so, cfg_p, k, torch.from_numpy(init))
        ctx = f"step {step}"
        assert st is sp
        _eq(pf.numpy(), jf, f"{ctx}: found")
        _eq(pst.numpy(), jst, f"{ctx}: status")
        _eq(pv.numpy(), jv, f"{ctx}: values")
        assert torch.equal(pv, core.values) and torch.equal(pf, core.found)
        assert torch.equal(pst, core.status)
        _state_eq(sj, sp, ctx)
        _state_eq(sj, so, f"{ctx} (the op)")


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_find_or_insert_kernel_on_the_hmem_tier(dual):
    """The 'hmem' tier's readback reads the host plane through gather_rows
    (the reference, find_mod.gather_values): equal to the JAX wrapper on a
    device-memory table, whose results do not depend on the tier."""
    rng = np.random.default_rng(9 + dual)
    cfg_j, sj, cfg_p, sp = _pair(dual, policy="lfu", tier="hmem")
    for step in range(5):
        keys = _random_batch(rng, 160, 2**16)
        init = rng.normal(size=(160, 4)).astype(np.float32)
        sj, jv, jf, jst = jk.find_or_insert_kernel(sj, cfg_j, ju64.from_uint64(keys),
                                                   jnp.asarray(init), interpret=True)
        _, pv, pf, pst = pk.find_or_insert_kernel(sp, cfg_p, pu64.from_numpy_u64(keys),
                                                  torch.from_numpy(init))
        _eq(pf.numpy(), jf, f"step {step}: found")
        _eq(pst.numpy(), jst, f"step {step}: status")
        _eq(pv.numpy(), jv, f"step {step}: values")
        _state_eq(sj, sp, f"step {step}")
    assert (pst.numpy() >= 3).any()                # evicted or rejected lanes were read


class TestFindOrInsertSinglePass:
    """find_or_insert_kernel issues no probe beyond the closure's own: its
    readback gathers at the closure's published post-op locations."""

    @staticmethod
    def _old_style(state, cfg, k, init):
        """The three-pass sequence, spelled out on the port's plain path:
        pre-locate, upsert, post-locate, gather."""
        pre = pfind.locate(state, cfg, k)
        res = pmerge.upsert(state, cfg, k, init, write_hit_values=False)
        post = pfind.locate(res.state, cfg, k)
        vals = pfind.gather_values(res.state, post, cfg.dim, cfg.value_tier)
        vals = torch.where(post.found[:, None], vals, init[:, :cfg.dim])
        return res.state, vals, pre.found, res.status

    @pytest.mark.parametrize("policy", ["lru", "lfu"])
    @pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
    def test_parity_with_three_pass_reference(self, dual, policy):
        """The wrapper against the three-pass sequence and the JAX op."""
        rng = np.random.default_rng(29 + dual)
        cfg_j, sj, cfg_p, s_new = _pair(dual, policy)
        s_old = ptable.create(cfg_p, "cpu")
        for step in range(6):                      # past capacity: hits, evicts, rejects
            keys = _random_batch(rng, 160, 2**16)
            init = rng.normal(size=(160, 4)).astype(np.float32)
            k = pu64.from_numpy_u64(keys)
            _, vn, fn, stn = pk.find_or_insert_kernel(s_new, cfg_p, k, torch.from_numpy(init))
            _, vo, fo, sto = self._old_style(s_old, cfg_p, k, torch.from_numpy(init))
            rj = jops.find_or_insert(sj, cfg_j, ju64.from_uint64(keys), jnp.asarray(init),
                                     backend="jnp")
            sj = rj.state
            ctx = f"dual={dual} {policy} step {step}"
            assert torch.equal(fn, fo) and torch.equal(stn, sto) and torch.equal(vn, vo), ctx
            _eq(fn.numpy(), rj.found, f"{ctx}: found")
            _eq(stn.numpy(), rj.status, f"{ctx}: status")
            _eq(vn.numpy(), rj.values, f"{ctx}: values")
            _state_eq(sj, s_new, ctx)
            _state_eq(sj, s_old, f"{ctx} (three passes)")

    @pytest.mark.parametrize("path", ["wrapper", "op"])
    def test_hit_evicted_within_same_batch_reports_gone(self, path):
        """Under LFU a batch can hit key A (count 1 -> 2) and in the same
        closure admit a miss B (count 3) that evicts A's slot: A's lane
        gets its init row back, never B's value."""
        cfg = ptable.HKVConfig(capacity=128, dim=2, score_policy="lfu")
        state = ptable.create(cfg, "cpu")
        pops.insert_or_assign(state, cfg, pu64.from_numpy_u64(np.array([1], np.uint64)),
                              torch.full((1, 2), 50.0))
        others = pu64.from_numpy_u64(np.arange(2, 129, dtype=np.uint64))   # fills the bucket
        for _ in range(3):                         # others: count 3
            pops.insert_or_assign(state, cfg, others, torch.zeros((127, 2)))
        batch = pu64.from_numpy_u64(np.array([1, 999, 999, 999], np.uint64))
        init = torch.tensor([[-1.0, -1.0], [7.0, 7.0], [7.0, 7.0], [7.0, 7.0]])
        if path == "wrapper":
            state, vals, _found, status = pk.find_or_insert_kernel(state, cfg, batch, init)
        else:
            r = pops.find_or_insert(state, cfg, batch, init)
            vals, status = r.values, r.status
        assert status[0] == 1 and bool((status[1:] == 3).all())   # A updated, B evicts
        assert vals[0].tolist() == [-1.0, -1.0] and vals[1].tolist() == [7.0, 7.0]
        assert not bool(pops.contains(state, cfg, batch[:1])[0])   # A is gone

    @pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
    def test_kernel_path_launch_budget(self, dual, monkeypatch):
        """The port's own launches, counted on the kernel wrappers the
        stages call: the closure's locate and target passes (one digest_scan
        single, two upsert_probe dual), claim_scan on the miss lanes, one
        scatter_rows (no hit writes) and the readback's one gather_rows.
        No locate beyond the closure's."""
        counts = {}

        def counting(name):
            real = getattr(pk, name)

            def run(*a, **kw):
                counts[name] = counts.get(name, 0) + 1
                return real(*a, **kw)
            return run

        for name in ("digest_scan", "upsert_probe", "claim_scan", "gather_rows",
                     "scatter_rows", "find_scan"):
            monkeypatch.setattr(pk, name, counting(name))
        cfg = ptable.HKVConfig(capacity=2 * 128, dim=4, buckets_per_key=2 if dual else 1)
        state = ptable.create(cfg, "cpu")
        k = pu64.from_numpy_u64(np.arange(1, 65, dtype=np.uint64))
        pk.find_or_insert_kernel(state, cfg, k, torch.zeros((64, 4)))
        probe = {"upsert_probe": 2} if dual else {"digest_scan": 1}
        assert counts == {**probe, "claim_scan": 1, "scatter_rows": 1, "gather_rows": 1}
        counts.clear()                             # all hits: no victim stage
        pk.find_or_insert_kernel(state, cfg, k, torch.zeros((64, 4)))
        assert counts == {**probe, "scatter_rows": 1, "gather_rows": 1}


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_custom_scores_admission_parity(dual):
    """Admission control (Table 9): a low-score burst is rejected and a
    high-score one displaces residents, identically on both sides."""
    rng = np.random.default_rng(11)
    cfg_j, sj, cfg_p, sp = _pair(dual, policy="custom")
    resident = rng.integers(0, 2**40, size=3 * cfg_p.capacity).astype(np.uint64)
    for i in range(0, len(resident), 256):
        kb = resident[i:i + 256]
        v = np.zeros((len(kb), 4), np.float32)
        sj = jk.upsert_kernel(sj, cfg_j, ju64.from_uint64(kb), jnp.asarray(v),
                              custom_scores=ju64.from_uint64(_scores(1000, len(kb))),
                              interpret=True).state
        pk.upsert_kernel(sp, cfg_p, pu64.from_numpy_u64(kb), torch.from_numpy(v),
                         custom_scores=pu64.from_numpy_u64(_scores(1000, len(kb))))
    _state_eq(sj, sp, "resident fill")
    burst = rng.integers(2**41, 2**42, size=128).astype(np.uint64)
    zeros = np.zeros((128, 4), np.float32)
    for score, expect_any_admit in ((1, False), (10**9, True)):
        rj = jk.insert_and_evict_kernel(sj, cfg_j, ju64.from_uint64(burst), jnp.asarray(zeros),
                                        custom_scores=ju64.from_uint64(_scores(score, 128)),
                                        interpret=True)
        rp = pk.insert_and_evict_kernel(sp, cfg_p, pu64.from_numpy_u64(burst),
                                        torch.from_numpy(zeros),
                                        custom_scores=pu64.from_numpy_u64(_scores(score, 128)))
        sj = rj.state
        _eq(rp.status.numpy(), rj.status, f"burst score={score}: status")
        _stream_eq(rj.evicted, rp.evicted, f"burst score={score}")
        _state_eq(sj, sp, f"burst score={score}")
        assert bool(np.isin(rp.status.numpy(), (2, 3)).any()) == expect_any_admit
    init = rng.normal(size=(128, 4)).astype(np.float32)
    mix = np.concatenate([burst[:64], rng.integers(2**43, 2**44, size=64).astype(np.uint64)])
    sj, jv, jf, jst = jk.find_or_insert_kernel(
        sj, cfg_j, ju64.from_uint64(mix), jnp.asarray(init),
        custom_scores=ju64.from_uint64(_scores(10**6, 128)), interpret=True)
    _, pv, pf, pst = pk.find_or_insert_kernel(
        sp, cfg_p, pu64.from_numpy_u64(mix), torch.from_numpy(init),
        custom_scores=pu64.from_numpy_u64(_scores(10**6, 128)))
    _eq(pf.numpy(), jf, "find_or_insert: found")
    _eq(pst.numpy(), jst, "find_or_insert: status")
    _eq(pv.numpy(), jv, "find_or_insert: values")
    _state_eq(sj, sp, "find_or_insert")


@pytest.mark.parametrize("update_hit_scores", [True, False])
@pytest.mark.parametrize("write_hit_values", [True, False])
def test_upsert_kernel_options_reach_the_closure(write_hit_values, update_hit_scores):
    """write_hit_values, update_hit_scores and insert_values pass to the
    closure unchanged (test_sweep_kernel.py relies on them through the
    reference's wrapper)."""
    rng = np.random.default_rng(19)
    cfg_j, sj, cfg_p, sp = _pair(True, policy="lfu")
    keys = rng.integers(0, 2**20, size=200).astype(np.uint64)
    vals = rng.normal(size=(200, 4)).astype(np.float32)
    sj = jk.upsert_kernel(sj, cfg_j, ju64.from_uint64(keys), jnp.asarray(vals),
                          interpret=True).state
    pk.upsert_kernel(sp, cfg_p, pu64.from_numpy_u64(keys), torch.from_numpy(vals))
    mix = np.concatenate([keys[:100], rng.integers(2**30, 2**31, size=60).astype(np.uint64)])
    upd = rng.normal(size=(160, 4)).astype(np.float32)
    ins = rng.normal(size=(160, 4)).astype(np.float32)
    kw = dict(write_hit_values=write_hit_values, update_hit_scores=update_hit_scores)
    before = pk.find_kernel(sp, cfg_p, pu64.from_numpy_u64(mix))[0].numpy()
    scores_before = sp.scores.clone()
    rj = jk.upsert_kernel(sj, cfg_j, ju64.from_uint64(mix), jnp.asarray(upd),
                          insert_values=jnp.asarray(ins), interpret=True, **kw)
    rp = pk.upsert_kernel(sp, cfg_p, pu64.from_numpy_u64(mix), torch.from_numpy(upd),
                          insert_values=torch.from_numpy(ins), **kw)
    _eq(rp.status.numpy(), rj.status, "status")
    _state_eq(rj.state, sp, "state")
    got = pk.find_kernel(sp, cfg_p, pu64.from_numpy_u64(mix))[0].numpy()
    hit = rp.status.numpy() == 1
    new = np.isin(rp.status.numpy(), (2, 3))
    assert hit.any() and new.any()
    np.testing.assert_array_equal(got[hit], (upd if write_hit_values else before)[hit])
    np.testing.assert_array_equal(got[new], ins[new])
    loc = rp.loc
    touched = sp.scores[loc.bucket[hit], loc.slot[hit]]
    assert torch.equal(touched, scores_before[loc.bucket[hit], loc.slot[hit]]) != update_hit_scores


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_kernel_path_matches_sequential_oracle(dual):
    """End to end against the per-key sequential oracle: statuses and
    contents."""
    rng = np.random.default_rng(23)
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=4, buckets_per_key=2 if dual else 1)
    state = ptable.create(cfg, "cpu")
    orc = OracleTable(cfg.capacity, 4, buckets_per_key=cfg.buckets_per_key)
    for _ in range(5):
        keys = rng.integers(0, 2**30, size=160).astype(np.uint64)
        vals = rng.normal(size=(160, 4)).astype(np.float32)
        res = pk.upsert_kernel(state, cfg, pu64.from_numpy_u64(keys), torch.from_numpy(vals))
        _eq(res.status.numpy(), np.asarray(orc.insert_or_assign(keys, vals), np.int8), "status")
    exp = pops.export_batch(state, cfg, 0, cfg.num_buckets)
    mask = exp.mask.numpy()
    got = {int(k): (int(s), v.tobytes()) for k, s, v, m in zip(
        exp.keys.numpy().view(np.uint64), exp.scores.numpy().view(np.uint64),
        exp.values.numpy(), mask) if m}
    want = {k: (e.score, np.asarray(e.value, np.float32).tobytes()) for k, e in orc.items()}
    assert got == want
