"""The port's batch closure runs victim_at_rank and the target pass on the
miss lanes only.

`repro_torch.core.merge.upsert` hands the victim stage (claim_scan on the
card) the canonical prefix of miss lanes and pads its outputs back to the
batch, and hands the select stage (upsert_probe's target mode on the card)
the miss lanes as a lane gate; the JAX package's closure runs both on every
lane.  For every score policy, both bucket modes and tables at λ 0.5 and
1.0, batches with duplicates, EMPTY padding and mostly resident keys, and a
batch with no miss at all, run through both closures:

- the stages (wrapped to record their lanes) get exactly the batch's
  distinct miss keys, counted independently from the JAX package's locate
  on the same state; the victim stage is not called without one, and the
  select stage's gate is then all off;
- through the kernel stages (the wrappers' plain versions on the CPU),
  a dual-bucket upsert calls upsert_probe once in match mode on every lane
  and once in target mode gated to those miss lanes, and a single-bucket
  one never;
- statuses, pre-op found, post-op locations, the eviction stream and the
  full state equal the JAX package's bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import find as jfind  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import merge as pmerge  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.kernels import ops as pkops  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
POLICIES = ("lru", "lfu", "epoch_lru", "epoch_lfu", "custom")
CAPACITY, DIM, BATCH = 4 * 128, 4, 160


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


class Pair:
    """One table state on both sides, and the port's recording stages."""

    def __init__(self, policy, dual, lam, seed, kernel=False):
        self.policy = policy
        self.rng = np.random.default_rng(seed)
        kw = dict(capacity=CAPACITY, dim=DIM, buckets_per_key=2 if dual else 1,
                  score_policy=policy)
        self.jcfg, self.pcfg = jtable.HKVConfig(**kw), ptable.HKVConfig(**kw)
        self.jstate = jtable.create(self.jcfg)
        self.lanes, self.target_lanes = [], []
        base = (pkops.kernel_stages(self.pcfg, torch.device("cpu")) if kernel
                else pmerge.plain_stages())

        def victim_at_rank(state, cfg, buckets, rank):
            self.lanes.append(buckets.shape[0])
            return base.victim_at_rank(state, cfg, buckets, rank)

        def select_target(state, cfg, probe, lanes):
            self.target_lanes.append(int(lanes.sum()))
            return base.select_target(state, cfg, probe, lanes)

        self.stages = base._replace(victim_at_rank=victim_at_rank, select_target=select_target)
        fill = self.rng.integers(1, 2**63, size=int(lam * CAPACITY) if lam < 1 else 3 * CAPACITY,
                                 dtype=np.uint64)
        for chunk in np.array_split(fill, 4):
            self.jstate = self._jax_upsert(chunk, self.rows(len(chunk)),
                                           self.custom(len(chunk))).state
        self.pstate = convert.state_from_arrays(self.jstate, device="cpu")

    def rows(self, n):
        return self.rng.normal(size=(n, DIM)).astype(np.float32)

    def custom(self, n):
        """A narrow score range, so that existing entries win ties."""
        if self.policy != "custom":
            return None
        return self.rng.integers(0, 64, size=n).astype(np.uint64)

    def _jax_upsert(self, keys, vals, cs=None):
        return jmerge.upsert(self.jstate, self.jcfg, ju64.from_uint64(keys), jnp.asarray(vals),
                             custom_scores=None if cs is None else ju64.from_uint64(cs),
                             return_evicted=True)

    def resident(self):
        k = ju64.to_uint64(self.jstate.keys).reshape(-1)
        return k[k != EMPTY]

    def miss_count(self, keys):
        """Distinct valid keys the JAX package's locate does not find."""
        loc = jfind.locate(self.jstate, self.jcfg, ju64.from_uint64(keys))
        miss = (keys != EMPTY) & ~np.asarray(loc.found)
        return len(np.unique(keys[miss]))

    def step(self, keys, ctx):
        """One upsert on both sides; returns the lanes the stage got."""
        vals, cs = self.rows(len(keys)), self.custom(len(keys))
        want_lanes = self.miss_count(keys)
        jr = self._jax_upsert(keys, vals, cs)
        self.lanes.clear()
        self.target_lanes.clear()
        pr = pmerge.upsert(self.pstate, self.pcfg, torch.from_numpy(keys.view(np.int64).copy()),
                           torch.from_numpy(vals), stages=self.stages, return_evicted=True,
                           custom_scores=None if cs is None
                           else torch.from_numpy(cs.view(np.int64).copy()))
        self.jstate = jr.state
        assert self.lanes == ([want_lanes] if want_lanes else []), \
            f"{ctx}: victim_at_rank got {self.lanes}, the batch has {want_lanes} distinct misses"
        assert self.target_lanes == [want_lanes], \
            f"{ctx}: select_target's gate holds {self.target_lanes}, the batch has {want_lanes} misses"
        _eq(pr.status.numpy(), jr.status, f"{ctx}: status")
        _eq(pr.found.numpy(), jr.found, f"{ctx}: found")
        loc = convert.locate_to_arrays(pr.loc)
        for f in ("found", "bucket", "slot", "row"):
            _eq(loc[f], getattr(jr.loc, f), f"{ctx}: loc.{f}")
        ev = convert.stream_to_arrays(pr.evicted)
        for f in ("key_hi", "key_lo", "values", "score_hi", "score_lo", "mask"):
            _eq(ev[f], getattr(jr.evicted, f), f"{ctx}: evicted.{f}")
        got = convert.state_to_arrays(self.pstate)
        for f in convert.FIELDS:
            _eq(got[f], getattr(self.jstate, f), f"{ctx}: state.{f}")
        return want_lanes


@pytest.mark.parametrize("lam", (0.5, 1.0))
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_victim_stage_gets_the_miss_lanes_only(policy, dual, lam):
    p = Pair(policy, dual, lam, seed=300 + 10 * POLICIES.index(policy) + 2 * dual + int(lam))
    rng = p.rng
    for step in range(2):
        # mostly resident keys, a few fresh ones, duplicates of both, EMPTY padding
        res = p.resident()
        keys = np.concatenate([rng.choice(res, size=BATCH - BATCH // 8),
                               rng.integers(1, 2**64 - 2, size=BATCH // 8, dtype=np.uint64)])
        keys[rng.integers(0, BATCH, size=BATCH // 4)] = rng.choice(keys, size=BATCH // 4)
        keys[rng.integers(0, BATCH, size=6)] = EMPTY
        rng.shuffle(keys)
        lanes = p.step(keys, f"mixed batch {step}")
        assert 0 < lanes < len(np.unique(keys[keys != EMPTY]))
    # no miss: resident keys only, with duplicates and padding
    keys = rng.choice(p.resident(), size=BATCH)
    keys[::9] = EMPTY
    assert p.step(keys, "no-miss batch") == 0


@pytest.mark.parametrize("lam", (0.5, 1.0))
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("policy", POLICIES)
def test_target_pass_gets_the_miss_lanes_only(policy, dual, lam, monkeypatch):
    p = Pair(policy, dual, lam, seed=500 + 10 * POLICIES.index(policy) + 2 * dual + int(lam),
             kernel=True)
    calls = []
    probe = pkops.upsert_probe

    def recording_probe(*args, mode="both", lanes=None, **kw):
        calls.append((mode, args[3].shape[0] if lanes is None else int(lanes.sum())))
        out = probe(*args, mode=mode, lanes=lanes, **kw)
        if lanes is not None:   # an off lane reports tgt_sel 0
            assert not out[3][~lanes].any()
        return out

    monkeypatch.setattr(pkops, "upsert_probe", recording_probe)
    rng = p.rng
    for step in range(3):
        res = p.resident()
        if step < 2:   # mostly resident keys, a few fresh, duplicates, EMPTY padding
            keys = np.concatenate([rng.choice(res, size=BATCH - BATCH // 8),
                                   rng.integers(1, 2**64 - 2, size=BATCH // 8, dtype=np.uint64)])
            keys[rng.integers(0, BATCH, size=BATCH // 4)] = rng.choice(keys, size=BATCH // 4)
        else:          # no miss
            keys = rng.choice(res, size=BATCH)
        keys[rng.integers(0, BATCH, size=6)] = EMPTY
        calls.clear()
        misses = p.step(keys, f"batch {step}")
        assert (misses > 0) == (step < 2)
        assert calls == ([("match", BATCH), ("target", misses)] if dual else []), \
            f"batch {step}: upsert_probe calls {calls}, the batch has {misses} misses"
