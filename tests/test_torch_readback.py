"""find_or_insert's readback (``core.ops.readback``) on a value plane in
host memory ('hmem'), where each key group's row crosses the host link
once and a second gather copies it to the group's lanes on the card.

Held here:

* on the CPU, against the JAX package (``jnp`` backend) and against an
  HBM twin fed the same inputs: the readback's rows (in the dtype the
  reference promotes to), ``found``, statuses and all four planes, bit for
  bit after every batch, through ``core.ops.find_or_insert`` and
  ``kernels.ops.find_or_insert_kernel`` on 'hmem' tables, in both bucket
  modes under ``lru``, ``lfu`` and ``custom``, on float32, bfloat16 and
  float16 planes, over batches of Zipf-heavy duplicates, all-unique keys,
  one key on every lane, EMPTY padding interleaved, misses that admission
  rejects (their init rows come back) and a hit that loses its slot
  within the batch (``lfu``, ``custom``);
* the kernel set's launches: two ``gather_rows`` a readback on 'hmem',
  one on an HBM plane;
* the live ``op.readback`` span counts ``plane_rows``: the found key
  groups on 'hmem', the found lanes on an HBM plane; with tracing off the
  span is the shared no-op;
* on the card (marked ``cuda``, skips without one): 851,968 lanes of a
  26-field Zipf(1.05) batch on a 2^20-slot 'hmem' table with V = 65, the
  kernel path against the plain path and the HBM twin, and the launches.

The JAX package is imported inside the tests that compare with it, so the
card's machine, which has no JAX, runs the ``cuda`` case:

    PYTHONPATH=src python -m pytest tests/test_torch_readback.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import ops as pops  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.core import u64 as pu64  # noqa: E402
from repro_torch.data.synthetic import zipf_ranks  # noqa: E402
from repro_torch.kernels import ops as pk  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
UPDATED, INSERTED, EVICTED, REJECTED = 1, 2, 3, 4
DIM, AUX, N = 4, 1, 320
# the port's tables: (value tier, entry point)
PORT = {"hmem_op": "hmem", "hmem_kernel": "hmem", "hbm_op": "hbm"}
# Criteo Terabyte's 26 categorical fields at --max-ind-range 40000000 (MLPerf DLRM)
CRITEO_FIELDS = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951, 2953546,
                 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295, 39664984,
                 585935, 12972, 108, 36)


def _jax():
    """The JAX package's modules (imported here, not at collection)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import ops as jops
    from repro.core import table as jtable
    from repro.core import u64 as ju64
    return jnp, jops, jtable, ju64


def _bits(x):
    """Value bits as uint16 (2-byte dtypes) or uint32 (float32)."""
    x = convert.values_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _eq(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=ctx)


def _live_keys(state) -> np.ndarray:
    k = state.keys.reshape(-1).numpy().view(np.uint64)
    return k[k != EMPTY]


def _zipf(rng, n, space=2**12):
    """Zipf(1.05) ids over `space`: a few hot keys on many lanes."""
    return zipf_ranks(rng, n, 1.05, space).astype(np.uint64) + np.uint64(1)


class _Tables:
    """One JAX table and the port's three (`PORT`), fed the same batches."""

    def __init__(self, dual, policy, dtype):
        self.jnp, self.jops, jtable, self.ju64 = _jax()
        kw = dict(capacity=2 * 128, dim=DIM, aux_value_dim=AUX,
                  buckets_per_key=2 if dual else 1, score_policy=policy)
        self.cfg_j = jtable.HKVConfig(value_dtype=getattr(self.jnp, dtype), **kw)
        self.sj = jtable.create(self.cfg_j)
        self.cfg = {tier: ptable.HKVConfig(value_dtype=getattr(torch, dtype), value_tier=tier,
                                           **kw) for tier in ("hmem", "hbm")}
        self.sp = {name: ptable.create(self.cfg[tier], "cpu") for name, tier in PORT.items()}
        self.custom = policy == "custom"

    def step(self, keys, init, scores, ctx):
        """One find_or_insert on every table; every output and plane held
        against the JAX table's.  Returns (status, rows) of the port."""
        cj = pj = None
        if self.custom:
            cj, pj = self.ju64.from_uint64(scores), pu64.from_numpy_u64(scores)
        rj = self.jops.find_or_insert(self.sj, self.cfg_j, self.ju64.from_uint64(keys),
                                      self.jnp.asarray(init), cj, backend="jnp")
        self.sj = rj.state
        kp, ip = pu64.from_numpy_u64(keys), torch.from_numpy(init)
        for name, tier in PORT.items():
            st, cfg, c = self.sp[name], self.cfg[tier], f"{ctx} ({name})"
            if name == "hmem_kernel":
                _, rows, found, status = pk.find_or_insert_kernel(st, cfg, kp, ip,
                                                                  custom_scores=pj)
            else:
                r = pops.find_or_insert(st, cfg, kp, ip, pj)
                rows, found, status = r.values, r.found, r.status
            assert rows.dtype == torch.float32, c      # init rows float32: promoted
            _eq(_bits(rows), _bits(rj.values), f"{c}: rows")
            _eq(found.numpy(), rj.found, f"{c}: found")
            _eq(status.numpy(), rj.status, f"{c}: status")
            arrays = convert.state_to_arrays(st)
            for f in convert.FIELDS:
                want = getattr(rj.state, f)
                if f == "values":
                    _eq(_bits(arrays[f]), _bits(want), f"{c}: state.values")
                else:
                    _eq(arrays[f], want, f"{c}: state.{f}")
        return status.numpy(), rows

    def live(self):
        return _live_keys(self.sp["hmem_op"])

    def present(self, keys):
        st = self.sp["hmem_op"]
        return pops.contains(st, self.cfg["hmem"], pu64.from_numpy_u64(keys)).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("policy", ["lru", "lfu", "custom"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_hmem_readback_matches_jax_and_the_hbm_twin(dual, policy, dtype):
    rng = np.random.default_rng(500 + 7 * dual + len(policy) + len(dtype))
    t = _Tables(dual, policy, dtype)
    custom = policy == "custom"

    def init():
        return rng.normal(size=(N, DIM + AUX)).astype(np.float32)

    def scores(lo=1, hi=2**20):
        return rng.integers(lo, hi, size=N).astype(np.uint64) if custom else None

    # Zipf-heavy duplicates, past capacity: inserts, then evictions
    for i in range(3):
        keys = _zipf(rng, N)
        status, _ = t.step(keys, init(), scores(), f"zipf {i}")
        assert len(np.unique(keys)) < 2 * N // 3
    assert t.sp["hmem_op"].load_factor() == 1.0

    # every key unique: half resident, half new
    live = rng.permutation(t.live())[: N // 2]
    fresh = rng.choice(2**40, size=N - len(live), replace=False).astype(np.uint64)
    fresh += np.uint64(2**41)
    status, _ = t.step(np.concatenate([live, fresh]), init(), scores(), "unique")
    assert (status == UPDATED).sum() == len(live)

    # one key on every lane: a resident, then a new one
    for name, key in (("one resident", t.live()[0]), ("one new", np.uint64(2**45))):
        status, rows = t.step(np.full(N, key, np.uint64), init(), scores(2**21, 2**22), name)
        assert len(np.unique(status)) == 1
        assert (_bits(rows) == _bits(rows[:1])).all(), name

    # EMPTY padding interleaved with hits and misses
    keys = _zipf(rng, N, 2**14)
    keys[::2] = EMPTY
    status, _ = t.step(keys, init(), scores(), "padding")
    assert (status[::2] == 0).all() and (status[1::2] > 0).all()

    # misses that admission rejects: their init rows come back
    fresh = rng.choice(2**40, size=N, replace=False).astype(np.uint64) + np.uint64(2**46)
    rows_in = init()
    status, rows = t.step(fresh, rows_in, scores(1, 2), "rejected")
    rej = status == REJECTED
    assert rej.any()
    _eq(_bits(rows[torch.from_numpy(rej)]), _bits(rows_in[rej, :DIM]), "rejected: init rows")

    # a hit that loses its slot within the batch: every resident touched
    # once (custom: to score 1), beside a miss that outbids the weakest
    # (custom: score 2^30; lfu: more duplicates than the weakest's count)
    live = t.live()
    miss = np.uint64(2**47)
    keys = np.concatenate([live, np.full(N - len(live), miss, np.uint64)])
    sc = None
    if custom:
        sc = np.concatenate([np.ones(len(live), np.uint64),
                             np.full(N - len(live), 2**30, np.uint64)])
    rows_in = init()
    status, rows = t.step(keys, rows_in, sc, "hit loses its slot")
    lost = (status == UPDATED) & ~t.present(keys)
    assert lost.any() == (policy != "lru")
    _eq(_bits(rows[torch.from_numpy(lost)]), _bits(rows_in[lost, :DIM]), "lost: init rows")


def _counting(monkeypatch, name="gather_rows"):
    """Count calls of a kernel wrapper where the kernel set looks it up."""
    counts = {name: 0}
    real = getattr(pk, name)

    def run(*a, **kw):
        counts[name] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pk, name, run)
    return counts


def _filled(tier, dual=True, seed=3):
    cfg = ptable.HKVConfig(capacity=2 * 128, dim=DIM, aux_value_dim=AUX,
                           buckets_per_key=2 if dual else 1, value_tier=tier)
    state = ptable.create(cfg, "cpu")
    rng = np.random.default_rng(seed)
    keys = pu64.from_numpy_u64(_zipf(rng, 3 * N))
    pops.insert_or_assign(state, cfg, keys, torch.ones(3 * N, DIM))
    return cfg, state, rng


@pytest.mark.parametrize("tier", ["hmem", "hbm"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_kernel_set_gathers_twice_on_hmem_once_on_hbm(dual, tier, monkeypatch):
    """find_or_insert_kernel's gather_rows calls: the group rows and their
    expansion on 'hmem', the lanes' rows on an HBM plane."""
    cfg, state, rng = _filled(tier, dual)
    counts = _counting(monkeypatch)
    keys = pu64.from_numpy_u64(_zipf(rng, N))
    pk.find_or_insert_kernel(state, cfg, keys, torch.zeros(N, DIM + AUX))
    assert counts["gather_rows"] == (2 if tier == "hmem" else 1)


@pytest.mark.parametrize("tier", ["hmem", "hbm"])
def test_readback_span_counts_plane_rows(tier):
    """Under a Tracer, op.readback carries plane_rows: the key groups
    present after the op on 'hmem', the lanes present after it on HBM
    (lru: a hit never loses its slot within the batch)."""
    cfg, state, rng = _filled(tier)
    for step in range(3):
        keys = _zipf(rng, N)
        keys[::7] = EMPTY
        tr = trace.Tracer()
        with trace.install(tr):
            r = pops.find_or_insert(state, cfg, pu64.from_numpy_u64(keys),
                                    torch.zeros(N, DIM))
        (sp,) = [s for s in tr.spans if s.name == "op.readback"]
        status = r.status.numpy()
        present = np.isin(status, (UPDATED, INSERTED, EVICTED))
        want = len(np.unique(keys[present])) if tier == "hmem" else int(present.sum())
        assert sp.counters() == {"plane_rows": want}, step
        assert 0 < want < N and (tier == "hbm" or want < present.sum())


def test_readback_span_is_the_noop_with_tracing_off(monkeypatch):
    made = []

    def recording(name):
        sp = trace.span(name)
        made.append((name, sp))
        return sp

    monkeypatch.setattr(pops, "span", recording)
    cfg, state, rng = _filled("hmem")
    before = len(trace.recorded())
    pops.find_or_insert(state, cfg, pu64.from_numpy_u64(_zipf(rng, N)), torch.zeros(N, DIM))
    assert [sp for name, sp in made if name == "op.readback"] == [trace.NOOP_SPAN]
    assert len(trace.recorded()) == before


@pytest.mark.cuda
def test_hmem_readback_on_the_card():
    """A train D step's lookup: 32,768 samples of Criteo's 26 fields at
    Zipf(1.05) (851,968 lanes) on a 2^20-slot table with a V = 65 plane in
    pinned host memory.  The kernel path equals the plain path and the HBM
    twin, bit for bit, in rows, found flags, statuses and planes; its
    readback launches gather_rows twice, the twin's once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    from repro_torch.kernels import _build

    n, dim = 32768 * len(CRITEO_FIELDS), 64
    kw = dict(capacity=2**20, dim=dim, buckets_per_key=2, aux_value_dim=1)
    cfgs = {tier: ptable.HKVConfig(value_tier=tier, **kw) for tier in ("hmem", "hbm")}
    runs = {"kernel": ("hmem", "auto"), "plain": ("hmem", "plain"), "hbm": ("hbm", "auto")}
    states = {name: ptable.create(cfgs[tier], "cuda") for name, (tier, _) in runs.items()}
    assert states["kernel"].values.shape[1] == 65 and states["kernel"].host_values
    rng = np.random.default_rng(11)
    base = np.cumsum((0,) + CRITEO_FIELDS[:-1])
    for step in range(3):
        ids = np.stack([zipf_ranks(rng, 32768, 1.05, k) + b
                        for k, b in zip(CRITEO_FIELDS, base)], axis=1).reshape(-1)
        keys = torch.from_numpy(ids).cuda()
        init = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).cuda()
        got = {}
        for name, (tier, backend) in runs.items():
            torch.cuda.synchronize()
            _build.reset_counts()
            got[name] = pops.find_or_insert(states[name], cfgs[tier], keys, init,
                                            backend=backend)
            torch.cuda.synchronize()
            if backend == "auto":
                assert _build.launch_counts["gather_rows"] == (2 if tier == "hmem" else 1), name
        ctx = f"step {step}"
        for name in ("plain", "hbm"):
            for f in ("values", "found", "status"):
                assert torch.equal(getattr(got["kernel"], f), getattr(got[name], f)), \
                    f"{ctx}: {name} {f}"
            for f in ("keys", "digests", "scores", "values"):
                a, b = getattr(states["kernel"], f), getattr(states[name], f)
                assert torch.equal(a.cpu(), b.cpu()), f"{ctx}: {name} plane {f}"
        distinct = int(torch.unique(keys).numel())
        assert distinct < n // 3, ctx                    # most lanes repeat a key
        if step:
            assert bool(got["kernel"].found.float().mean() > 0.5), ctx
