"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc and skip without
one.  On a machine with a card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerance: exact equality (integer maths and float copies only).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import find as find_mod  # noqa: E402
from repro_torch import SweepPredicate  # noqa: E402
from repro_torch.core import predicates, u64  # noqa: E402
from repro_torch.kernels import _build, digest_scan, find_scan, gather, scatter  # noqa: E402
from repro_torch.kernels import sweep_scan, upsert_scan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(dev, policy="lfu", capacity=64 * 128, batches=6):
    """A plain-path table on the card driven past λ = 1.0."""
    g = np.random.default_rng(3)
    t = repro_torch.HKVTable.create(capacity=capacity, dim=32, buckets_per_key=2,
                                    score_policy=policy, device=dev, backend="plain")
    for _ in range(batches):
        keys = g.integers(0, 2**64 - 2, size=capacity // 2, dtype=np.uint64)
        t.insert_or_assign(keys, torch.randn(capacity // 2, 32, device=dev))
    return t


def _queries(t, n=4096):
    g = torch.Generator(device=t.device).manual_seed(5)
    live = t.state.keys[t.state.keys != -1]
    q = torch.cat([live[torch.randint(0, live.numel(), (n // 2,), generator=g, device=t.device)],
                   torch.randint(0, 2**62, (n // 2,), generator=g, device=t.device)])
    q[::17] = -1
    return q, find_mod.probe_keys(t.cfg, q)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("use_digest", [True, False])
def test_find_scan_kernel_matches_plain(dev, use_digest):
    t = _table(dev)
    q, p = _queries(t)
    s = t.state
    args = (s.digests, s.keys, s.scores, s.values, p.bucket1, p.bucket2, p.digest, q)
    _same(find_scan.find_scan(*args, use_digest=use_digest),
          find_scan.find_scan_plain(*args, use_digest=use_digest))


def test_upsert_probe_and_claim_scan_kernels_match_plain(dev):
    t = _table(dev)
    q, p = _queries(t)
    s = t.state
    args = (s.digests, s.keys, s.scores, p.bucket1, p.bucket2, p.digest, q)
    _same(upsert_scan.upsert_probe(*args), upsert_scan.upsert_probe_plain(*args))
    b = torch.randint(0, t.cfg.num_buckets, (4096,), device=dev)
    r = torch.randint(-3, 140, (4096,), device=dev)
    _same(upsert_scan.claim_scan(s.keys, s.scores, b, r),
          upsert_scan.claim_scan_plain(s.keys, s.scores, b, r))


@pytest.mark.parametrize("add", [False, True])
def test_scatter_rows_kernel_matches_plain(dev, add):
    v = torch.randn(8192, 32, device=dev)
    rows = torch.randperm(8192, device=dev)[:3000]
    mask = torch.rand(3000, device=dev) < 0.6
    rows[~mask] = rows[mask][0]
    upd = torch.randn(3000, 32, device=dev)
    vk, vp = v.clone(), v.clone()
    scatter.scatter_rows(vk, rows, upd, mask, add)
    scatter.scatter_rows_plain(vp, rows, upd, mask, add)
    assert torch.equal(vk, vp) and not torch.equal(vk, v)


@pytest.mark.parametrize("policy", ["lru", "lfu", "custom"])
def test_kernel_path_matches_plain_path(dev, policy):
    kw = dict(capacity=32 * 128, dim=32, buckets_per_key=2, score_policy=policy, device=dev)
    tk = repro_torch.HKVTable.create(backend="auto", **kw)
    tp = repro_torch.HKVTable.create(backend="plain", **kw)
    g = np.random.default_rng(9)
    _build.reset_counts()
    for _ in range(10):
        keys = g.integers(0, 3 * 32 * 128, size=2000).astype(np.int64)
        keys[::50] = -1
        vals = torch.randn(2000, 32, device=dev)
        cs = g.integers(0, 40, size=2000).astype(np.uint64) if policy == "custom" else None
        assert torch.equal(tk.insert_or_assign(keys, vals, cs).status,
                           tp.insert_or_assign(keys, vals, cs).status)
        for name in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(tk.state, name), getattr(tp.state, name)), name
        fk, fp = tk.find(keys), tp.find(keys)
        assert torch.equal(fk.values, fp.values) and torch.equal(fk.found, fp.found)
    assert all(_build.launch_counts[k] > 0 for k in
               ("find_scan", "upsert_probe", "claim_scan", "scatter_rows"))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_digest_scan_kernel_matches_plain(dev, dual):
    t = _table(dev)
    q, p = _queries(t)
    s = t.state
    for b in (p.bucket1, p.bucket2):
        _same(digest_scan.digest_scan(s.digests, s.keys, b, p.digest, q),
              digest_scan.digest_scan_plain(s.digests, s.keys, b, p.digest, q))


@pytest.mark.parametrize("width", [32, 6])   # 16-byte rows and 4-byte rows
def test_gather_rows_kernel_matches_plain(dev, width):
    v = torch.randn(8192, width, device=dev)
    rows = torch.randint(-5, 8200, (3000,), device=dev)
    mask = torch.rand(3000, device=dev) < 0.5
    got = gather.gather_rows(v, rows, mask)
    assert torch.equal(got, gather.gather_rows_plain(v, rows.clamp(0, 8191), mask))
    assert not got[~mask].any()


@pytest.mark.parametrize("kind", predicates.KINDS)
def test_sweep_match_kernel_matches_plain(dev, kind):
    t = _table(dev)
    s = t.state
    live = s.keys[s.keys != -1]
    sc = s.scores[s.keys != -1].sort().values
    pred = {"always": SweepPredicate.always(),
            "score_lt": SweepPredicate.score_below(sc[sc.numel() // 2]),
            "score_ge": SweepPredicate.score_at_least(sc[sc.numel() // 2]),
            "epoch_lt": SweepPredicate.expire_before(1),
            "key_range": SweepPredicate.key_in_range(2**62, 2**63 + 2**62)}[kind]
    _same(sweep_scan.sweep_match(s.keys, s.scores, pred),
          sweep_scan.sweep_match_plain(s.keys, s.scores, pred))
    assert live.numel() > 0


def test_sweep_match_epoch_compares_unsigned_high_halves(dev):
    """Scores at and above 2^63: the high half is taken by a logical
    shift, so 0x8000_0001 << 32 is not below epoch 5."""
    keys = torch.arange(128, device=dev).reshape(1, 128)
    words = [(2**31 + 1) << 32, 4 << 32, 5 << 32, 2**64 - 1] * 32
    scores = torch.tensor([u64.to_signed(w) for w in words], device=dev).reshape(1, 128)
    pred = SweepPredicate.expire_before(5)
    m, c = sweep_scan.sweep_match(keys, scores, pred)
    _same((m, c), sweep_scan.sweep_match_plain(keys, scores, pred))
    assert int(c) == 32 and m[0, 1] and not m[0, 0]


def test_single_bucket_insert_and_find_ptr_match_plain(dev):
    """Single-bucket mode (the HKVConfig default) on the card: the kernel
    path (digest_scan locate) equals the plain path, op by op."""
    kw = dict(capacity=16 * 128, dim=8, score_policy="lfu", device=dev)
    tk = repro_torch.HKVTable.create(backend="auto", **kw)
    tp = repro_torch.HKVTable.create(backend="plain", **kw)
    g = np.random.default_rng(4)
    _build.reset_counts()
    for _ in range(8):
        keys = g.integers(0, 6 * 16 * 128, size=1000).astype(np.int64)
        keys[::40] = -1
        vals = torch.randn(1000, 8, device=dev)
        assert torch.equal(tk.insert_or_assign(keys, vals).status,
                           tp.insert_or_assign(keys, vals).status)
        for name in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(tk.state, name), getattr(tp.state, name)), name
        lk, lp = tk.find_ptr(keys), tp.find_ptr(keys)
        for x, y in zip(lk, lp):
            assert torch.equal(x, y)
        assert torch.equal(tk.contains(keys), tp.contains(keys))
    assert _build.launch_counts["digest_scan"] > 0 and _build.launch_counts["upsert_probe"] == 0


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_every_op_kernel_path_matches_plain(dev, dual):
    """insert_and_evict, find_or_insert, find at a locate, erase_if and
    evict_if through 'auto' and 'plain' on the card: equal results."""
    from repro_torch.core import ops

    kw = dict(capacity=16 * 128, dim=8, buckets_per_key=2 if dual else 1,
              score_policy="custom", device=dev)
    tk = repro_torch.HKVTable.create(backend="auto", **kw)
    tp = repro_torch.HKVTable.create(backend="plain", **kw)
    g = np.random.default_rng(6)

    def same_state():
        for name in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(tk.state, name), getattr(tp.state, name)), name

    _build.reset_counts()
    for step in range(6):
        keys = g.integers(0, 6 * 16 * 128, size=1000).astype(np.int64)
        keys[::40] = -1
        vals = torch.randn(1000, 8, device=dev)
        cs = g.integers(0, 50, size=1000).astype(np.uint64)
        rk, rp = tk.insert_and_evict(keys, vals, cs), tp.insert_and_evict(keys, vals, cs)
        assert torch.equal(rk.status, rp.status)
        for x, y in zip(rk.evicted, rp.evicted):
            assert torch.equal(x, y)
        same_state()
        fk = tk.find_or_insert(keys[::-1].copy(), vals, cs, return_evicted=True)
        fp = tp.find_or_insert(keys[::-1].copy(), vals, cs, return_evicted=True)
        for x, y in zip(fk[1:4], fp[1:4]):
            assert torch.equal(x, y)
        same_state()
        loc = tp.find_ptr(keys)
        for x, y in zip(tk.find_ptr(keys), loc):
            assert torch.equal(x, y)
        a = ops.find(tk.state, tk.cfg, tk.keys(keys), loc, backend="auto")
        b = ops.find(tp.state, tp.cfg, tp.keys(keys), loc, backend="plain")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    ek = tk.erase_if(SweepPredicate.score_below(25))
    ep = tp.erase_if(SweepPredicate.score_below(25))
    assert int(ek.swept) == int(ep.swept) > 0
    same_state()
    vk, vp = tk.evict_if(SweepPredicate.always(), 300), tp.evict_if(SweepPredicate.always(), 300)
    for x, y in zip(vk.evicted, vp.evicted):
        assert torch.equal(x, y)
    same_state()
    assert all(_build.launch_counts[k] > 0 for k in ("gather_rows", "digest_scan", "sweep_match"))
