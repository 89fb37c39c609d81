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
from repro_torch.kernels import _build, find_scan, scatter, upsert_scan  # noqa: E402

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


def test_single_bucket_insert_needs_digest_scan(dev):
    t = repro_torch.HKVTable.create(capacity=128, dim=4, device=dev)
    with pytest.raises(NotImplementedError, match="digest_scan"):
        t.insert_or_assign([1, 2], torch.zeros(2, 4, device=dev))
