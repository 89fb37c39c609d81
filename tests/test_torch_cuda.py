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
    """The single-row form on each candidate row, and the dual form (one
    launch over both rows, merged) on a dual table."""
    t = _table(dev)
    q, p = _queries(t)
    s = t.state
    for b in (p.bucket1, p.bucket2):
        _same(digest_scan.digest_scan(s.digests, s.keys, b, p.digest, q),
              digest_scan.digest_scan_plain(s.digests, s.keys, b, p.digest, q))
    if dual:
        args = (s.digests, s.keys, p.bucket1, p.digest, q, p.bucket2)
        got = digest_scan.digest_scan(*args)
        _same(got, digest_scan.digest_scan_plain(*args))
        assert (got[2] == 1).any() and ((got[1] == 1) & (got[2] == 0)).any()


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4095])
def test_digest_scan_dual_form_at_any_length_and_on_collisions(dev, n):
    """Lane counts that are no multiple of the 4 queries a warp serves;
    EMPTY queries; forced digest collisions (absent keys given the digest
    of a live slot of their bucket1 row, or of their bucket2 row); lanes
    whose two rows coincide."""
    t = _table(dev)
    q, p = _queries(t, n=max(n, 8))
    q, b1, b2, qd = q[:n].clone(), p.bucket1[:n].clone(), p.bucket2[:n].clone(), p.digest[:n].clone()
    s = t.state
    g = torch.Generator(device=dev).manual_seed(11)
    absent = ~torch.isin(q, s.keys.view(-1)) & (q != -1)
    lanes = torch.nonzero(absent)[:, 0]
    for i, lane in enumerate(lanes[: lanes.numel() // 2].tolist()):
        row = int((b1 if i % 2 else b2)[lane])
        live = torch.nonzero(s.keys[row] != -1)[:, 0]
        qd[lane] = s.digests[row, live[torch.randint(0, live.numel(), (1,), generator=g,
                                                      device=dev)]]
    b2[::7] = b1[::7]
    q[::5] = -1
    args = (s.digests, s.keys, b1, qd, q, b2)
    got = digest_scan.digest_scan(*args)
    _same(got, digest_scan.digest_scan_plain(*args))
    assert not got[1][q == -1].any()
    _same(digest_scan.digest_scan(*args[:5]), digest_scan.digest_scan_plain(*args[:5]))


def _pinned(shape, dtype=torch.float32):
    return _build.pinned_empty(shape, dtype)


@pytest.mark.parametrize("v,width", [(32, None), (65, None), (65, 64), (33, 32)])
def test_gather_rows_on_a_pinned_host_plane(dev, v, width):
    """gather_rows reading an 'hmem' plane in pinned host memory over the
    host link: equal to the plain gather of the same plane's rows."""
    host = _pinned((8192, v))
    host.copy_(torch.randn(8192, v))
    assert _build.device_pointer(host) == host.data_ptr()
    rows = torch.randint(-5, 8200, (3001,), device=dev)
    mask = torch.rand(3001, device=dev) < 0.5
    got = gather.gather_rows(host, rows, mask, width)
    want = gather.gather_rows_plain(host, rows.clamp(0, 8191).cpu(), mask.cpu(), width)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("add", [False, True], ids=["set", "add"])
@pytest.mark.parametrize("v", [32, 65])
def test_scatter_rows_on_a_pinned_host_plane(dev, v, add):
    """scatter_rows writing (and for add, reading) an 'hmem' plane in
    pinned host memory: equal to the kernel on a copy of the plane on the
    card, and to the plain version on the CPU (unique rows: each sum is
    one rounded add)."""
    base = torch.randn(8192, v)
    host = _pinned((8192, v))
    host.copy_(base)
    card = base.to(dev)
    rows = torch.randperm(8192, device=dev)[:3001]
    rows[::50] = 9000   # outside the plane: dropped
    upd = torch.randn(3001, v, device=dev)
    mask = torch.rand(3001, device=dev) < 0.7
    scatter.scatter_rows(host, rows, upd, mask, add)
    scatter.scatter_rows(card, rows, upd, mask, add)
    torch.cuda.synchronize()
    want = base.clone()
    scatter.scatter_rows_plain(want, rows.cpu(), upd.cpu(), mask.cpu(), add)
    assert torch.equal(host, card.cpu()) and torch.equal(host, want)


def test_an_unpinned_cpu_plane_beside_card_keys_raises(dev):
    """The host tier is pinned memory the card can map; any other CPU
    plane beside CUDA tensors is refused, never gathered on the CPU."""
    plane = torch.randn(1024, 8)
    rows = torch.randint(0, 1024, (64,), device=dev)
    mask = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="pinned"):
        gather.gather_rows(plane, rows, mask)
    with pytest.raises(ValueError, match="pinned"):
        scatter.scatter_rows(plane, rows, torch.randn(64, 8, device=dev), mask, False)
    # the kernels that read values on the card only refuse a host plane
    t = _table(dev)
    q, p = _queries(t, 64)
    s = t.state
    with pytest.raises(ValueError):
        find_scan.find_scan(s.digests, s.keys, s.scores, _pinned(s.values.shape), p.bucket1,
                            p.bucket2, p.digest, q)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_hmem_table_on_the_card_matches_hbm(dev, dual):
    """An 'hmem' table on the card: values in pinned host memory, the other
    planes on the card; every op through 'auto' equal to an 'hbm' twin,
    and its launches through the 'hmem' routes (find: digest_scan and
    gather_rows, no find_scan; the gradient step: the composed one)."""
    from repro_torch.embedding import SparseOptimizer

    kw = dict(capacity=16 * 128, dim=8, aux_value_dim=1, buckets_per_key=2 if dual else 1,
              score_policy="lru", device=dev)
    th = repro_torch.HKVTable.create(value_tier="hmem", **kw)
    tb = repro_torch.HKVTable.create(**kw)
    st = th.state
    assert st.host_values and st.keys.is_cuda and st.scores.is_cuda and st.digests.is_cuda
    assert _build.device_pointer(st.values) == st.values.data_ptr()
    g = np.random.default_rng(8)

    def same_state(ctx):
        for name in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(th.state, name).cpu(), getattr(tb.state, name).cpu()), \
                f"{ctx}: {name}"

    opt = SparseOptimizer("rowwise_adagrad")
    for step in range(5):
        keys = g.integers(0, 6 * 16 * 128, size=1000).astype(np.int64)
        keys[::40] = -1
        vals = torch.randn(1000, 8, device=dev)
        for name, args in (("insert_and_evict", (keys, vals)), ("find_or_insert", (keys, vals)),
                           ("insert_or_assign", (keys, vals))):
            a, b = getattr(th, name)(*args), getattr(tb, name)(*args)
            for x, y in zip(a[1:], b[1:]):
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), name
            same_state(f"step {step} {name}")
        _build.reset_counts()
        fh = th.find(keys)
        assert dict(_build.launch_counts) == {"digest_scan": 1, "gather_rows": 1}
        fb = tb.find(keys)
        for x, y in zip(fh, fb):
            assert torch.equal(x, y)
        uniq = torch.unique(torch.as_tensor(keys[keys >= 0], device=dev))
        grads = torch.randn(uniq.numel(), 8, device=dev)
        _build.reset_counts()
        s = th.session()
        s.update_rows(uniq, repro_torch.RowUpdate(opt, grads))
        s.commit()
        assert dict(_build.launch_counts) == {"digest_scan": 1, "gather_rows": 1,
                                              "scatter_rows": 1}
        s = tb.session()
        s.update_rows(uniq, repro_torch.RowUpdate(opt, grads))
        s.commit()
        same_state(f"step {step} update_rows")
        th.assign(keys[:300], vals[:300])
        tb.assign(keys[:300], vals[:300])
        th.erase(keys[:50])
        tb.erase(keys[:50])
        same_state(f"step {step} assign, erase")
    e1, e2 = th.evict_if(SweepPredicate.always(), 64), tb.evict_if(SweepPredicate.always(), 64)
    for x, y in zip(e1.evicted, e2.evicted):
        assert torch.equal(x, y)
    snap = th.snapshot()
    assert _build.device_pointer(snap.state.values) != st.values.data_ptr()
    th.clear()
    tb.clear()
    same_state("clear")
    assert snap.size() > 0 and th.size() == 0


def test_tiered_table_on_the_card_matches_plain(dev):
    """A TieredHKVTable on the card (hot tier in HBM, cold tier's values in
    pinned host memory) through 'auto' and 'plain': equal statuses,
    counters, values and both tiers' states."""
    kw = dict(hot_capacity=4 * 128, cold_capacity=16 * 128, dim=8, aux_value_dim=1,
              buckets_per_key=2, device=dev)
    tk = repro_torch.TieredHKVTable.create(backend="auto", **kw)
    tp = repro_torch.TieredHKVTable.create(backend="plain", **kw)
    assert tk.cold.state.host_values and not tk.hot.state.host_values
    g = np.random.default_rng(12)
    for step in range(6):
        keys = g.integers(0, 6000, size=900).astype(np.int64)
        vals = torch.randn(900, 8, device=dev)
        for name in ("insert_or_assign", "find_or_insert", "find"):
            args = (keys,) if name == "find" else (keys, vals)
            a, b = getattr(tk, name)(*args), getattr(tp, name)(*args)
            for x, y in zip(a[1:], b[1:]):
                assert torch.equal(x, y), name
        for tier in ("hot", "cold"):
            for f in ("keys", "digests", "scores", "values"):
                assert torch.equal(getattr(getattr(tk, tier).state, f).cpu(),
                                   getattr(getattr(tp, tier).state, f).cpu()), (step, tier, f)
    assert tk.size() == tp.size() and tk.cold.size() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("v,width", [(32, None), (6, None), (33, 32), (33, None), (32, 5),
                                     (7, 3)])
def test_gather_rows_kernel_matches_plain(dev, v, width, dtype):
    """Copy units of 16, 4 and 2 bytes: V = 32 whole and cut to 5
    columns, V = 6, V = 33 whole and its 32 leading columns (the training
    readback), V = 7 cut to 3 (2-byte units at bfloat16); rows past both
    ends of the plane clipped, a lane count that is not a multiple of 32."""
    values = torch.randn(8192, v, device=dev).to(dtype)
    rows = torch.randint(-5, 8200, (3001,), device=dev)
    mask = torch.rand(3001, device=dev) < 0.5
    got = gather.gather_rows(values, rows, mask, width)
    want = gather.gather_rows_plain(values, rows.clamp(0, 8191), mask, width)
    assert got.dtype == dtype and got.shape == (3001, width or v)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert not got[~mask].any() and got[mask].any()


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


def _update_table(dev, opt, dim, capacity=64 * 128, dtype=torch.float32):
    """A plain-path table on the card past λ = 1.0 with V = dim + aux and
    non-negative rows (adagrad accumulators)."""
    g = np.random.default_rng(8)
    t = repro_torch.HKVTable.create(capacity=capacity, dim=dim, buckets_per_key=2,
                                    aux_value_dim=opt.aux_dim(dim), value_dtype=dtype,
                                    device=dev, backend="plain")
    for _ in range(6):
        keys = g.integers(0, 2**64 - 2, size=capacity // 2, dtype=np.uint64)
        t.insert_or_assign(keys, torch.rand(capacity // 2, t.cfg.total_value_dim, device=dev))
    return t


def _update_queries(t, n=4096):
    """Unique keys: half resident, half not; every 17th EMPTY; every 13th
    a resident key with its gate off."""
    gen = torch.Generator(device=t.device).manual_seed(12)
    live = t.state.keys[t.state.keys != -1]
    q = torch.cat([live[torch.randperm(live.numel(), generator=gen, device=t.device)[:n // 2]],
                   torch.randint(0, 2**62, (n // 2,), generator=gen, device=t.device)])
    q = torch.unique(q)[:n]
    q[::17] = -1
    p = find_mod.probe_keys(t.cfg, q)
    valid = p.valid.clone()
    valid[::13] = False
    return q, p, valid


WIDE = [(o, d) for o in ("sgd", "sgdm", "rowwise_adagrad", "adagrad") for d in (257, 512, 896)]


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("opt_name,dim", [("sgd", 32), ("sgdm", 32), ("rowwise_adagrad", 32),
                                          ("adagrad", 32), ("rowwise_adagrad", 100),
                                          ("sgdm", 8), ("rowwise_adagrad", 3)] + WIDE)
def test_update_scan_kernel_matches_plain(dev, opt_name, dim, dual):
    """Every optimizer, V = 32, 33 and 64 at dim 32, dims 100, 8 and 3
    (below a group's 8 columns), and dims 257, 512 and 896 (the streamed
    rows): found and the whole value plane bit-identical to the plain
    version."""
    _update_case(dev, opt_name, dim, dual, torch.float32)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("dim", [32, 257])
@pytest.mark.parametrize("opt_name", ["sgd", "sgdm", "rowwise_adagrad", "adagrad"])
def test_update_scan_kernel_matches_plain_bf16(dev, opt_name, dim, dual):
    """A bfloat16 plane: the kernel rounds where the plain version's
    bfloat16 ops round, so the plane is bit-identical."""
    _update_case(dev, opt_name, dim, dual, torch.bfloat16)


def _update_case(dev, opt_name, dim, dual, dtype):
    from repro_torch.embedding.sparse_opt import SparseOptimizer
    from repro_torch.kernels import update_scan

    opt = SparseOptimizer(opt_name, lr=0.05)
    t = _update_table(dev, opt, dim, dtype=dtype)
    q, p, valid = _update_queries(t)
    b2 = p.bucket2 if dual else p.bucket1
    grads = torch.randn(q.numel(), dim, device=dev).to(dtype)
    s = t.state
    vk, vp = s.values.clone(), s.values.clone()
    fk = update_scan.update_scan(s.digests, s.keys, vk, p.bucket1, b2, p.digest, q, valid,
                                 grads, opt, dim)
    fp = update_scan.update_scan_plain(s.digests, s.keys, vp, p.bucket1, b2, p.digest, q,
                                       valid, grads, opt, dim)
    _same((fk, vk), (fp, vp))
    assert 0 < int(fk.sum()) < q.numel() and not torch.equal(vk, s.values)


def test_update_scan_offsets_past_2_31(dev):
    """A value plane of 2^26 rows of 64 floats: rows in the upper half sit
    past 2^31 floats, so the kernel's offsets must be 64-bit.  The touched
    rows are held against the plain version; a checksum of the plane shows
    no other row moved."""
    from repro_torch.embedding.sparse_opt import SparseOptimizer
    from repro_torch.kernels import update_scan

    opt = SparseOptimizer("adagrad", lr=0.05)
    t = repro_torch.HKVTable.create(capacity=2**26, dim=32, aux_value_dim=32,
                                    buckets_per_key=2, device=dev, backend="plain")
    g = np.random.default_rng(2)
    keys = g.integers(0, 2**63, size=8192, dtype=np.uint64)
    t.insert_or_assign(keys, torch.rand(8192, 64, device=dev))
    q, p, valid = _update_queries(t, n=8192)
    s = t.state
    loc = t.find_ptr(q)
    rows = loc.row[loc.found & valid]
    assert int((rows * 64 >= 2**31).sum()) > 1000
    grads = torch.randn(q.numel(), 32, device=dev)
    saved = s.values[rows].clone()
    checksum = s.values.view(torch.int32).sum(dtype=torch.int64)
    fk = update_scan.update_scan(s.digests, s.keys, s.values, p.bucket1, p.bucket2, p.digest,
                                 q, valid, grads, opt, 32)
    got = s.values[rows].clone()
    s.values[rows] = saved
    assert int(s.values.view(torch.int32).sum(dtype=torch.int64)) == int(checksum)
    fp = update_scan.update_scan_plain(s.digests, s.keys, s.values, p.bucket1, p.bucket2,
                                       p.digest, q, valid, grads, opt, 32)
    _same((fk, got), (fp, s.values[rows]))


def test_bucket_stats_kernel_matches_plain(dev):
    """Occupancy, minimum live score and its slot, with an all-empty
    bucket (all-ones score, slot 0) and a bucket of tied minima."""
    from repro_torch.kernels import score_scan

    t = _table(dev)
    keys, scores = t.state.keys.clone(), t.state.scores.clone()
    keys[3] = -1
    keys[5:7] = torch.arange(256, device=dev).reshape(2, 128) + 10**6
    scores[5] = 7
    scores[6, 40:] = 0
    scores[6, :40] = 2**62
    keys[6, 60] = -1
    got = score_scan.bucket_stats(keys, scores)
    _same(got, score_scan.bucket_stats_plain(keys, scores))
    assert int(got[0][3]) == 0 and int(got[1][3]) == -1 and int(got[2][3]) == 0
    assert int(got[2][5]) == 0 and int(got[2][6]) == 40 and int(got[1][6]) == 0


@pytest.mark.parametrize("opt_name", ["sgd", "rowwise_adagrad"])
def test_apply_grads_kernel_path_matches_plain(dev, opt_name):
    """HKVEmbedding steps on 'auto' and 'plain' on the card: the same
    statuses, key planes and scores; values within 1e-5 (duplicated
    tokens' gradient sums are float32 atomics on the card); apply_grads
    is one update_scan launch, and update_rows at a shared locate and
    the composed stage agree with the fused one."""
    from repro_torch.core import ops
    from repro_torch.embedding import HKVEmbedding, SparseOptimizer
    from repro_torch.kernels import ops as kops

    opt = SparseOptimizer(opt_name, lr=0.05)
    ek = HKVEmbedding(capacity=16 * 128, dim=32, optimizer=opt, backend="auto")
    ep = HKVEmbedding(capacity=16 * 128, dim=32, optimizer=opt, backend="plain")
    tk, tp = ek.create(device=dev), ep.create(device=dev)
    g = np.random.default_rng(7)
    for _ in range(5):
        toks = torch.from_numpy(g.integers(-2, 5000, size=(256, 26))).to(dev)
        tk, rk = ek.lookup_train(tk, toks)
        tp, rp = ep.lookup_train(tp, toks)
        assert (rk - rp).abs().max().item() <= 1e-5
        grads = torch.randn(256, 26, 32, device=dev)
        _build.reset_counts()
        ek.apply_grads(tk, toks, grads)
        assert dict(_build.launch_counts) == {"update_scan": 1}
        ep.apply_grads(tp, toks, grads)
        for name in ("keys", "digests", "scores"):
            assert torch.equal(getattr(tk.state, name), getattr(tp.state, name)), name
        assert (tk.state.values - tp.state.values).abs().max().item() <= 1e-5
    uniq = torch.unique(tk.state.keys[tk.state.keys != -1])[:500]
    grads = torch.randn(500, 32, device=dev)
    states = [tk.snapshot().state for _ in range(3)]
    kops.update_rows_kernel(states[0], tk.cfg, uniq, grads, opt)
    kops.update_composed_kernel(states[1], tk.cfg, uniq, grads, opt)
    loc = kops.locate_kernel(states[2], tk.cfg, uniq)
    ops.update_rows(states[2], tk.cfg, uniq, grads, opt, loc=loc)
    for st in states[1:]:
        assert torch.equal(st.values, states[0].values)


def _tie_planes(dev):
    """Four bucket rows whose victim order rests on its tie-breaks: every
    slot free (with small scores); every slot live with one score; free
    slots with stale nonzero scores; duplicate keys and scores."""
    g = np.random.default_rng(21)
    keys = g.integers(0, 2**63, size=(4, 128)).astype(np.int64)
    scores = g.integers(0, 3, size=(4, 128)).astype(np.int64)
    keys[0] = -1
    scores[1] = 7
    keys[2, g.random(128) < 0.5] = -1
    scores[2] = g.integers(1, 4, size=128) << 40
    keys[3] = g.choice(np.array([5, -2**63 + 1, -1]), size=128)
    scores[3] = g.choice(np.array([0, -1]), size=128)
    return torch.from_numpy(keys).to(dev), torch.from_numpy(scores).to(dev)


def test_claim_scan_kernel_on_tie_heavy_rows(dev):
    """Every rank from -3 to 140 (clipped into [0, 128)) on each row."""
    keys, scores = _tie_planes(dev)
    b = torch.arange(4, device=dev).repeat_interleave(144)
    r = torch.arange(-3, 141, device=dev).repeat(4)
    got = upsert_scan.claim_scan(keys, scores, b, r)
    _same(got, upsert_scan.claim_scan_plain(keys, scores, b, r))
    for i in range(4):   # ranks 0..127 select every slot once
        assert sorted(got[0][i * 144 + 3:i * 144 + 131].tolist()) == list(range(128))


@pytest.mark.parametrize("n", [1, 7, 4099])
def test_claim_scan_kernel_matches_plain_at_any_length(dev, n):
    """A half-full table's rows and the tie-heavy ones, random buckets (half
    of them sorted into runs) and ranks, query counts that do not fill a
    warp's group of 32."""
    t = repro_torch.HKVTable.create(capacity=64 * 128, dim=8, buckets_per_key=2,
                                    score_policy="lfu", device=dev, backend="plain")
    g = np.random.default_rng(n)
    for _ in range(2):
        keys = g.integers(0, 2**63, size=2048).astype(np.int64)
        t.insert_or_assign(np.concatenate([keys, keys[:512]]), torch.randn(2560, 8, device=dev))
    tk, ts = _tie_planes(dev)
    keys = torch.cat([t.state.keys, tk]).contiguous()
    scores = torch.cat([t.state.scores, ts]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(n)
    b = torch.randint(0, keys.shape[0], (n,), generator=gen, device=dev)
    b[::3] = keys.shape[0] - 1 - torch.arange(0, n, 3, device=dev) % 4   # the tie rows
    b[: n // 2] = b[: n // 2].sort().values   # runs of one bucket: the row is read once a run
    r = torch.randint(-3, 141, (n,), generator=gen, device=dev)
    r[::2] = torch.randint(0, 4, (r[::2].numel(),), generator=gen, device=dev)
    _same(upsert_scan.claim_scan(keys, scores, b, r),
          upsert_scan.claim_scan_plain(keys, scores, b, r))


@pytest.mark.parametrize("add", [False, True], ids=["set", "add"])
@pytest.mark.parametrize("v", [1, 3, 8, 32, 33, 64, 132])
def test_scatter_rows_kernel_matches_plain(dev, v, add):
    """Row widths for both element sizes (float4 where V % 4 == 0), a lane
    count that is not a multiple of the warp's group of 32, masked-out
    lanes aimed at written rows and rows outside the plane."""
    n, r_tot = 3001, 8192
    gen = torch.Generator(device=dev).manual_seed(v)
    values = torch.randn(r_tot, v, generator=gen, device=dev)
    rows = torch.randperm(r_tot, generator=gen, device=dev)[:n]
    mask = torch.rand(n, generator=gen, device=dev) < 0.6
    off = torch.where(torch.arange(n, device=dev) % 3 == 0, -1, r_tot + 3)
    rows[~mask] = torch.where(torch.arange(n, device=dev)[~mask] % 2 == 0, rows[mask][0],
                              off[~mask])
    rows[mask.nonzero()[-5:, 0]] = r_tot + 7   # masked in but outside the plane
    upd = torch.randn(n, v, generator=gen, device=dev)
    vk, vp = values.clone(), values.clone()
    scatter.scatter_rows(vk, rows, upd, mask, add)
    scatter.scatter_rows_plain(vp, rows, upd, mask, add)
    assert torch.equal(vk, vp) and not torch.equal(vk, values)


@pytest.mark.parametrize("add", [False, True], ids=["set", "add"])
@pytest.mark.parametrize("v", [1, 3, 8, 32, 33])
def test_scatter_rows_kernel_matches_plain_bf16(dev, v, add):
    """bfloat16 rows in 16-, 4- and 2-byte units: the copy bit for bit, the
    add rounded once from float32, as index_add_ rounds on unique rows."""
    n, r_tot = 3001, 8192
    gen = torch.Generator(device=dev).manual_seed(100 + v)
    values = torch.randn(r_tot, v, generator=gen, device=dev).to(torch.bfloat16)
    rows = torch.randperm(r_tot, generator=gen, device=dev)[:n]
    mask = torch.rand(n, generator=gen, device=dev) < 0.6
    rows[~mask] = rows[mask][0]   # masked-out lanes aimed at a written row
    upd = torch.randn(n, v, generator=gen, device=dev).to(torch.bfloat16)
    vk, vp = values.clone(), values.clone()
    scatter.scatter_rows(vk, rows, upd, mask, add)
    scatter.scatter_rows_plain(vp, rows, upd, mask, add)
    assert torch.equal(vk.view(torch.int16), vp.view(torch.int16))
    assert not torch.equal(vk, values)


@pytest.mark.parametrize("v", [32, 33, 7])
def test_find_scan_kernel_matches_plain_bf16(dev, v):
    """A bfloat16 value plane (16-, 4- and 2-byte units): found, slots,
    scores and the value rows bit-identical."""
    t = _table(dev)
    q, p = _queries(t)
    s = t.state
    values = torch.randn(s.values.shape[0], v, device=dev).to(torch.bfloat16)
    args = (s.digests, s.keys, s.scores, values, p.bucket1, p.bucket2, p.digest, q)
    got, want = find_scan.find_scan(*args), find_scan.find_scan_plain(*args)
    _same(got[:4], want[:4])
    assert got[4].dtype == torch.bfloat16 and torch.equal(got[4].view(torch.int16),
                                                          want[4].view(torch.int16))
    assert got[0].any()


def test_bf16_table_runs_on_the_card(dev):
    """A bfloat16 HKVTable on 'auto': insert_or_assign, find, find_or_insert,
    update_rows (through a session: one update_scan launch) and
    apply_grads run on the kernels and equal 'plain' bit for bit."""
    from repro_torch.core import ops
    from repro_torch.embedding import HKVEmbedding, SparseOptimizer

    opt = SparseOptimizer("rowwise_adagrad", lr=0.05)
    kw = dict(capacity=16 * 128, dim=32, optimizer=opt, value_dtype=torch.bfloat16)
    ek, ep = HKVEmbedding(backend="auto", **kw), HKVEmbedding(backend="plain", **kw)
    tk, tp = ek.create(device=dev), ep.create(device=dev)
    g = np.random.default_rng(17)

    def same_state():
        for name in ("keys", "digests", "scores", "values"):
            a, b = getattr(tk.state, name), getattr(tp.state, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name

    for _ in range(4):
        keys = g.integers(0, 4 * 16 * 128, size=1500).astype(np.int64)
        vals = torch.randn(1500, 32, device=dev).to(torch.bfloat16)
        assert torch.equal(tk.insert_or_assign(keys, vals).status,
                           tp.insert_or_assign(keys, vals).status)
        same_state()
        _build.reset_counts()
        fk, fp = tk.find(keys), tp.find(keys)
        assert _build.launch_counts["find_scan"] == 1
        assert fk.values.dtype == torch.bfloat16 and torch.equal(fk.values, fp.values)
        toks = torch.from_numpy(g.integers(0, 4 * 16 * 128, size=(64, 26))).to(dev)
        tk, rk = ek.lookup_train(tk, toks)
        tp, rp = ep.lookup_train(tp, toks)
        assert torch.equal(rk, rp)
        same_state()
        uniq = torch.unique(tk.state.keys[tk.state.keys != -1])[:300]
        grads = torch.randn(300, 32, device=dev).to(torch.bfloat16)
        _build.reset_counts()
        ops.update_rows(tk.state, tk.cfg, uniq, grads, opt)
        assert dict(_build.launch_counts) == {"update_scan": 1}
        ops.update_rows(tp.state, tp.cfg, uniq, grads, opt, backend="plain")
        same_state()


@pytest.mark.parametrize("which", ["updates", "values"])
@pytest.mark.parametrize("add", [False, True], ids=["set", "add"])
def test_scatter_rows_kernel_unaligned_views(dev, which, add):
    """A contiguous view 4 bytes past a 16-byte boundary takes the 4-byte
    path at V = 32 and writes the same rows."""
    n, r_tot, v = 1000, 4096, 32
    gen = torch.Generator(device=dev).manual_seed(1 + add)

    def unaligned(rows_):
        buf = torch.randn(rows_ * v + 1, generator=gen, device=dev)
        t = buf[1:].view(rows_, v)
        assert t.data_ptr() % 16 != 0 and t.is_contiguous()
        return t

    upd = unaligned(n) if which == "updates" else torch.randn(n, v, generator=gen, device=dev)
    values = unaligned(r_tot) if which == "values" else torch.randn(r_tot, v, generator=gen,
                                                                    device=dev)
    rows = torch.randperm(r_tot, generator=gen, device=dev)[:n]
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    want = values.clone()
    scatter.scatter_rows_plain(want, rows, upd, mask, add)
    scatter.scatter_rows(values, rows, upd, mask, add)
    assert torch.equal(values, want)


@pytest.mark.parametrize("misses", [5, 0], ids=["few_misses", "no_miss"])
def test_upserts_with_few_or_no_misses_match_plain(dev, misses):
    """insert_or_assign, find_or_insert and lookup_train on 'auto' and
    'plain' with mostly resident keys: equal results and state, and one
    claim_scan launch where the batch has a miss lane, none where it has
    none."""
    from repro_torch.embedding import HKVEmbedding

    g = np.random.default_rng(31 + misses)
    ek = HKVEmbedding(capacity=16 * 128, dim=32, backend="auto")
    ep = HKVEmbedding(capacity=16 * 128, dim=32, backend="plain")
    tk, tp = ek.create(device=dev), ep.create(device=dev)
    fill = g.integers(0, 2**31, size=(16 * 128 * 3 // 4,)).astype(np.int64)
    tk.insert_or_assign(fill, torch.zeros(fill.size, 32, device=dev))
    tp.insert_or_assign(fill, torch.zeros(fill.size, 32, device=dev))

    def batch():
        live = tk.state.keys[tk.state.keys != -1].cpu().numpy()
        keys = g.choice(live, size=1500)
        keys[1:1 + misses] = 2**31 + g.permutation(1000)[:misses]   # never inserted
        keys[::97] = -1
        return keys

    def state_equal():
        for name in ("keys", "digests", "scores", "values"):
            assert torch.equal(getattr(tk.state, name), getattr(tp.state, name)), name

    for op in ("insert_or_assign", "find_or_insert"):
        keys, vals = batch(), torch.randn(1500, 32, device=dev)
        _build.reset_counts()
        rk = getattr(tk, op)(keys, vals)
        assert _build.launch_counts["claim_scan"] == (1 if misses else 0), op
        rp = getattr(tp, op)(keys, vals)
        assert torch.equal(rk.status, rp.status), op
        assert int((rk.status >= 2).sum()) == misses, op
        if op == "find_or_insert":
            assert torch.equal(rk.values, rp.values)
        state_equal()
    toks = torch.from_numpy(batch().reshape(60, 25)).to(dev)
    _build.reset_counts()
    tk, rows_k = ek.lookup_train(tk, toks)
    assert _build.launch_counts["claim_scan"] == (1 if misses else 0)
    tp, rows_p = ep.lookup_train(tp, toks)
    assert torch.equal(rows_k, rows_p)
    state_equal()


LENGTHS = [1, 3, 4, 5, 7, 4099]   # the ragged edges of four queries a warp


def _probe_queries(t, n, seed):
    """n queries on table `t`: live keys and random ones alternating, EMPTY
    on every 7th lane from lane 2; every 5th lane from lane 4 has its two
    candidates in one bucket.  Returns (q, bucket1, bucket2, digest)."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    live = t.state.keys[t.state.keys != -1]
    q = torch.randint(0, 2**62, (n,), generator=g, device=t.device)
    q[::2] = live[torch.randint(0, live.numel(), (q[::2].numel(),), generator=g,
                                device=t.device)]
    q[2::7] = -1
    p = find_mod.probe_keys(t.cfg, q)
    b2 = p.bucket2.clone()
    b2[4::5] = p.bucket1[4::5]
    return q, p.bucket1, b2, p.digest


@pytest.mark.parametrize("use_digest", [True, False], ids=["digest", "nodigest"])
@pytest.mark.parametrize("full", [True, False], ids=["full_rows", "half_full"])
@pytest.mark.parametrize("n", LENGTHS)
def test_upsert_probe_modes_match_plain(dev, n, full, use_digest):
    """Every mode of the kernel equals the plain version on rows full (past
    λ 1.0) and not (λ about 0.5), with EMPTY lanes, lanes whose candidates
    are one bucket, and live keys also written into their other candidate
    row (hit1 must win); the target mode with no gate and with a gate all
    off, all on and mixed."""
    t = _table(dev, batches=6 if full else 1)
    q, b1, b2, qd = _probe_queries(t, n, seed=n + 2 * full)
    keys, digests = t.state.keys.clone(), t.state.digests.clone()
    loc = find_mod.locate(t.state, t.cfg, q)
    both = torch.nonzero(loc.found & (b1 != b2)).flatten()[:16]
    other = torch.where(loc.bucket[both] == b1[both], b2[both], b1[both])
    keys[other, 127], digests[other, 127] = q[both], qd[both]
    planes = (digests, keys, t.state.scores)
    for mode in ("both", "match"):
        args = (*planes, b1, b2, qd, q)
        got = upsert_scan.upsert_probe(*args, use_digest=use_digest, mode=mode)
        want = upsert_scan.upsert_probe_plain(*args, use_digest=use_digest, mode=mode)
        _same(got[:3], want[:3])
        if mode == "both":
            _same(got[3:], want[3:])
            if n > 100:   # some keys hit; past λ 1.0 some in bucket2, and below it
                # (one batch into empty rows, all in bucket1) some targets are
                # bucket2 (full lfu rows tie on their minimum count: bucket1)
                assert got[0].any()
                assert got[1][got[0] == 1].any() if full else got[3].any()
    g = torch.Generator(device=dev).manual_seed(n)
    gates = {"none": None, "off": torch.zeros(n, dtype=torch.bool, device=dev),
             "on": torch.ones(n, dtype=torch.bool, device=dev),
             "mixed": torch.rand(n, generator=g, device=dev) < 0.3}
    for name, lanes in gates.items():
        got = upsert_scan.upsert_probe(*planes, b1, b2, mode="target", lanes=lanes)
        want = upsert_scan.upsert_probe_plain(*planes, b1, b2, mode="target", lanes=lanes)
        assert got[:3] == (None, None, None)
        _same(got[3:], want[3:])
        if name == "off":
            assert not got[3].any()


@pytest.mark.parametrize("layout", ["v32", "v33", "v32_unaligned"])
@pytest.mark.parametrize("n", LENGTHS)
def test_find_scan_kernel_rows_at_any_length(dev, n, layout):
    """find_scan at V = 32 (16-byte words), V = 33 (the training plane's
    width) and V = 32 on a view 4 bytes past a 16-byte boundary (both
    4-byte words), with and without the digest filter, EMPTY lanes and
    lanes whose candidates are one bucket."""
    v = 33 if layout == "v33" else 32
    t = _table(dev)
    q, b1, b2, qd = _probe_queries(t, n, seed=3 * n)
    r_tot = t.state.values.shape[0]
    gen = torch.Generator(device=dev).manual_seed(n)
    if layout == "v32_unaligned":
        values = torch.randn(r_tot * v + 1, generator=gen, device=dev)[1:].view(r_tot, v)
        assert values.data_ptr() % 16 != 0 and values.is_contiguous()
    else:
        values = torch.randn(r_tot, v, generator=gen, device=dev)
    s = t.state
    for use_digest in (True, False):
        args = (s.digests, s.keys, s.scores, values, b1, b2, qd, q)
        got = find_scan.find_scan(*args, use_digest=use_digest)
        _same(got, find_scan.find_scan_plain(*args, use_digest=use_digest))
        assert not got[0][q == -1].any() and not got[4][got[0] == 0].any()
        if n > 100:
            assert got[0].any() and got[1].any()


def _serve(dev, backend, policy, admission, waves=8, wave=2**14):
    """The serving path on a 2^20-slot hierarchy (hot tier 2^17 in HBM, the
    cold tier's values in pinned host memory), prefilled past its hot tier:
    an engine behind a TablePublisher, an OnlineTrainer publishing every
    two steps and a MaintenanceScheduler every wave."""
    from repro_torch.data import zipf_keys
    from repro_torch.maintenance import MaintenancePolicy, MaintenanceScheduler
    from repro_torch.serving import (EmbeddingRequest, OnlineEmbeddingEngine, OnlineTrainer,
                                     TablePublisher)

    t = repro_torch.TieredHKVTable.create(hot_capacity=2**17, cold_capacity=2**20, dim=32,
                                          buckets_per_key=2, backend=backend, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    for i in range(4):
        keys = torch.arange(i * 2**16, (i + 1) * 2**16, device=dev) * 0x2545F4914F6CDD1D % 2**62
        t.insert_or_assign(keys, torch.randn(2**16, 32, generator=g, device=dev))
    pub = TablePublisher(t)
    trainer = OnlineTrainer(publisher=pub, publish_every=2, lr=0.1)
    sched = MaintenanceScheduler(MaintenancePolicy(every_waves=1, sweep_budget=wave,
                                                   low_watermark=0.6, high_watermark=0.85))
    eng = OnlineEmbeddingEngine(pub, wave_size=wave, miss_policy=policy, promote=True,
                                admission=admission, scheduler=sched)
    rng, train_rng = np.random.default_rng(8), np.random.default_rng(9)
    for i in range(waves):
        eng.submit(EmbeddingRequest(rid=i, keys=zipf_keys(rng, wave - 100, 1.05, 2**21)))
        eng.step()
        if i % 2:
            trainer.train_step(zipf_keys(train_rng, wave, 1.05, 2**21),
                               torch.ones(wave, 32, device=dev))
    eng.run_until_drained()
    return eng, sched, pub, trainer


@pytest.mark.parametrize("policy,admission", [("admit", "wave"), ("readonly", "continuous")])
def test_serving_path_kernels_match_plain(dev, policy, admission):
    """Engine, trainer and scheduler through the kernels ('auto') and the
    plain versions: equal per-request values and found flags, wave and
    scheduler reports, publisher counters and drained states."""
    (ea, sa, pa, ta), (ep, sp, pp, tp) = (_serve(dev, b, policy, admission)
                                          for b in ("auto", "plain"))
    ra, rp = {r.rid: r for r in ea.completed}, {r.rid: r for r in ep.completed}
    assert ra.keys() == rp.keys() and len(ra) == 8
    for rid in ra:
        assert np.array_equal(ra[rid].found, rp[rid].found)
        assert np.array_equal(ra[rid].values, rp[rid].values)
    strip = lambda reps, f: [r._replace(**{f: 0.0}) for r in reps]  # noqa: E731
    assert strip(ea.reports, "latency_s") == strip(ep.reports, "latency_s")
    assert strip(sa.reports, "elapsed_s") == strip(sp.reports, "elapsed_s")
    assert sa.totals.demoted > 0 and sa.totals._replace(time_s=0) == sp.totals._replace(time_s=0)
    assert (pa.published, pa.offered, pa.rejected_offers) == (pp.published, pp.offered,
                                                              pp.rejected_offers)
    for a, b in ((pa.table, pp.table), (ta.table, tp.table)):
        for tier in ("hot", "cold"):
            for name in ("keys", "digests", "scores", "values"):
                x, y = getattr(getattr(a, tier).state, name), getattr(getattr(b, tier).state, name)
                assert torch.equal(x, y.to(x.device)), (tier, name)


# =============================================================================
# the multi-table find, assign_kernel, telemetry and the baselines on the card
# =============================================================================


@pytest.mark.parametrize("dim", [32, 33])
def test_find_scan_many_kernel_matches_plain(dev, dim):
    from repro_torch.kernels import ops as kops

    tables, keys = [], []
    for i, c in enumerate((3000, 0, 4096, 517)):       # an empty segment too
        t = repro_torch.HKVTable.create(capacity=16 * 128, dim=dim, buckets_per_key=2,
                                        device=dev, backend="plain")
        g = np.random.default_rng(40 + i)
        t.insert_or_assign(g.integers(0, 2**63, size=2048, dtype=np.uint64),
                           torch.randn(2048, dim, device=dev))
        tables.append(t)
        live = t.state.keys[t.state.keys != -1]
        q = torch.cat([live[:c // 2], torch.randint(0, 2**62, (c - c // 2,), device=dev)])
        q[::13] = -1
        keys.append(q)
    probes = [find_mod.probe_keys(tables[0].cfg, k) for k in keys]
    planes = [(t.state.digests, t.state.keys, t.state.scores, t.state.values) for t in tables]
    args = (planes, torch.cat([p.bucket1 for p in probes]), torch.cat([p.bucket2 for p in probes]),
            torch.cat([p.digest for p in probes]), torch.cat(keys), [k.numel() for k in keys])
    _build.reset_counts()
    got = find_scan.find_scan_many(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["find_scan_many"] == 1
    _same(got, find_scan.find_scan_many_plain(*args))
    many = kops.find_many_kernel([t.state for t in tables], tables[0].cfg, keys)
    for t, k, m in zip(tables, keys, many):
        _same(m, kops.find_fused_kernel(t.state, t.cfg, k))


@pytest.mark.parametrize("add", [False, True])
def test_assign_kernel_matches_plain(dev, add):
    from repro_torch.kernels import ops as kops

    t = _table(dev)
    keys = t.state.keys[t.state.keys != -1][:3000]
    keys = torch.cat([keys, torch.randint(0, 2**62, (1000,), device=dev)])
    vals = torch.randn(keys.numel(), 32, device=dev)
    twin = t.snapshot()
    _build.reset_counts()
    kops.assign_kernel(t.state, t.cfg, keys, vals, add=add)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"digest_scan": 1, "scatter_rows": 1}
    kops.assign_plain(twin.state, twin.cfg, keys, vals, add=add)
    assert torch.equal(t.state.values, twin.state.values)


def test_telemetry_on_the_card_adds_no_launch_and_counts_as_the_cpu(dev):
    from repro_torch.obs import TelemetrySink

    t = _table(dev)
    q, _p = _queries(t)
    cpu = repro_torch.HKVTable.wrap(
        repro_torch.HKVState(*(x.cpu() for x in t.state.planes), t.state.clock,
                             t.state.epoch), t.cfg)
    for op in ("find", "find_ptr", "contains"):
        counts = []
        for sink in (None, TelemetrySink()):
            _build.reset_counts()
            getattr(t, op)(q, **({} if sink is None else {"telemetry": sink}))
            torch.cuda.synchronize()
            counts.append(dict(_build.launch_counts))
        assert counts[0] == counts[1], op
        cpu_sink = TelemetrySink()
        getattr(cpu, op)(q.cpu(), telemetry=cpu_sink)
        assert sink.snapshot() == cpu_sink.snapshot(), op
    keys = torch.randint(0, 2**62, (4096,), device=dev)
    vals = torch.randn(4096, 32, device=dev)
    twin, sink, cpu_sink = t.snapshot(), TelemetrySink(), TelemetrySink()
    _build.reset_counts()
    r = t.insert_or_assign(keys, vals, telemetry=sink)
    with_sink = dict(_build.launch_counts)
    _build.reset_counts()
    rt = twin.insert_or_assign(keys, vals)
    assert dict(_build.launch_counts) == with_sink
    assert torch.equal(r.status, rt.status)
    cpu.insert_or_assign(keys.cpu(), vals.cpu(), telemetry=cpu_sink)
    assert sink.snapshot() == cpu_sink.snapshot()


@pytest.mark.parametrize("kind", ["open_addressing", "bucketed_p2c"])
def test_baselines_on_the_card_equal_the_cpu(dev, kind):
    from repro_torch.baselines import DictKVTable

    g = np.random.default_rng(12)
    a = getattr(DictKVTable, kind)(4096, 8, device=dev)
    b = getattr(DictKVTable, kind)(4096, 8, device="cpu")
    for _ in range(5):
        k = g.integers(0, 6000, size=1024).astype(np.uint64)
        v = torch.randn(1024, 8)
        ra, rb = a.insert_or_assign(k, v.to(dev)), b.insert_or_assign(k, v)
        assert torch.equal(ra.ok.cpu(), rb.ok) and torch.equal(ra.probes.cpu(), rb.probes)
        fa, fb = a.find(k[::3]), b.find(k[::3])
        assert torch.equal(fa.values.cpu(), fb.values) and torch.equal(fa.probes.cpu(), fb.probes)
        a.erase(k[::7].copy())
        b.erase(k[::7].copy())
        for x, y in zip(a.state, b.state):
            assert torch.equal(x.cpu(), y)


def test_seeded_replay_on_auto_against_the_oracle(dev):
    from test_torch_fuzz import DifferentialHarness, seeded_replay

    seeded_replay(DifferentialHarness(device=dev, backend="auto"), seed=4)


@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_sharded_table_on_the_card_matches_plain(dev, tiered):
    """A ("data", "model") (2, 4) mesh of eight shards sharing the card,
    through 'auto' and 'plain': every op's statuses, found flags, overflow,
    streams, export lanes and every shard's keys, digests and scores equal,
    and the values too, but for the gradient sums (float32 atomics on the
    card, at the source and again at the owner), within 1e-5 for gradients
    at a batch-mean loss's scale.  Each owner op runs on every shard:
    apply_grads is one update_scan a shard."""
    from repro_torch.embedding import HKVEmbedding, SparseOptimizer

    kw = dict(capacity=8 * 8 * 128, dim=32, optimizer=SparseOptimizer("rowwise_adagrad",
                                                                       lr=0.05))
    if tiered:
        kw["hot_capacity"] = 8 * 2 * 128
    mesh = repro_torch.make_dev_mesh(2, 4)
    tk = repro_torch.ShardedHKVTable.create(mesh, HKVEmbedding(backend="auto", **kw))
    tp = repro_torch.ShardedHKVTable.create(mesh, HKVEmbedding(backend="plain", **kw))
    g = np.random.default_rng(13)
    worst = [0.0]

    def same(a, b, ctx, atol=0.0):
        if a.dtype.is_floating_point and atol:
            err = (a - b).abs().max().item() if a.numel() else 0.0
            worst[0] = max(worst[0], err)
            assert err <= atol, (ctx, err)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), ctx

    def same_states(ctx, atol=0.0):
        for i, (a, b) in enumerate(zip(tk.shards, tp.shards)):
            tiers = (("hot", a.hot, b.hot), ("cold", a.cold, b.cold)) if tiered else (("", a, b),)
            for name, x, y in tiers:
                for f in ("keys", "digests", "scores", "values"):
                    same(getattr(x.state, f).to(dev), getattr(y.state, f).to(dev),
                         f"{ctx}: shard {i} {name} {f}", atol if f == "values" else 0.0)
                assert (x.state.clock, x.state.epoch) == (y.state.clock, y.state.epoch), ctx

    def keys(n):
        k = g.integers(0, 2**64 - 2, size=n, dtype=np.uint64)
        k[::13] = np.uint64(2**64 - 1)
        return k

    for step in range(3):
        k, v = keys(4096), torch.randn(4096, 32, device=dev)
        a, b = tk.insert_or_assign(k, v), tp.insert_or_assign(k, v)
        same(a.status, b.status, f"insert {step}")
        assert int(a.overflow) == int(b.overflow) == 0
        mix = np.concatenate([k[:2048], keys(2048)])
        a, b = tk.find(mix), tp.find(mix)
        same(a.values, b.values, "find values")
        same(a.found, b.found, "find found")
        a, b = tk.find_or_insert(mix[::-1].copy()), tp.find_or_insert(mix[::-1].copy())
        same(a.values, b.values, "find_or_insert values")
        same(a.found, b.found, "find_or_insert found")
        same(tk.contains(mix), tp.contains(mix), "contains")
        same_states(f"step {step}")
    w = torch.randn(4096, 32, device=dev)
    tk.assign(mix, w)
    tp.assign(mix, w)
    tk.erase(mix[::3].copy())
    tp.erase(mix[::3].copy())
    pred = repro_torch.SweepPredicate.key_in_range(2**62, 2**63)
    assert int(tk.erase_if(pred).swept) == int(tp.erase_if(pred).swept) > 0
    a, b = tk.evict_if(repro_torch.SweepPredicate.always(), 64), \
        tp.evict_if(repro_torch.SweepPredicate.always(), 64)
    for x, y in zip(a.evicted, b.evicted):
        same(x, y, "evict_if stream")
    for bucket in range(tk.num_buckets):
        for x, y in zip(tk.export_batch(bucket, 1), tp.export_batch(bucket, 1)):
            same(x, y, f"export {bucket}")
    assert tk.size() == tp.size() > 0
    sa, sb = tk.stats(), tp.stats()
    same(sa.occupancy_hist, sb.occupancy_hist, "stats")
    same(sa.score_q, sb.score_q, "stats")
    same_states("the sweeps")
    for step in range(3):
        toks = torch.from_numpy(g.integers(-2, 5000, size=(256, 26))).to(dev)
        _, ra, oa = tk.lookup(toks, train=True)
        _, rb, ob = tp.lookup(toks, train=True)
        same(ra, rb, f"lookup {step}", 1e-5)
        assert int(oa) == int(ob)
        grads = torch.randn(256, 26, 32, device=dev) / 256
        _build.reset_counts()
        tk.apply_grads(toks, grads)
        assert dict(_build.launch_counts) == {"update_scan": tk.n_shards}
        tp.apply_grads(toks, grads)
        same_states(f"train step {step}", 1e-5)
    same(tk.lookup(toks, train=False)[1], tp.lookup(toks, train=False)[1], "serve", 1e-5)
