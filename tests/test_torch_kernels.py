"""The plain versions of the port's kernels against the JAX package.

Each kernel's plain PyTorch version (what the wrapper runs on CPU tensors,
and what `chip_smoke.py` holds the CUDA kernel against on the card) must
equal, bit for bit, both the JAX package's Pallas kernel in interpret mode
and its jnp reference, on the same inputs: tables filled by the JAX
package to λ 0.5 and 1.0 and carried across by `repro_torch.convert`,
queries mixing resident keys, misses, wide keys and EMPTY padding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import find as jfind  # noqa: E402
from repro.core import merge as jmerge  # noqa: E402
from repro.core.predicates import SweepPredicate as JaxPredicate  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import digest_scan as jds  # noqa: E402
from repro.kernels import gather as jga  # noqa: E402
from repro.kernels import sweep_scan as jsw  # noqa: E402
from repro.kernels import upsert_scan as jus  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import find as pfind  # noqa: E402
from repro_torch.core import table as ptable  # noqa: E402
from repro_torch.kernels import digest_scan as pds  # noqa: E402
from repro_torch.kernels import find_scan as pfs  # noqa: E402
from repro_torch.kernels import gather as pga  # noqa: E402
from repro_torch.kernels import ops as pkops  # noqa: E402
from repro_torch.kernels import scatter as psc  # noqa: E402
from repro_torch.kernels import sweep_scan as psw  # noqa: E402
from repro_torch.kernels import upsert_scan as pus  # noqa: E402

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
N = 64
LAMBDAS = (0.5, 1.0)


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _np(t):
    return t.numpy().view(np.uint64) if t.dtype == torch.int64 else t.numpy()


def _filled(lam, dual, use_digest=True, seed=0):
    """A JAX table filled to λ (1.0: driven 3x past capacity) under lfu,
    whose small counts make score ties common; plus its resident keys."""
    rng = np.random.default_rng(seed + int(100 * lam) + 7 * dual)
    cfg = jtable.HKVConfig(capacity=4 * 128, dim=8, buckets_per_key=2 if dual else 1,
                           score_policy="lfu", use_digest=use_digest)
    state = jtable.create(cfg)
    n_fill = int(lam * cfg.capacity) if lam < 1 else 3 * cfg.capacity
    keys = rng.integers(1, 2**60, size=n_fill).astype(np.uint64)
    keys[::5] |= np.uint64(1 << 63)
    for chunk in np.array_split(keys, 4):
        dup = np.concatenate([chunk, chunk[: len(chunk) // 3]])  # counts 1 and 2
        vals = jnp.asarray(rng.normal(size=(len(dup), cfg.dim)), jnp.float32)
        state = jmerge.upsert(state, cfg, ju64.from_uint64(dup), vals).state
    resident = ju64.to_uint64(state.keys).reshape(-1)
    resident = resident[resident != EMPTY]
    if lam == 1.0:
        assert len(resident) == cfg.capacity
    return rng, cfg, state, resident


def _queries(rng, resident):
    q = np.concatenate([
        rng.choice(resident, size=N // 2),
        rng.integers(0, 2**64 - 2, size=N // 2 - 6, dtype=np.uint64),
        np.full(6, EMPTY, np.uint64)])
    rng.shuffle(q)
    return q


def _probe_inputs(cfg, qkeys):
    """The same probe for both packages: JAX arrays and torch tensors."""
    k = ju64.from_uint64(qkeys)
    probe = jfind.probe_keys(cfg, k)
    b2 = probe.bucket2 if cfg.buckets_per_key == 2 else probe.bucket1
    jax_in = (probe.bucket1, b2, probe.digest.astype(jnp.uint32), k.hi, k.lo)
    torch_in = (torch.from_numpy(np.asarray(probe.bucket1).astype(np.int64)),
                torch.from_numpy(np.asarray(b2).astype(np.int64)),
                torch.from_numpy(np.array(probe.digest)),
                torch.from_numpy(qkeys.view(np.int64).copy()))
    return k, probe, jax_in, torch_in


def _port_cfg(cfg):
    return ptable.HKVConfig(capacity=cfg.capacity, dim=cfg.dim,
                            buckets_per_key=cfg.buckets_per_key,
                            score_policy=cfg.score_policy, use_digest=cfg.use_digest)


@pytest.mark.parametrize("use_digest", [True, False], ids=["digest", "nodigest"])
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("lam", LAMBDAS)
def test_find_scan_plain_matches_jax(lam, dual, use_digest):
    rng, cfg, state, resident = _filled(lam, dual, use_digest)
    qkeys = _queries(rng, resident)
    k, probe, jin, tin = _probe_inputs(cfg, qkeys)
    ps = convert.state_from_arrays(state, device="cpu")
    got = pfs.find_scan(ps.digests, ps.keys, ps.scores, ps.values, *tin, use_digest=use_digest)
    want = jref.find_scan_ref(state.digests, state.key_hi, state.key_lo, state.score_hi,
                              state.score_lo, state.values, *jin, use_digest=use_digest)
    # the port reports an EMPTY query key as a miss; the reference kernel
    # lets it match empty slots, so the raw outputs agree on the other lanes
    found, sel, slot, score, vals = got
    valid, pad = qkeys != EMPTY, qkeys == EMPTY
    for name, g, w in (("found", found, want[0]), ("sel", sel, want[1]), ("slot", slot, want[2]),
                       ("values", vals, want[5])):
        np.testing.assert_array_equal(_np(g)[valid], np.asarray(w)[valid], err_msg=name)
        assert not _np(g)[pad].any(), f"{name}: an EMPTY query is not a miss"
    np.testing.assert_array_equal(_np(score)[valid], _u64(want[3], want[4])[valid], err_msg="score")
    assert not _np(score)[pad].any()
    assert found.sum() > 0 and (found == 0).sum() > 0

    # the wrapper level: the port's find_fused_kernel vs the Pallas find
    # kernel in interpret mode, whose wrapper masks EMPTY lanes by validity
    jr = jkops.find_fused_kernel(state, cfg, k, interpret=True)
    pr = pkops.find_fused_kernel(ps, _port_cfg(cfg), tin[3])
    np.testing.assert_array_equal(pr.found.numpy(), np.asarray(jr.found))
    np.testing.assert_array_equal(pr.values.numpy(), np.asarray(jr.values))
    np.testing.assert_array_equal(_np(pr.scores), _u64(jr.score_hi, jr.score_lo))
    # where a miss is reported (bucket, slot) is free; hits and misses of
    # real keys agree, and an EMPTY key reports bucket1, slot 0
    np.testing.assert_array_equal(pr.bucket.numpy()[valid], np.asarray(jr.bucket)[valid])
    np.testing.assert_array_equal(pr.slot.numpy()[valid], np.asarray(jr.slot)[valid])
    np.testing.assert_array_equal(pr.bucket.numpy()[pad], tin[0].numpy()[pad])
    assert not pr.slot.numpy()[pad].any()


PROBE_OUTPUTS = {"both": (0, 1, 2, 3), "match": (0, 1, 2), "target": (3,)}


@pytest.mark.parametrize("mode", tuple(PROBE_OUTPUTS))
@pytest.mark.parametrize("use_digest", [True, False], ids=["digest", "nodigest"])
@pytest.mark.parametrize("lam", LAMBDAS)
def test_upsert_probe_plain_matches_jax(lam, use_digest, mode):
    """Each mode's outputs equal the same outputs of the JAX kernel (its
    whole function) on queries with EMPTY padding and some lanes whose two
    candidates are one bucket; the outputs a mode does not ask for are None."""
    rng, cfg, state, resident = _filled(lam, True, use_digest)
    qkeys = _queries(rng, resident)
    k, probe, jin, tin = _probe_inputs(cfg, qkeys)
    same = np.arange(N) % 11 == 3            # bucket2 == bucket1 on these lanes
    b2 = np.where(same, np.asarray(jin[0]), np.asarray(jin[1]))
    jin = (jin[0], jnp.asarray(b2, jin[1].dtype), *jin[2:])
    tin = (tin[0], torch.from_numpy(b2.astype(np.int64)), *tin[2:])
    ps = convert.state_from_arrays(state, device="cpu")
    q = tin[2:] if mode != "target" else (None, None)   # the target pass reads no query
    got = pus.upsert_probe(ps.digests, ps.keys, ps.scores, *tin[:2], *q,
                           use_digest=use_digest, mode=mode)
    want = jus.upsert_probe(state.digests, state.key_hi, state.key_lo, state.score_hi,
                            state.score_lo, *jin, use_digest=use_digest, interpret=True)
    names = ("found", "hit_sel", "hit_slot", "tgt_sel")
    for i, name in enumerate(names):
        if i in PROBE_OUTPUTS[mode]:
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=name)
        else:
            assert got[i] is None, f"{mode}: {name} was not asked for"
    if mode != "target":
        assert got[0].sum() > 0 and (got[0] == 0).sum() > 0
        return
    # the select stage: the target pass on a lane gate, the jnp D1/D2 rule
    # on the gated lanes and bucket1 elsewhere
    gate = torch.from_numpy(rng.random(N) < 0.5)
    target = np.asarray(jmerge._select_target_bucket(state, cfg, probe))
    pt_probe = pfind.Probe(tin[0], torch.from_numpy(np.asarray(probe.bucket2).astype(np.int64)),
                           tin[2], tin[3] != -1)
    stages = pkops.kernel_stages(_port_cfg(cfg), torch.device("cpu"))
    np.testing.assert_array_equal(stages.select_target(ps, None, pt_probe, gate).numpy(),
                                  np.where(gate.numpy(), target, np.asarray(probe.bucket1)))
    *_, gated = pus.upsert_probe(ps.digests, ps.keys, ps.scores, *tin[:2], mode="target",
                                 lanes=gate)
    np.testing.assert_array_equal(gated.numpy(), np.where(gate.numpy(), np.asarray(want[3]), 0))
    assert not gated[same].any()
    if lam == 1.0:  # the D2 (full-bucket) branch decided some targets
        assert (got[3] == 1).any() and (got[3] == 0).any()


TIE_KINDS = ("all_empty", "equal_scores", "stale_empty_scores", "duplicate_keys")


def _tie_row(kind, rng):
    """One bucket row (keys, scores as uint64 [128]) where the victim order
    rests on its tie-breaks."""
    s = 128
    keys = rng.integers(0, 2**64 - 1, size=s, dtype=np.uint64)
    if kind == "all_empty":             # every slot free: (score, slot) order
        return np.full(s, EMPTY), rng.integers(0, 3, size=s).astype(np.uint64)
    if kind == "equal_scores":          # every slot live, one score: (key, slot)
        return keys, np.full(s, 7, np.uint64)
    if kind == "stale_empty_scores":    # free slots keep nonzero scores
        keys[rng.random(s) < 0.5] = EMPTY
        return keys, rng.integers(1, 4, size=s).astype(np.uint64) << np.uint64(40)
    assert kind == "duplicate_keys"     # equal keys (and scores) within the row
    keys = rng.choice(np.array([5, 2**63 + 1, EMPTY], np.uint64), size=s)
    return keys, rng.choice(np.array([0, 2**64 - 1], np.uint64), size=s)


def _claim_inputs(case):
    """(key_hi, key_lo, score_hi, score_lo planes, buckets, ranks) for one
    case: a table filled to λ with random buckets and ranks both small and
    across the row, or two tie-heavy rows at every rank 0-127."""
    if isinstance(case, float):
        rng, cfg, state, _ = _filled(case, True)
        buckets = rng.integers(0, cfg.num_buckets, size=N).astype(np.int32)
        rank = np.concatenate([rng.integers(0, 4, size=N // 2), rng.integers(0, 128, size=N // 2)])
        planes = (state.key_hi, state.key_lo, state.score_hi, state.score_lo)
        return planes, buckets, rank.astype(np.int32)
    rng = np.random.default_rng(TIE_KINDS.index(case))
    rows = [_tie_row(case, rng) for _ in range(2)]
    planes = []
    for a in (np.stack([k for k, _ in rows]), np.stack([c for _, c in rows])):
        planes += [jnp.asarray((a >> np.uint64(32)).astype(np.uint32)),
                   jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32))]
    return (tuple(planes), np.repeat(np.arange(2, dtype=np.int32), 128),
            np.tile(np.arange(128, dtype=np.int32), 2))


@pytest.mark.parametrize("case", [*LAMBDAS, *TIE_KINDS])
def test_claim_scan_plain_matches_jax(case):
    planes, buckets, rank = _claim_inputs(case)
    kh, kl, sh, sl = planes
    jstate = jtable.HKVState(key_hi=kh, key_lo=kl, digests=np.zeros(kh.shape, np.uint8),
                             score_hi=sh, score_lo=sl, values=np.zeros((kh.size, 1), np.float32),
                             clock_hi=0, clock_lo=0, epoch=0)
    ps = convert.state_from_arrays(jstate, device="cpu")
    tb, tr = torch.from_numpy(buckets.astype(np.int64)), torch.from_numpy(rank.astype(np.int64))
    slot, occ, score, key = pus.claim_scan(ps.keys, ps.scores, tb, tr)
    w = jus.claim_scan(*planes, jnp.asarray(buckets), jnp.asarray(rank), interpret=True)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(w[0]))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(w[1]))
    np.testing.assert_array_equal(_np(score), _u64(w[2], w[3]))
    np.testing.assert_array_equal(_np(key), _u64(w[4], w[5]))
    jcfg = jtable.HKVConfig(capacity=kh.size, dim=1)
    jslot, jocc, jsc, jkey = jmerge._jnp_victim_at_rank(jstate, jcfg, jnp.asarray(buckets),
                                                        jnp.asarray(rank))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(occ.numpy().astype(bool), np.asarray(jocc))
    np.testing.assert_array_equal(_np(key), _u64(jkey.hi, jkey.lo))
    if isinstance(case, float):
        assert (occ == 0).any() == (case < 1.0)
    else:   # every slot of each row is selected once over the 128 ranks
        for b in range(2):
            assert sorted(slot.numpy()[b * 128:(b + 1) * 128]) == list(range(128))


@pytest.mark.parametrize("add", [False, True], ids=["set", "add"])
def test_scatter_rows_plain_matches_jax(add):
    rng = np.random.default_rng(5 + add)
    r, d = 8 * 128, 8
    values = rng.normal(size=(r, d)).astype(np.float32)
    rows = rng.permutation(r)[:N].astype(np.int64)
    mask = rng.random(N) < 0.7
    # masked-out lanes aimed at masked-in rows, and past the plane's end:
    # neither may write
    rows[~mask] = np.where(rng.random((~mask).sum()) < 0.5,
                           rng.choice(rows[mask], size=(~mask).sum()), r + 3)
    updates = rng.normal(size=(N, d)).astype(np.float32)
    want = jref.scatter_rows_ref(jnp.asarray(values), jnp.asarray(rows.astype(np.int32)),
                                 jnp.asarray(updates), jnp.asarray(mask), add)
    got = torch.from_numpy(values.copy())
    psc.scatter_rows(got, torch.from_numpy(rows), torch.from_numpy(updates),
                     torch.from_numpy(mask), add)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), values)


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("lam", LAMBDAS)
def test_digest_scan_plain_matches_jax(lam, dual):
    """The plain digest_scan against both TPU schedules (tlp and
    pipeline, interpret mode) and the jnp reference, on each candidate
    bucket; then locate_kernel against the JAX locate kernel, EMPTY lanes
    included (an EMPTY query misses on both sides and reports slot 0:
    the free slots that hold the EMPTY key carry digest 0xFF, not its
    digest 28, and a resident slot with digest 28 fails the key compare)."""
    rng, cfg, state, resident = _filled(lam, dual)
    qkeys = _queries(rng, resident)
    k, probe, jin, tin = _probe_inputs(cfg, qkeys)
    ps = convert.state_from_arrays(state, device="cpu")
    for jb, tb in ((jin[0], tin[0]), (jin[1], tin[1])):
        slot, found = pds.digest_scan(ps.digests, ps.keys, tb, tin[2], tin[3])
        jargs = (state.digests, state.key_hi, state.key_lo, jb, jin[2], jin[3], jin[4])
        for want in (jds.digest_scan_tlp(*jargs, interpret=True),
                     jds.digest_scan_pipeline(*jargs, q_tile=N // 2, interpret=True),
                     jref.digest_scan_ref(*jargs)):
            np.testing.assert_array_equal(slot.numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(found.numpy(), np.asarray(want[1]))
        assert found.sum() > 0 and (found == 0).sum() > 0
        assert not found.numpy()[qkeys == EMPTY].any()
    jl = jkops.locate_kernel(state, cfg, k, interpret=True)
    pl = pkops.locate_kernel(ps, _port_cfg(cfg), tin[3])
    got = convert.locate_to_arrays(pl)
    for f in ("found", "bucket", "slot", "row"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jl, f)), err_msg=f)
    # and the plain locate of core.find, which the CPU path runs
    jf = jfind.locate(state, cfg, k)
    for f in ("found", "bucket", "slot", "row"):
        np.testing.assert_array_equal(convert.locate_to_arrays(pfind.locate(ps, _port_cfg(cfg), tin[3]))[f],
                                      np.asarray(getattr(jf, f)), err_msg=f)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_digest_scan_dual_form_matches_two_jax_launches(lam):
    """The dual form (one launch over both candidate rows, merged in
    place) against the reference's two digest_scan_tlp launches
    (interpret mode) and its merge in locate_kernel: a hit in bucket1
    wins, sel marks a hit in bucket2 only, slot 0 on a miss.  The queries
    hold EMPTY keys, keys resident in either row, lanes whose two rows
    coincide, and forced digest collisions: absent keys given the digest
    of a live slot of their bucket1 row (or, on other lanes, their bucket2
    row), which must fail the full-key compare."""
    rng, cfg, state, resident = _filled(lam, True)
    qkeys = _queries(rng, resident)
    _, _, jin, tin = _probe_inputs(cfg, qkeys)
    b1, b2, qd, qk = (t.clone() for t in tin)
    digests, keys = np.asarray(state.digests), ju64.to_uint64(state.keys)
    absent = np.flatnonzero(~np.isin(qkeys, resident) & (qkeys != EMPTY))
    coll = rng.choice(absent, size=len(absent) // 2, replace=False)
    for i, lane in enumerate(coll):
        row = int((b1 if i % 2 else b2)[lane])
        live = np.flatnonzero(keys[row] != EMPTY)
        qd[lane] = int(digests[row, rng.choice(live)])
    same = rng.choice(np.setdiff1d(np.arange(N), coll), size=N // 8, replace=False)
    b2[same] = b1[same]
    jb1, jb2 = jnp.asarray(b1.numpy().astype(np.int32)), jnp.asarray(b2.numpy().astype(np.int32))
    jqd = jnp.asarray(qd.numpy().astype(np.uint32))
    ps = convert.state_from_arrays(state, device="cpu")
    slot, found, sel = pds.digest_scan(ps.digests, ps.keys, b1, qd, qk, b2)
    (s1, f1), (s2, f2) = (
        (np.asarray(x) for x in jds.digest_scan_tlp(state.digests, state.key_hi, state.key_lo, jb,
                                                    jqd, jin[3], jin[4], interpret=True))
        for jb in (jb1, jb2))
    hit1, hit2 = f1.astype(bool), f2.astype(bool)
    np.testing.assert_array_equal(found.numpy(), (hit1 | hit2).astype(np.int32))
    np.testing.assert_array_equal(sel.numpy(), (~hit1 & hit2).astype(np.int32))
    np.testing.assert_array_equal(slot.numpy(), np.where(hit1, s1, np.where(hit2, s2, 0)))
    assert not found.numpy()[qkeys == EMPTY].any() and not found.numpy()[coll].any()
    assert (sel == 1).any() and ((found == 1) & (sel == 0)).any() and (found == 0).any()
    # the single-row form is the dual form's first probe
    one = pds.digest_scan(ps.digests, ps.keys, b1, qd, qk)
    np.testing.assert_array_equal(one[0].numpy(), s1)
    np.testing.assert_array_equal(one[1].numpy(), f1)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_gather_rows_plain_matches_jax(lam):
    """Masked gather at the rows of resident keys and of misses, with rows
    past the plane's end (clipped by both wrappers)."""
    rng, cfg, state, _ = _filled(lam, True)
    values = np.array(state.values)
    r = values.shape[0]
    rows = rng.integers(0, r, size=N).astype(np.int64)
    rows[::9] = r + 4
    mask = rng.random(N) < 0.5
    got = pga.gather_rows(torch.from_numpy(values), torch.from_numpy(rows), torch.from_numpy(mask))
    clipped = jnp.asarray(np.clip(rows, 0, r - 1).astype(np.int32))
    for want in (jga.gather_rows(jnp.asarray(values), clipped, jnp.asarray(mask.astype(np.int32)),
                                 interpret=True),
                 jref.gather_rows_ref(jnp.asarray(values), jnp.asarray(rows.astype(np.int32)),
                                      jnp.asarray(mask))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[torch.from_numpy(~mask)].eq(0).all() and got[torch.from_numpy(mask)].ne(0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("width", [1, 5, 8])
def test_gather_rows_width_plain_matches_jax(width, dtype):
    """gather_rows of the first `width` columns (the readback's dim columns
    of a plane with aux ones) equals the reference's gather_rows, and its
    jnp reference, sliced to `width`; float32, bfloat16 and float16 planes
    copied bit for bit."""
    import ml_dtypes

    rng, cfg, state, _ = _filled(1.0, True)
    values = np.array(state.values)
    if dtype == "bfloat16":
        values = values.astype(ml_dtypes.bfloat16)
    elif dtype == "float16":
        values = values.astype(np.float16)
    r = values.shape[0]
    rows = rng.integers(0, r, size=N).astype(np.int64)
    rows[::9] = r + 4
    mask = rng.random(N) < 0.5
    got = pga.gather_rows(convert.values_from_numpy(values), torch.from_numpy(rows),
                          torch.from_numpy(mask), width)
    assert tuple(got.shape) == (N, width)
    got = convert.values_to_numpy(got)
    clipped = jnp.asarray(np.clip(rows, 0, r - 1).astype(np.int32))
    for want in (jga.gather_rows(jnp.asarray(values), clipped, jnp.asarray(mask.astype(np.int32)),
                                 interpret=True),
                 jref.gather_rows_ref(jnp.asarray(values), jnp.asarray(rows.astype(np.int32)),
                                      jnp.asarray(mask))):
        want = np.asarray(want)[:, :width]
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    with pytest.raises(ValueError, match="width"):
        pga.gather_rows(convert.values_from_numpy(values), torch.from_numpy(rows),
                        torch.from_numpy(mask), values.shape[1] + 1)


@pytest.mark.parametrize("kind", ("always", "score_lt", "score_ge", "epoch_lt", "key_range"))
@pytest.mark.parametrize("lam", LAMBDAS)
def test_sweep_match_plain_matches_jax(lam, kind):
    """Every predicate kind over the whole table against the Pallas sweep
    kernel in interpret mode: mask and per-bucket count."""
    rng, cfg, state, resident = _filled(lam, True)
    ps = convert.state_from_arrays(state, device="cpu")
    live_scores = np.unique(_u64(state.score_hi, state.score_lo)[np.asarray(state.key_hi) != 0xFFFFFFFF])
    keys = np.sort(resident)
    threshold = int(live_scores[1])   # lfu counts: 1 below it, the rest at or above
    jp = {"always": JaxPredicate.always(),
          "score_lt": JaxPredicate.score_below(threshold),
          "score_ge": JaxPredicate.score_at_least(threshold),
          # lfu scores are small counts with a zero high half, so every
          # live entry is below epoch 1 (wide words: test_torch_sweep.py)
          "epoch_lt": JaxPredicate.expire_before(1),
          "key_range": JaxPredicate.key_in_range(int(keys[len(keys) // 3]),
                                                 int(keys[2 * len(keys) // 3]))}[kind]
    match, count = psw.sweep_match(ps.keys, ps.scores, convert.predicate_from_arrays(jp))
    wm, wc = jsw.sweep_match(state.key_hi, state.key_lo, state.score_hi, state.score_lo,
                             jp.a_hi, jp.a_lo, jp.b_hi, jp.b_lo, kind=kind, interpret=True)
    np.testing.assert_array_equal(match.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(count.numpy(), np.asarray(wc))
    assert match.dtype == torch.bool and count.dtype == torch.int32
    if kind in ("score_lt", "score_ge", "key_range"):
        assert 0 < int(count.sum()) < len(resident)
