"""bucket_stats and TableStats of the port against the JAX package.

The plain `bucket_stats` against `kernels.ref.bucket_stats_ref` and the
Pallas kernel (interpret mode), including an all-empty bucket (all-ones
score, slot 0) and buckets whose minimum is tied; `HKVTable.stats()`
against `maintenance.stats.stats_from_planes`.  Tolerance: exact, every
output is an integer or a float32 quotient computed the same way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import HKVTable as JaxTable  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import score_scan as jscore  # noqa: E402
from repro.maintenance import stats as jstats  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import score_scan  # noqa: E402
from repro_torch.maintenance import stats as pstats  # noqa: E402

U32 = np.uint32(0xFFFFFFFF)


def _planes(seed, b=8):
    """Key and score planes with empty slots, an all-empty bucket, a bucket
    of tied minima, a bucket whose only live score is the all-ones word
    (tied with its free slots), and scores at and above 2**63."""
    rng = np.random.default_rng(seed)
    kh = rng.integers(0, 2**32, size=(b, 128), dtype=np.uint64).astype(np.uint32)
    kl = rng.integers(0, 2**32, size=(b, 128), dtype=np.uint64).astype(np.uint32)
    sh = rng.integers(0, 4, size=(b, 128)).astype(np.uint32)
    sh[:, ::9] |= np.uint32(0x80000000)
    sl = rng.integers(0, 2**32, size=(b, 128), dtype=np.uint64).astype(np.uint32)
    empty = rng.random((b, 128)) < 0.3
    empty[2] = True                          # all empty
    sh[3], sl[3] = 0, 5                      # tied minima: slot 0 wins ...
    empty[3, :4] = True                      # ... or the first live one
    empty[4] = True                          # one live slot, all-ones score,
    empty[4, 50] = False                     # tied with the free slots
    sh[4, 50], sl[4, 50] = U32, U32
    kh[empty], kl[empty] = U32, U32
    return kh, kl, sh, sl


def _port(kh, kl, sh, sl):
    st = convert.state_from_arrays({"key_hi": kh, "key_lo": kl, "score_hi": sh, "score_lo": sl,
                                    "digests": np.zeros(kh.shape, np.uint8),
                                    "values": np.zeros((kh.size, 1), np.float32),
                                    "clock_hi": 0, "clock_lo": 0, "epoch": 0}, device="cpu")
    return st


def _words(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_stats_plain_matches_ref_and_the_interpret_kernel(seed):
    kh, kl, sh, sl = _planes(seed)
    st = _port(kh, kl, sh, sl)
    occ, low, slot = kops.bucket_stats_kernel(st)
    for name, want in (("ref", jref.bucket_stats_ref(kh, kl, sh, sl)),
                       ("kernel", jscore.bucket_stats(jnp.asarray(kh), jnp.asarray(kl),
                                                      jnp.asarray(sh), jnp.asarray(sl),
                                                      interpret=True))):
        w_occ, w_hi, w_lo, w_slot = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(occ.numpy(), w_occ, err_msg=name)
        np.testing.assert_array_equal(low.numpy(), _words(w_hi, w_lo), err_msg=name)
        np.testing.assert_array_equal(slot.numpy(), w_slot, err_msg=name)
    assert int(occ[2]) == 0 and int(low[2]) == -1 and int(slot[2]) == 0
    assert int(slot[3]) == 4 and int(low[3]) == 5
    assert int(occ[4]) == 1 and int(low[4]) == -1 and int(slot[4]) == 0


def test_bucket_stats_wrapper_checks_device():
    meta = torch.empty((1, 128), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        score_scan.bucket_stats(meta, meta)


@pytest.mark.parametrize("policy", ["lru", "custom"])
@pytest.mark.parametrize("fill", [0, 100, 700])
def test_stats_match_stats_from_planes(policy, fill):
    """HKVTable.stats() of a table driven through both packages, empty,
    partly and over-full: size, load factor, histogram and quantiles."""
    rng = np.random.default_rng(fill)
    kw = dict(capacity=4 * 128, dim=4, buckets_per_key=2, score_policy=policy)
    jt = JaxTable.create(backend="jnp", **kw)
    pt = repro_torch.HKVTable.create(device="cpu", **kw)
    for i in range(0, fill, 100):
        keys = rng.integers(0, 2**63, size=100).astype(np.uint64)
        vals = rng.normal(size=(100, 4)).astype(np.float32)
        cs = rng.integers(0, 2**64 - 1, size=100, dtype=np.uint64) if policy == "custom" else None
        jt = jt.insert_or_assign(keys, vals, cs).table
        pt.insert_or_assign(keys, vals, cs)
    want, got = jt.stats(), pt.stats()
    assert int(got.size) == int(want.size) and got.capacity == int(want.capacity)
    np.testing.assert_array_equal(got.load_factor.numpy(), np.asarray(want.load_factor))
    np.testing.assert_array_equal(got.occupancy_hist.numpy(), np.asarray(want.occupancy_hist))
    np.testing.assert_array_equal(got.score_quantiles(), want.score_quantiles())
    assert isinstance(got, pstats.TableStats)


@pytest.mark.parametrize("n", [0, 1, 6, 2**24 + 4, 3 * 2**24 + 1, 2**27])
def test_quantile_index_rounds_in_float32(n):
    """The quantile index is round(q * float32(n - 1)), half to even, in
    float32 as the reference computes it: a live count above 2**24, which
    float32 does not hold exactly, indexes as the reference does."""
    cap = 2**27
    q = jnp.asarray(jstats.QUANTILES, jnp.float32)
    want = jnp.clip(jnp.round(q * jnp.maximum(jnp.int32(n) - 1, 0).astype(jnp.float32))
                    .astype(jnp.int32), 0, cap - 1)
    got = pstats.quantile_index(torch.tensor(n), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
