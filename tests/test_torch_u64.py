"""The port's key representation and hash against the JAX package.

Keys are bit-cast int64 in the port and (hi, lo) uint32 planes in the
reference: the hash pair, digest and bucket must agree bit for bit, with
`repro.core.u64` (jnp) and with its numpy reference `hash_pair_np`, on
edge keys and on both branches of `bucket_from_hash` (mask for
power-of-two bucket counts, modulo otherwise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.core.api import normalize_keys  # noqa: E402

EDGE = np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**63 - 1, 2**64 - 2, 2**64 - 1,
                 0xFFFFFFFF00000000, 0x00000000FFFFFFFF, 0x1234567800000000,
                 0x0000000087654321, 0xDEADBEEFCAFEBABE], dtype=np.uint64)
BUCKET_COUNTS = [1, 2, 8, 1024, 2**20, 3, 7, 1000, 12345]


def _keys():
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**64 - 1, size=4096, dtype=np.uint64)
    hi_only = rng.integers(0, 2**32, size=256, dtype=np.uint64) << np.uint64(32)
    lo_only = rng.integers(0, 2**32, size=256, dtype=np.uint64)
    return np.concatenate([EDGE, rand, hi_only, lo_only])


def test_hash_pair_matches_reference_bit_exact():
    keys = _keys()
    h1, h2 = u64.hash_pair(u64.from_numpy_u64(keys))
    n1, n2 = ju64.hash_pair_np(keys)
    np.testing.assert_array_equal(h1.numpy(), n1.astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), n2.astype(np.int64))
    j1, j2 = ju64.hash_pair(ju64.from_uint64(keys))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))


def test_fmix32_wraps_exactly():
    h = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x85EBCA6B, 0xC2B2AE35],
                 dtype=np.uint32)
    got = u64.fmix32(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ju64.fmix32_np(h).astype(np.int64))


@pytest.mark.parametrize("num_buckets", BUCKET_COUNTS)
def test_digest_and_bucket_match_reference(num_buckets):
    keys = _keys()
    h1, h2 = u64.hash_pair(u64.from_numpy_u64(keys))
    j1, j2 = ju64.hash_pair(ju64.from_uint64(keys))
    np.testing.assert_array_equal(u64.digest_from_hash(h1).numpy(),
                                  np.asarray(ju64.digest_from_hash(j1)))
    for h, j in ((h1, j1), (h2, j2)):
        np.testing.assert_array_equal(u64.bucket_from_hash(h, num_buckets).numpy(),
                                      np.asarray(ju64.bucket_from_hash(j, num_buckets)))


def test_flip_gives_unsigned_order():
    keys = _keys()
    order = torch.argsort(u64.flip(u64.from_numpy_u64(keys)), stable=True).numpy()
    np.testing.assert_array_equal(keys[order], np.sort(keys, kind="stable"))
    a, b = keys[:-1], keys[1:]
    ta, tb = u64.from_numpy_u64(a), u64.from_numpy_u64(b)
    np.testing.assert_array_equal(u64.gt(ta, tb).numpy(), a > b)
    np.testing.assert_array_equal(u64.gt(tb, ta).numpy(), a < b)


def test_hi_lo_join_round_trip():
    keys = _keys()
    t = u64.from_numpy_u64(keys)
    np.testing.assert_array_equal(u64.hi32(t).numpy(), (keys >> np.uint64(32)).astype(np.int64))
    np.testing.assert_array_equal(u64.lo32(t).numpy(), (keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    assert torch.equal(u64.join(u64.hi32(t), u64.lo32(t)), t)
    np.testing.assert_array_equal(t.numpy().view(np.uint64), keys)
    assert u64.to_signed(2**64 - 1) == u64.EMPTY and u64.to_signed(2**63) == -(2**63)


@pytest.mark.parametrize("form", ["uint64", "int64", "int32", "list", "torch", "uint32"])
def test_normalize_keys_matches_reference(form):
    raw = np.array([0, 5, 2**40 + 3, -1, -77, 123456789], dtype=np.int64)
    if form == "uint64":
        keys, ref = EDGE, EDGE
    elif form == "int64":
        keys, ref = raw, raw
    elif form == "int32":
        keys = ref = np.array([0, 9, -4, 2**31 - 1], dtype=np.int32)
    elif form == "list":
        keys, ref = raw.tolist(), raw
    elif form == "torch":
        keys, ref = torch.from_numpy(raw), raw
    else:
        keys = ref = np.array([0, 2**32 - 1, 17], dtype=np.uint32)
    want = japi.normalize_keys(ref)
    got = normalize_keys(keys)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  ju64.to_uint64(ju64.U64(jnp.asarray(want.hi), jnp.asarray(want.lo))))
