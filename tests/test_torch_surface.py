"""The port's public surface against the JAX package's: every public name
of the reference's table layer exists in the port, with the reference's
meaning.

Names the port's int64-word design drops are left out: ``U64`` and the
(hi, lo) uint32 fields of the reference's state (``key_hi`` ... ``clock_lo``;
the port holds one int64 plane a word), and the pytree hooks
(``tree_flatten``, ``tree_unflatten``).  A NamedTuple's inherited tuple
methods are not part of the surface.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import scores as jscores  # noqa: E402
from repro.core import table as jtable  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro.core.api import HKVTable as JHKVTable  # noqa: E402
from repro.core.tiered import TieredHKVTable as JTiered  # noqa: E402
from repro.distributed.table_sharding import ShardedHKVTable as JSharded  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import ShardedHKVTable, TieredHKVTable, convert  # noqa: E402
from repro_torch.core import scores as tscores  # noqa: E402
from repro_torch.core import table as ttable  # noqa: E402
from repro_torch.core.api import HKVTable  # noqa: E402

DROPPED = {"U64", "key_hi", "key_lo", "score_hi", "score_lo", "clock_hi", "clock_lo",
           "tree_flatten", "tree_unflatten"}


def _public(obj) -> set:
    names = {n for n in dir(obj) if not n.startswith("_")}
    if isinstance(obj, types.ModuleType):
        names = {n for n in names if not isinstance(getattr(obj, n), types.ModuleType)}
    if isinstance(obj, tuple) or (isinstance(obj, type) and issubclass(obj, tuple)):
        names -= set(dir(tuple))
    return names


def _state_pair():
    """One table state in both packages: 200 LFU upserts into 2 buckets."""
    cfg = jtable.HKVConfig(capacity=2 * 128, dim=4, score_policy="lfu")
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 10_000, size=200).astype(np.uint64)
    st = jops.insert_or_assign(jtable.create(cfg), cfg, ju64.from_uint64(keys),
                               jnp.ones((200, 4))).state
    return st, convert.state_from_arrays(st, device="cpu")


@pytest.mark.parametrize("ref,port", [
    (jcore, tcore), (jcore, repro_torch), (jtable.HKVConfig, ttable.HKVConfig),
    (jscores.ScorePolicy, tscores.ScorePolicy), (JHKVTable, HKVTable),
    (JTiered, TieredHKVTable), (JSharded, ShardedHKVTable)],
    ids=["core", "package", "HKVConfig", "ScorePolicy", "HKVTable", "TieredHKVTable",
         "ShardedHKVTable"])
def test_port_has_every_reference_name(ref, port):
    missing = _public(ref) - _public(port) - DROPPED
    assert not missing, f"{port} lacks {sorted(missing)}"


def test_state_has_every_reference_name():
    jst, tst = _state_pair()
    missing = _public(jst) - _public(tst) - DROPPED
    assert not missing, f"HKVState lacks {sorted(missing)}"


def test_state_views_equal_the_reference():
    jst, tst = _state_pair()
    assert tst.num_buckets == jst.num_buckets == 2
    assert tst.slots_per_bucket == jst.slots_per_bucket
    assert tst.load_factor().dtype == torch.float32
    assert float(tst.load_factor()) == float(jst.load_factor())
    got = tst.bucket_occupancy()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jst.bucket_occupancy()))
    np.testing.assert_array_equal(tst.occupied_mask().numpy(), np.asarray(jst.occupied_mask()))


@pytest.mark.parametrize("dim,aux,dtype", [(4, 0, "float32"), (32, 1, "float32"),
                                           (896, 1, "float32"), (32, 0, "bfloat16")])
def test_bytes_per_entry_equals_the_reference(dim, aux, dtype):
    j = jtable.HKVConfig(capacity=128, dim=dim, aux_value_dim=aux, value_dtype=getattr(jnp, dtype))
    t = ttable.HKVConfig(capacity=128, dim=dim, aux_value_dim=aux,
                         value_dtype=getattr(torch, dtype))
    assert t.bytes_per_entry() == j.bytes_per_entry()


@pytest.mark.parametrize("name", jscores.POLICIES)
def test_counts_frequency_equals_the_reference(name):
    assert tscores.ScorePolicy(name).counts_frequency == jscores.ScorePolicy(name).counts_frequency
