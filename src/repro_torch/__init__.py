"""repro_torch: the PyTorch/CUDA port of the HKV table package ``repro``.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Ops run on the card unless the caller asks for the CPU:

    from repro_torch import HKVTable, SweepPredicate
    table = HKVTable.create(capacity=2**27, dim=32, buckets_per_key=2)
"""

from repro_torch.core.api import HKVTable, dedupe_keys, normalize_keys
from repro_torch.core.merge import EvictionStream
from repro_torch.core.predicates import SweepPredicate
from repro_torch.core.table import HKVConfig, HKVState

__all__ = ["EvictionStream", "HKVConfig", "HKVState", "HKVTable", "SweepPredicate",
           "dedupe_keys", "normalize_keys"]
