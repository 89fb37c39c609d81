"""repro_torch: the PyTorch/CUDA port of the HKV table package ``repro``.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Ops run on the card unless the caller asks for the CPU:

    from repro_torch import HKVTable
    table = HKVTable.create(capacity=2**27, dim=32, buckets_per_key=2)
"""

from repro_torch.core.api import HKVTable, normalize_keys
from repro_torch.core.table import HKVConfig, HKVState

__all__ = ["HKVConfig", "HKVState", "HKVTable", "normalize_keys"]
