"""Dictionary-semantic GPU hash-table baselines (paper §5.1, Table 1): the
port's copy of ``repro.baselines``, plain PyTorch on any device.

The two baseline families the paper compares against, with their
collision resolution kept, so the load-factor pathology of Figure 6 /
Table 3 reproduces on any hardware:

  OpenAddressingTable  WarpCore / cuCollections family: linear probing,
                       probe chains that grow with λ, inserts that fail at
                       capacity.
  BucketedP2CTable     BGHT / BP2HT family: 16-slot buckets, power-of-two
                       choices placement, an insert fails when both
                       buckets are full (BP2HT's silent-drop regime at λ 1).

Both are dictionary-semantic: every inserted key must be kept, nothing is
evicted, so λ = 1.0 is a failure regime rather than an operating point.
WarpCore itself is not in the repository; these stand in for it.
"""

from repro_torch.baselines.dict_tables import (  # noqa: F401
    TOMB,
    BucketedP2CTable,
    DictEvictIf,
    DictFindOrInsert,
    DictKVTable,
    DictSweep,
    DictUpsert,
    FindReport,
    InsertReport,
    OAState,
    OpenAddressingTable,
    P2CState,
)
