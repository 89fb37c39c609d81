"""hkvbench: the benchmark of the PyTorch and CUDA HierarchicalKV package
(``repro_torch``).  ``python hkvbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; README.md says how to add
a cell, a configuration, a traffic mix or a per-layer metric."""
