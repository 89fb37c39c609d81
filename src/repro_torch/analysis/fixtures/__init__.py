"""Deliberately bad fixtures for the port's lint (``tests/test_torch_analysis.py``).

Each file here breaks exactly one contract a checker enforces.  Shipped
code never imports them; the oracle-coupling tree scan leaves the analysis
package out, and the kernel build compiles only ``repro_torch/csrc``.
"""
