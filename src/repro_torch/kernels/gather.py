"""gather_rows: masked, position-addressed row gather (CUDA source
``csrc/gather.cu``).

Replaces ``gather_rows`` (``src/repro/kernels/gather.py``):
``out[i] = mask[i] ? values[rows[i]] : 0``.  As in the reference's
wrappers, rows are clipped into the plane before the gather.
"""

from __future__ import annotations

import torch

from repro_torch.core.find import gather_rows as gather_rows_plain  # noqa: F401  (rows clipped)
from repro_torch.kernels import _build

NAME = "gather_rows"


def gather_rows(values, rows, mask):
    """Masked row gather.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    rows = rows.clamp(0, values.shape[0] - 1)
    dev = values.device
    if dev.type == "cpu":
        return gather_rows_plain(values, rows, mask)
    _build.check(dev.type == "cuda", f"gather_rows: unsupported device {dev}")
    r, v = values.shape
    n = rows.shape[0]
    _build.check_tensor("values", values, torch.float32, (r, v), dev)
    _build.check_tensor("rows", rows, torch.int64, (n,), dev)
    _build.check_tensor("mask", mask, torch.bool, (n,), dev)
    out = torch.empty((n, v), dtype=values.dtype, device=dev)
    vec4 = v % 4 == 0 and values.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    if n:
        _build.launch(NAME, values, rows, mask, out, n, v, int(vec4))
    return out
