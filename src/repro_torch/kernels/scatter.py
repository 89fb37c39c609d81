"""scatter_rows: masked row scatter / scatter-add in place (CUDA source
``csrc/scatter.cu``).

Replaces ``scatter_rows`` (``src/repro/kernels/scatter.py``), both
``add=False`` and ``add=True``: ``values[rows[i]] (+)= updates[i]`` where
``mask[i]``.  Rows outside the plane are dropped, like the reference's
``mode="drop"``.  Masked rows must be unique within the batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "scatter_rows"


def scatter_rows_plain(values, rows, updates, mask, add: bool) -> None:
    """The plain PyTorch version, in place on `values`."""
    sel = mask & (rows >= 0) & (rows < values.shape[0])
    if add:
        values.index_add_(0, rows[sel], updates[sel].to(values.dtype))
    else:
        values[rows[sel]] = updates[sel].to(values.dtype)


def scatter_rows(values, rows, updates, mask, add: bool) -> None:
    """In-place masked scatter.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    dev = values.device
    if dev.type == "cpu":
        return scatter_rows_plain(values, rows, updates, mask, add)
    _build.check(dev.type == "cuda", f"scatter_rows: unsupported device {dev}")
    r, d = values.shape
    n = rows.shape[0]
    _build.check_tensor("values", values, torch.float32, (r, d), dev)
    _build.check_tensor("rows", rows, torch.int64, (n,), dev)
    _build.check_tensor("updates", updates, torch.float32, (n, d), dev)
    _build.check_tensor("mask", mask, torch.bool, (n,), dev)
    if n:
        _build.launch(NAME, values, rows, updates, mask, n, r, d, int(add))
