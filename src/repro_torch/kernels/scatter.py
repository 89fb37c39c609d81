"""scatter_rows: masked row scatter / scatter-add in place (CUDA source
``csrc/scatter.cu``).

Replaces ``scatter_rows`` (``src/repro/kernels/scatter.py``), both
``add=False`` and ``add=True``: ``values[rows[i]] (+)= updates[i]`` where
``mask[i]``, float32 or bfloat16.  Rows outside the plane are dropped,
like the reference's ``mode="drop"``.  Masked rows must be unique within
the batch.  Without ``add`` a row is copied bit for bit; with it, each
element is the correctly rounded sum in the plane's dtype (a bfloat16 sum
is taken in float32 and rounded once), which is what ``index_add_`` gives
on unique rows.  The plane may be an 'hmem' plane in pinned host memory
beside rows on the card: the kernel then reads and writes its rows over
the host link (the add reads each row once and writes it once, with no
atomics, as on a plane on the card).
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
    rows launch the kernel (or raise), on a plane on the card or in pinned
    host memory."""
    dev = rows.device
    if dev.type == "cpu" and values.device.type == "cpu":
        return scatter_rows_plain(values, rows, updates, mask, add)
    _build.check(dev.type == "cuda", f"scatter_rows: unsupported device {dev}")
    r, d = values.shape
    n = rows.shape[0]
    _build.check_plane("values", values, (r, d), dev)
    _build.check_tensor("updates", updates, values.dtype, (n, d), dev, values.element_size())
    _build.check_tensor("rows", rows, torch.int64, (n,), dev)
    _build.check_tensor("mask", mask, torch.bool, (n,), dev)
    es = values.element_size()
    unit = _build.copy_unit((d * es,), (values, updates))
    if n:
        _build.launch(NAME, values, rows, updates, mask, n, r, d * es, int(add), es, unit)
