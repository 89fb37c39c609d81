"""gather_rows: masked, position-addressed row gather (CUDA source
``csrc/gather.cu``).

Replaces ``gather_rows`` (``src/repro/kernels/gather.py``):
``out[i] = mask[i] ? values[rows[i], :width] : 0``, float32, bfloat16 or
float16, copied bit for bit.  As in the reference's wrappers, rows are clipped into
the plane before the gather (on the card, inside the kernel).  ``width``
(default: the plane's V) is the number of leading columns the caller uses:
the readback of ``find_or_insert`` takes the embedding's ``dim`` columns
and leaves the optimizer's aux columns unread.  The plane may be an 'hmem'
plane in pinned host memory beside indices on the card: the kernel then
reads its rows over the host link.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import find as find_mod
from repro_torch.kernels import _build

NAME = "gather_rows"


def gather_rows_plain(values, rows, mask, width: Optional[int] = None):
    """The plain PyTorch version (`rows` within the plane)."""
    if width is not None:
        values = values[:, :width]
    return find_mod.gather_rows(values, rows, mask)


def gather_rows(values, rows, mask, width: Optional[int] = None):
    """Masked row gather of the first `width` columns.  CPU tensors take
    the plain version; CUDA indices launch the kernel (or raise), on a
    plane on the card or in pinned host memory."""
    r, v = values.shape
    width = v if width is None else width
    _build.check(1 <= width <= v, f"gather_rows: width {width} outside [1, {v}]")
    dev = rows.device
    if dev.type == "cpu" and values.device.type == "cpu":
        return gather_rows_plain(values, rows.clamp(0, r - 1), mask, width)
    _build.check(dev.type == "cuda", f"gather_rows: unsupported device {dev}")
    n = rows.shape[0]
    _build.check_plane("values", values, (r, v), dev)
    _build.check_tensor("rows", rows, torch.int64, (n,), dev)
    _build.check_tensor("mask", mask, torch.bool, (n,), dev)
    out = torch.empty((n, width), dtype=values.dtype, device=dev)
    es = values.element_size()
    unit = _build.copy_unit((v * es, width * es), (values, out))
    if n:
        _build.launch(NAME, values, rows, mask, out, n, r, v * es, width * es, unit)
    return out
