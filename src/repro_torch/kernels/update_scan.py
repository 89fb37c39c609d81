"""update_scan: the fused gradient step (CUDA source ``csrc/update_scan.cu``).

Replaces the TPU kernels ``update_scan_tlp`` and ``update_scan_pipeline``
(``src/repro/kernels/update_scan.py``), one function on two TPU schedules.
Per query: digest pre-filter and full-key confirm over both candidate rows
(hit1 wins), the ``qvalid`` gate, then on a hit the row ``[dim | aux]``
becomes ``opt.apply(row, grad, dim)`` in place, `opt` being an
``embedding.sparse_opt.SparseOptimizer``.  A miss or a gated lane
writes nothing.  Single-bucket mode passes ``bucket2 = bucket1``.  Any
dim; float32 or bfloat16 values, with the gradients in the plane's dtype
(the kernel rounds where the plain version's bfloat16 ops round).

PRECONDITION: the valid query keys are unique within the batch (the
embedding layer dedupes and sums the gradients first).  With a repeated
key the kernel would update the row from two warps in no fixed order.
"""

from __future__ import annotations

import torch

from repro_torch.core.find import match_rows
from repro_torch.kernels import _build

NAME = "update_scan"
OPT_INDEX = {"sgd": 0, "sgdm": 1, "rowwise_adagrad": 2, "adagrad": 3}


def update_scan_plain(digests, keys, values, bucket1, bucket2, qdigest, qkeys, qvalid,
                      grads, opt, dim: int, use_digest: bool = True):
    """The plain PyTorch version, in place on `values` (the counterpart of
    ``repro/kernels/ref.py::update_scan_ref``).  Returns found int32 [N]."""
    s = keys.shape[1]
    hit1, slot1 = match_rows(keys, digests, bucket1, qkeys, qdigest, use_digest)
    hit2, slot2 = match_rows(keys, digests, bucket2, qkeys, qdigest, use_digest)
    found = (hit1 | hit2) & qvalid
    bucket = torch.where(hit1 | ~hit2, bucket1, bucket2)
    row = bucket * s + torch.where(hit1, slot1, torch.where(hit2, slot2, 0))
    row = row[found]
    values[row] = opt.apply(values[row], grads[found].to(values.dtype), dim).to(values.dtype)
    return found.to(torch.int32)


def update_scan(digests, keys, values, bucket1, bucket2, qdigest, qkeys, qvalid, grads,
                opt, dim: int, use_digest: bool = True):
    """Fused gradient step, in place on `values`.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return update_scan_plain(digests, keys, values, bucket1, bucket2, qdigest, qkeys,
                                 qvalid, grads, opt, dim, use_digest)
    _build.check(dev.type == "cuda", f"update_scan: unsupported device {dev}")
    b, s = keys.shape
    n, v = qkeys.shape[0], values.shape[1]
    _build.check(s == 128, "update_scan: the kernel takes 128 slots per bucket")
    _build.check(dim >= 1, f"update_scan: dim {dim} < 1")
    _build.check(v == dim + opt.aux_dim(dim),
                 f"update_scan: rows of {v} elements, {opt.name} at dim {dim} needs "
                 f"{dim + opt.aux_dim(dim)}")
    _build.check_values("values", values, (b * s, v), dev)
    es = values.element_size()
    for name, t, dt, shape, align in (   # digest lines and keys are read in 16-byte words
            ("digests", digests, torch.uint8, (b, s), 16), ("keys", keys, torch.int64, (b, s), 16),
            ("bucket1", bucket1, torch.int64, (n,), 8), ("bucket2", bucket2, torch.int64, (n,), 8),
            ("qdigest", qdigest, torch.uint8, (n,), 1), ("qkeys", qkeys, torch.int64, (n,), 8),
            ("qvalid", qvalid, torch.bool, (n,), 1), ("grads", grads, values.dtype, (n, dim), es)):
        _build.check_tensor(name, t, dt, shape, dev, align)
    found = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _build.launch(NAME, digests, keys, values, bucket1, bucket2, qdigest, qkeys, qvalid,
                      grads, found, n, v, dim, OPT_INDEX[opt.name], int(use_digest),
                      opt.lr, opt.eps, opt.momentum, es)
    return found
