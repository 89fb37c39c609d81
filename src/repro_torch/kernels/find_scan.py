"""find_scan: the fused find pass (CUDA source ``csrc/find_scan.cu``), and
its multi-table form ``find_scan_many``.

Replaces the TPU kernels ``find_scan_tlp`` and ``find_scan_pipeline``
(``src/repro/kernels/find_scan.py``), one function on two TPU schedules.
Per query, over both candidate rows: digest pre-filter, full-key confirm,
hit in bucket1 wins (a miss reports bucket1, slot 0), the hit slot's score,
and its value row (zeros on a miss), float32 or bfloat16, copied bit for
bit.  An EMPTY query key is a miss.  (The
reference kernel lets it match empty slots and its wrapper masks found,
values and scores afterwards; deciding it here spares that pass.)
"""

from __future__ import annotations

import torch

from repro_torch.core.find import match_rows
from repro_torch.core.u64 import EMPTY
from repro_torch.kernels import _build

NAME = "find_scan"
MANY = "find_scan_many"


def find_scan_plain(digests, keys, scores, values, bucket1, bucket2, qdigest,
                    qkeys, use_digest: bool = True):
    """The plain PyTorch version.  Returns (found i32 [N], sel i32 [N],
    slot i32 [N], score i64 [N], values [N, V])."""
    s = keys.shape[1]
    valid = qkeys != EMPTY
    hit1, slot1 = match_rows(keys, digests, bucket1, qkeys, qdigest, use_digest)
    hit2, slot2 = match_rows(keys, digests, bucket2, qkeys, qdigest, use_digest)
    hit1, hit2 = hit1 & valid, hit2 & valid
    found = hit1 | hit2
    sel = ~hit1 & hit2
    slot = torch.where(hit1, slot1, torch.where(hit2, slot2, 0))
    bucket = torch.where(sel, bucket2, bucket1)
    score = torch.where(found, scores[bucket, slot], 0)
    vals = values[bucket * s + slot]
    vals = torch.where(found[:, None], vals, torch.zeros_like(vals))
    i32 = torch.int32
    return found.to(i32), sel.to(i32), slot.to(i32), score, vals


def find_scan(digests, keys, scores, values, bucket1, bucket2, qdigest, qkeys,
              use_digest: bool = True):
    """Fused find.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return find_scan_plain(digests, keys, scores, values, bucket1, bucket2,
                               qdigest, qkeys, use_digest)
    _build.check(dev.type == "cuda", f"find_scan: unsupported device {dev}")
    b, s = keys.shape
    n, v = qkeys.shape[0], values.shape[1]
    _build.check(s == 128, "find_scan: the kernel takes 128 slots per bucket")
    _build.check_values("values", values, (b * s, v), dev)
    for name, t, dt, shape, align in (   # digest lines and keys are read in 16-byte words
            ("digests", digests, torch.uint8, (b, s), 16), ("keys", keys, torch.int64, (b, s), 16),
            ("scores", scores, torch.int64, (b, s), 8),
            ("bucket1", bucket1, torch.int64, (n,), 8), ("bucket2", bucket2, torch.int64, (n,), 8),
            ("qdigest", qdigest, torch.uint8, (n,), 1), ("qkeys", qkeys, torch.int64, (n,), 8)):
        _build.check_tensor(name, t, dt, shape, dev, align)
    found = torch.empty(n, dtype=torch.int32, device=dev)
    sel = torch.empty_like(found)
    slot = torch.empty_like(found)
    score = torch.empty(n, dtype=torch.int64, device=dev)
    vals = torch.empty((n, v), dtype=values.dtype, device=dev)
    # rows move in 16-byte words where every row starts on a 16-byte
    # boundary of both planes, else in 4- or 2-byte words (V = 33, a view
    # at an offset)
    row_bytes = v * values.element_size()
    unit = _build.copy_unit((row_bytes,), (values, vals))
    if n:
        _build.launch(NAME, digests, keys, scores, values, bucket1, bucket2, qdigest,
                      qkeys, found, sel, slot, score, vals, n, row_bytes, int(use_digest), unit)
    return found, sel, slot, score, vals


def find_scan_many_plain(planes, bucket1, bucket2, qdigest, qkeys, counts,
                         use_digest: bool = True):
    """The plain version of the multi-table form: one `find_scan_plain`
    per table on its queries (the first counts[0] queries are table 0's,
    and so on), concatenated."""
    outs, start = [], 0
    for (digests, keys, scores, values), c in zip(planes, counts):
        sl = slice(start, start + c)
        outs.append(find_scan_plain(digests, keys, scores, values, bucket1[sl], bucket2[sl],
                                    qdigest[sl], qkeys[sl], use_digest))
        start += c
    return tuple(torch.cat(parts) for parts in zip(*outs))


def find_scan_many(planes, bucket1, bucket2, qdigest, qkeys, counts, use_digest: bool = True):
    """find_scan over T tables of one geometry in ONE launch.  `planes`:
    T (digests, keys, scores, values) tuples; the queries come table by
    table (`counts[t]` of table t), with table-local buckets.  Returns the
    outputs of `find_scan` for all the queries, in order.  The kernel gets
    the tables' base addresses (no plane is copied).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    dev = qkeys.device
    if dev.type == "cpu":
        return find_scan_many_plain(planes, bucket1, bucket2, qdigest, qkeys, counts,
                                    use_digest)
    _build.check(dev.type == "cuda", f"find_scan_many: unsupported device {dev}")
    t_n = len(planes)
    _build.check(t_n >= 1 and len(counts) == t_n, "find_scan_many: one count a table")
    b, s = planes[0][1].shape
    n, v = qkeys.shape[0], planes[0][3].shape[1]
    _build.check(s == 128, "find_scan_many: the kernel takes 128 slots per bucket")
    _build.check(sum(counts) == n, f"find_scan_many: counts sum to {sum(counts)}, not {n}")
    for t, (digests, keys, scores, values) in enumerate(planes):
        _build.check(values.dtype == planes[0][3].dtype,
                     f"find_scan_many: table {t}'s values are {values.dtype}")
        _build.check_values(f"values[{t}]", values, (b * s, v), dev)
        for name, x, dt, align in (("digests", digests, torch.uint8, 16),
                                   ("keys", keys, torch.int64, 16),
                                   ("scores", scores, torch.int64, 8)):
            _build.check_tensor(f"{name}[{t}]", x, dt, (b, s), dev, align)
    for name, x, dt in (("bucket1", bucket1, torch.int64), ("bucket2", bucket2, torch.int64),
                        ("qdigest", qdigest, torch.uint8), ("qkeys", qkeys, torch.int64)):
        _build.check_tensor(name, x, dt, (n,), dev, x.element_size())
    found = torch.empty(n, dtype=torch.int32, device=dev)
    sel = torch.empty_like(found)
    slot = torch.empty_like(found)
    score = torch.empty(n, dtype=torch.int64, device=dev)
    vals = torch.empty((n, v), dtype=planes[0][3].dtype, device=dev)
    row_bytes = v * vals.element_size()
    unit = _build.copy_unit((row_bytes,), (*(p[3] for p in planes), vals))
    if n:
        # the planes' base addresses (digests first, then keys, scores,
        # values) and the queries' table offsets, in one copy from pinned
        # memory that does not wait for the stream
        offsets, acc = [0], 0
        for c in counts:
            acc += c
            offsets.append(acc)
        meta = torch.tensor([p[i].data_ptr() for i in range(4) for p in planes] + offsets,
                            dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
        _build.launch(MANY, meta, t_n, meta[4 * t_n:], bucket1, bucket2, qdigest, qkeys, found,
                      sel, slot, score, vals, n, row_bytes, int(use_digest), unit)
    return found, sel, slot, score, vals
