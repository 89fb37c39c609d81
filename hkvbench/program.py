"""The program's own spans and counters in a traced run.

`repro_torch.obs.trace` records a span around each table op, each stage of
the upsert closure, the hashing and each kernel launch while a profiler
runs, stamped on the profiler's clock (``time.time_ns()``).  The readers
here lay them over the slice's device intervals (`trace.Slice.busy`): the
device idle while the host is inside a span of a kind, and the counters
that the op spans carry.  A program that records no spans (one without
`obs.trace.recorded`) gives every reader None.
"""

from __future__ import annotations

from hkvbench.trace import _union


def spans(run) -> list | None:
    """The program's spans that overlap the profiled slice's window, or
    None where the run has no slice or the program records no spans."""
    s = run.slice
    if s is None:
        return None
    try:
        from repro_torch.obs import trace
        recorded = trace.recorded
    except (ImportError, AttributeError):
        return None
    return [sp for sp in recorded() if sp.end_ns > s.t0 and sp.start_ns < s.t1]


def overlap_ns(xs: list, ys: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ns(run, keep) -> int | None:
    """Nanoseconds of the slice in which the host is inside a program span
    whose name `keep` accepts and no operation runs on the device; None
    where the program recorded no such span or the device ran nothing."""
    found = spans(run)
    s = run.slice
    if not found or not s.busy:
        return None
    inside = _union([(max(sp.start_ns, s.t0), min(sp.end_ns, s.t1))
                    for sp in found if keep(sp.name)])
    if not inside:
        return None
    return sum(b - a for a, b in inside) - overlap_ns(inside, s.busy)


def idle_ms_per_batch(run, keep) -> float | None:
    """`idle_ns` per profiled batch, in ms."""
    ns = idle_ns(run, keep)
    return ns / len(run.profiled) / 1e6 if ns is not None and run.profiled else None


def counted(run, names: tuple, counters: tuple) -> dict | None:
    """The sums of `counters` over the window's op spans named in `names`
    (read from the device here), or None where there are none."""
    found = [sp for sp in spans(run) or () if sp.name in names]
    if not found:
        return None
    totals = dict.fromkeys(counters, 0)
    for sp in found:
        c = sp.counters()
        for k in counters:
            totals[k] += c.get(k, 0)
    return totals
