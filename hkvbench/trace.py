"""Reading a `torch.profiler` slice: the benchmark's spans and the device's
operations on one clock, and what the per-layer metrics take from them.

The harness opens a span around each entry into the program and around
the traffic draw.  Inside the profiled slice a span has no synchronize of
its own: the slice runs as the untraced window does, with one synchronize
after each batch.  A device operation belongs to the span that was open
on the host when its launch was issued, matched through the profiler's
correlation id of the launch and the operation (by the operation's own
start where a launch is not in the trace).  A span is a `record_function`
named "hkvbench.<span>"; its copy on the device's timeline is no work of
its own and is left out.
"""

from __future__ import annotations

import collections

PREFIX = "hkvbench."


class Slice:
    """The spans and device intervals of one profiled slice (ns)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.spans, device, launched = [], [], {}
        for e in prof.profiler.kineto_results.events():
            name, t0 = e.name(), e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(PREFIX):
                    device.append((name, t0, t1, e.correlation_id()))
            elif name.startswith(PREFIX):
                self.spans.append((name[len(PREFIX):], t0, t1))
            elif name.startswith("cu") and e.correlation_id():
                launched[e.correlation_id()] = t0       # the runtime call that launched it
        self.spans.sort(key=lambda s: s[1])
        self.device = sorted(device, key=lambda d: d[1])
        # each device operation's span, by the host time of its launch
        self.of = [self._open_at(launched.get(c, a)) for _, a, _, c in self.device]
        self.by_launch = sum(c in launched for *_, c in self.device)
        self.t0 = self.spans[0][1] if self.spans else 0
        self.t1 = max([s[2] for s in self.spans] + [d[2] for d in self.device], default=0)
        self.busy = _union([(a, b) for _, a, b, _ in self.device])

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    def busy_ns(self, t0: int, t1: int) -> int:
        """Nanoseconds in [t0, t1] in which some operation ran on the device."""
        return sum(max(0, min(b, t1) - max(a, t0)) for a, b in self.busy)

    def span_device_ns(self, names) -> int:
        """Device time of the operations that spans of the given names
        launched (their intervals' union)."""
        mine = [(a, b) for (_, a, b, _), n in zip(self.device, self.of) if n in names]
        return sum(b - a for a, b in _union(mine))

    def top_ops(self, k: int = 10) -> list:
        by = collections.Counter()
        for name, a, b, _ in self.device:
            by[name[:160]] += b - a
        return [[n, ns / 1e9] for n, ns in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The `k` longest idle stretches of the slice, each named by the
        span open on the host when it began."""
        gaps, t = [], self.t0
        for a, b in self.busy + [(self.t1, self.t1)]:
            if a > t:
                gaps.append((t, min(a, self.t1)))
            t = max(t, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._open_at(a), (b - a) / 1e9] for a, b in gaps[:k] if b > a]

    def _open_at(self, t: int) -> str:
        for name, a, b in self.spans:
            if a <= t < b:
                return name
        return "between spans"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
