"""The share of the profiled slice in which no operation runs on the
device, in %: one minus the union of the device's intervals over the slice
(from the first span's start to the last span's end)."""


def read(run):
    s = run.slice
    busy = s.busy_ns(s.t0, s.t1) if s is not None else 0
    return 100.0 * (1.0 - busy / s.window_ns) if busy > 0 else None
