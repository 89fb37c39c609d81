"""The 99th percentile of a request's time in the traced open-loop window,
from when it fell due to its answer unpacked on the host (queue-wait and
service), over the requests due before the profiled slice, in ms; numpy's
linear interpolation.  A per-layer reading: between processes it spreads
by more than any bound on an end-to-end metric may allow (PERF.md)."""

from hkvbench import open_loop


def read(run):
    return open_loop.tail(run, run.request_ms)
