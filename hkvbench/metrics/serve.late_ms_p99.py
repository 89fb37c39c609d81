"""The 99th percentile of how late the open loop handed a request to the
engine (submitted less due) in the traced window, over the requests due
before the profiled slice, in ms.  The loop is one thread: a query that
falls due while the engine's `step()` holds it waits for the step, so a
reading near a wave's time is the engine's, one far above it the
harness's."""

from hkvbench import open_loop


def read(run):
    return open_loop.tail(run, run.late_ms)
