"""The median of a request's time in the open-loop window, from when it
fell due to its answer unpacked on the host (queue-wait and service), over
every request due in the window, in ms; numpy's linear interpolation.  The
latency a user of a serving replica feels at the cell's offered rate."""

from hkvbench import open_loop


def read(run):
    return open_loop.tail(run, run.request_ms, 50.0)
