"""The 99th percentile of a request's service in the traced open-loop
window: from the dispatch of the first wave that carries it to its
answer unpacked on the host (`t_admit` to `t_done`), over the requests
due before the profiled slice, in ms."""

from hkvbench import open_loop


def read(run):
    return open_loop.tail(run, run.service_ms)
