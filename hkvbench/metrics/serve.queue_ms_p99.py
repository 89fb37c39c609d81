"""The 99th percentile of a request's queue-wait in the traced open-loop
window: from when it fell due to the dispatch of the first wave that
carries it (`EmbeddingRequest.t_admit`), the wait to be handed to the
engine included, over the requests due before the profiled slice, in ms."""

from hkvbench import open_loop


def read(run):
    return open_loop.tail(run, run.queue_ms)
