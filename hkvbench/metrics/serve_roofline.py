"""`OnlineEmbeddingEngine`'s serving share of its roofline, in %: the least
time of the profiled requests' work (roofline/serve.py: `find`'s HBM bytes
of their keys, or the keys in and the rows out over the host link,
whichever is longer) over the device time of every operation that the
engine calls in the slice launched (`submit`, `step`, `poll`).  The slice
also carries waves of requests before and after the profiled ones, so the
share reads low, never high."""


def read(run):
    return run.roofline("serve", ("submit", "step", "poll"))
