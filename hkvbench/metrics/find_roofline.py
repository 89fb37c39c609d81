"""`HKVTable.find`'s share of its roofline, in %: the least time of the
profiled batches' bytes (roofline/find.py) over the device time of every
operation that their `find` spans launched."""


def read(run):
    return run.roofline("find", ("find",))
