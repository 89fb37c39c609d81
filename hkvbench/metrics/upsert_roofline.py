"""`HKVTable.insert_or_assign`'s share of its roofline, in %: the least
time of the profiled batches' bytes (roofline/insert_or_assign.py) over
the device time of every operation that their spans launched."""


def read(run):
    return run.roofline("insert_or_assign", ("insert_or_assign",))
