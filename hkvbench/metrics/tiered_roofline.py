"""The tier hierarchy's training step's share of its roofline, in %: the
least time of the profiled steps' work (roofline/tiered_step.py: HBM bytes
over the HBM rate, or the rows over the host link, whichever is longer)
over the device time of every operation that their `lookup_train` and
`apply_grads` spans launched."""


def read(run):
    return run.roofline("tiered_step", ("lookup_train", "apply_grads"))
