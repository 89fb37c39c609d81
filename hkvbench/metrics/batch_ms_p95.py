"""The 95th percentile of every batch's time in the window (a batch or a
training step, from the call into the port to the synchronize after it),
in ms; numpy's linear interpolation between order statistics."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.batch_ms), 95))
