"""The 95th percentile of a wave's time in the traced open-loop window,
from its dispatch to its results on the host (the engine's own
`WaveReport.latency_s`, host clock), over the waves retired before the
profiled slice, in ms; numpy's linear interpolation.  A wave is one
`find` call of the engine: this cell's counterpart of a closed-loop
cell's batch time."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.wave_ms), 95)) if run.wave_ms else None
