"""The 95th percentile of every find batch's time in the traced run's
window (from the call into the port to the synchronize after it), the
profiled slice's batches left out, in ms; numpy's linear interpolation.

The find cell's `batch_ms_p95`, read per layer: the op is host-bound, and
on the shared host's clock its tail spread between processes by more than
any bound on it allows (PERF.md)."""

import numpy as np


def read(run):
    warm, skip = run.cell.work["warmup_batches"], set(run.profiled)
    ms = [t for k, t in enumerate(run.batch_ms) if k + warm not in skip]
    return float(np.percentile(np.asarray(ms), 95)) if ms else None
