"""The mean time of an `HKVEmbedding.apply_grads` call in the traced run's
window, outside the profiled slice, from the benchmark's span (a
synchronize at each end), in ms."""


def read(run):
    ms = run.span_ms.get("apply_grads")
    return sum(ms) / len(ms) if ms else None
