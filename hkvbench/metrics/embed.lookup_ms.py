"""The mean time of an `HKVEmbedding.lookup_train` call in the traced run's
window, outside the profiled slice, from the benchmark's span (a
synchronize at each end), in ms."""


def read(run):
    ms = run.span_ms.get("lookup_train")
    return sum(ms) / len(ms) if ms else None
