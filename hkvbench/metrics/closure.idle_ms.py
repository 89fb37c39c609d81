"""The device's idle time while the host is inside a stage of the upsert
closure (a `closure.*` span of `core/merge.py::upsert`), per profiled
batch, in ms."""

from hkvbench import program


def read(run):
    return program.idle_ms_per_batch(run, lambda name: name.startswith("closure."))
