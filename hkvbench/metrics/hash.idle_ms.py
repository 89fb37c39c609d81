"""The device's idle time while the host is hashing keys (the `hash` span
of `core/find.py::probe_keys`: the hash pair, buckets and digest), per
profiled batch, in ms."""

from hkvbench import program


def read(run):
    return program.idle_ms_per_batch(run, lambda name: name == "hash")
