"""The share of the profiled slice in which no operation runs on the
device while the host is inside one of the program's spans (a table op,
the embedding's steps), in %: over the same window as `device_idle`, so
`device_idle - program_idle` is the idle the harness's own work leaves
(the traffic's draw, the batch's synchronize, between calls)."""

from hkvbench import program


def read(run):
    ns = program.idle_ns(run, lambda name: True)
    return 100.0 * ns / run.slice.window_ns if ns is not None else None
