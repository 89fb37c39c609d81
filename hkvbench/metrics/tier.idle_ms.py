"""The device's idle time while the host is inside the hierarchy's own
work (`core/tiered.py`'s `tier.cold_probe`, `tier.displaced` and
`tier.demote` spans: the cold probe, the demotion batch and the cold
tier's upsert), per profiled step, in ms."""

from hkvbench import program

STAGES = ("tier.cold_probe", "tier.displaced", "tier.demote")


def read(run):
    return program.idle_ms_per_batch(run, lambda name: name in STAGES)
