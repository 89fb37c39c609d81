"""The share of valid key lanes found in the hot tier, in %: the hot hits
over the lanes that the window's `tier.find_or_insert` spans counted
(found before the op), from the program's counters."""

from hkvbench import program


def read(run):
    c = program.counted(run, ("tier.find_or_insert",), ("hot_hits", "lanes"))
    return 100.0 * c["hot_hits"] / c["lanes"] if c and c["lanes"] else None
