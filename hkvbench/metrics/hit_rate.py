"""The share of valid key lanes found resident, in %: the hits over the
lanes that the window's `op.find` and `op.find_or_insert` spans counted
(find_or_insert: found before the op), from the program's counters."""

from hkvbench import program


def read(run):
    c = program.counted(run, ("op.find", "op.find_or_insert"), ("hits", "lanes"))
    return 100.0 * c["hits"] / c["lanes"] if c and c["lanes"] else None
