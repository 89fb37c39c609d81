"""Maintenance: whole-table observability (``stats``).  The rebalance and
the scheduler of the reference's ``repro.maintenance`` are not ported yet."""
