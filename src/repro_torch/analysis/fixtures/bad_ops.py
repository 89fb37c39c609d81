"""Fixture: an op entry point with no declared §3.5 role.

``roles.check_annotations`` pointed at this module must flag
``mystery_op`` with rule ``unannotated-op`` (and not ``annotated_op``).
"""

from __future__ import annotations

from repro_torch.core import roles


def mystery_op(state, cfg, keys):
    """BUG: no @roles.* annotation, so its commutativity class is undeclared."""
    return state


@roles.reader
def annotated_op(state, cfg, keys):
    """Annotated (the roles control case), but a BUG for the telemetry
    lint: no ``telemetry=`` seam and no exemption."""
    return keys


@roles.reader
def telemetered_op(state, cfg, keys, *, telemetry=None):
    """Takes the telemetry seam: the telemetry lint's control case."""
    return keys


def _private_helper(state, cfg):
    """Its name starts with an underscore: out of the lint's scope."""
    return state


def free_function(cfg, keys):
    """No leading ``state`` parameter: not an op entry point."""
    return keys
