"""Op-role annotations: the paper's §3.5 role taxonomy, machine-readable
(the port's copy of ``repro/core/roles.py``).

  reader    pure probes: commute with each other and with updaters on
            disjoint or identical key sets; never move keys between slots.
  updater   in-place changes of located entries (values, scores): keys
            keep their (bucket, slot), so a locate taken before the op is
            still valid after it.
  inserter  ops that create, move or destroy entries: serialization
            points; any locate taken before an inserter is invalid after.

``OpSession`` shares one locate across a run of commuting ops and fences
at inserters by these roles, and every public op of ``core.ops`` carries
one of the annotations; the telemetry seam's contract (every annotated op
takes ``telemetry=`` or is exempt, ``core.ops.TELEMETRY_EXEMPT``) is
stated over them.
"""

from __future__ import annotations

from typing import Callable, Optional, TypeVar

READER = "reader"
UPDATER = "updater"
INSERTER = "inserter"
ROLES = (READER, UPDATER, INSERTER)

_ATTR = "__hkv_role__"

F = TypeVar("F", bound=Callable)


def role(name: str) -> Callable[[F], F]:
    """Decorator declaring an op entry point's role.  Metadata only: the
    function is returned as it is, not wrapped."""
    if name not in ROLES:
        raise ValueError(f"unknown op role {name!r}; expected one of {ROLES}")

    def mark(fn: F) -> F:
        setattr(fn, _ATTR, name)
        return fn

    return mark


def reader(fn: F) -> F:
    return role(READER)(fn)


def updater(fn: F) -> F:
    return role(UPDATER)(fn)


def inserter(fn: F) -> F:
    return role(INSERTER)(fn)


def role_of(fn) -> Optional[str]:
    """The declared role of an op entry point, or None if unannotated.
    Sees through ``functools.partial`` and wrappers exposing
    ``__wrapped__`` or ``func``."""
    seen = 0
    while fn is not None and seen < 8:
        r = getattr(fn, _ATTR, None)
        if r is not None:
            return r
        fn = getattr(fn, "__wrapped__", None) or getattr(fn, "func", None)
        seen += 1
    return None
