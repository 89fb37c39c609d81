"""Checker: the telemetry seam (port of ``repro/analysis/telemetry.py``).

Every ``@roles.*``-annotated op entry point in ``repro_torch.core.ops``
either takes the optional keyword-only ``telemetry=`` sink or has an
exemption with its reason in ``core.ops.TELEMETRY_EXEMPT`` (the list the
port keeps beside its ops, the reference's entries).  A new op lands with
counters, or with a reviewed reason why counters mean nothing for it.

  missing-telemetry-seam   an annotated op with no ``telemetry`` keyword
                           and no exemption.
  stale-exemption          an exempted op that no longer exists, or that
                           has grown the seam.
"""

from __future__ import annotations

import inspect

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.roles import public_ops
from repro_torch.core import ops as ops_mod
from repro_torch.core import roles as roles_mod

CHECKER = "telemetry"
_OPS_PATH = "src/repro_torch/core/ops.py"


def _has_telemetry_seam(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins only
        return False
    p = params.get("telemetry")
    return p is not None and p.default is None


def check_telemetry(module=ops_mod, path: str = _OPS_PATH,
                    exempt: dict | None = None) -> list[Finding]:
    out = []
    if exempt is None:
        exempt = ops_mod.TELEMETRY_EXEMPT
    ops = public_ops(module)
    annotated = {n: fn for n, fn in ops.items() if roles_mod.role_of(fn) is not None}
    for name, fn in sorted(annotated.items()):
        if _has_telemetry_seam(fn) or name in exempt:
            continue
        try:
            line = inspect.getsourcelines(fn)[1]
        except OSError:  # pragma: no cover
            line = None
        out.append(Finding(
            CHECKER, "missing-telemetry-seam", name,
            "@roles-annotated op has neither a `telemetry=` keyword nor a TELEMETRY_EXEMPT "
            "entry: thread the seam (record via ops._obs() when `telemetry is not None`) or "
            "add a reviewed exemption to core.ops.TELEMETRY_EXEMPT", path=path, line=line))
    for name, why in sorted(exempt.items()):
        fn = ops.get(name)
        if fn is None:
            out.append(Finding(CHECKER, "stale-exemption", name,
                               f"TELEMETRY_EXEMPT lists an op that no longer exists (its "
                               f"reason was {why!r}): prune the entry", path=_OPS_PATH))
        elif _has_telemetry_seam(fn):
            out.append(Finding(CHECKER, "stale-exemption", name,
                               "TELEMETRY_EXEMPT lists an op that now takes the seam: prune "
                               "the entry so the list stays honest", path=_OPS_PATH))
    return out
