"""hkv-lint for the port: static contract checks of ``repro_torch`` (port
of ``repro/analysis``).  Four checkers, one finding model:

  kernel-parity      every ``extern "C"`` kernel entry in
                     ``repro_torch/csrc/*.cu`` has a wrapper in
                     ``repro_torch/kernels/`` that launches it, a plain
                     PyTorch version of the same function beside it, a
                     ``cuda``-marked test holding one against the other,
                     and a place in ``chip_smoke.py``'s kernel list.  It
                     stands where the reference's ``kernel-contracts`` and
                     kernel registry walk Pallas jaxprs, which have no
                     counterpart in CUDA C++.
  roles              the §3.5 role taxonomy: every op annotated reader,
                     updater or inserter, the session records the same
                     roles, ``_plan()`` fences and fuses by them, and the
                     serving engine's readonly, non-promoting waves are
                     pure readers.
  oracle-coupling    one key-match formula (``core.find.match_lanes``) and
                     one liveness formula (``core.u64.empty_lanes``), each
                     reached from every plain version that needs it; inline
                     re-derivations are findings.
  telemetry          every ``@roles.*`` op takes ``telemetry=`` or has a
                     reviewed exemption (``core.ops.TELEMETRY_EXEMPT``).

Two of the reference's checks have no counterpart: ``compile-cache``
audits XLA recompiles, and the port has no jit; ``kernel-contracts``'
hmem-seam rule (no kernel touches the host plane) is reversed by design,
as the port's row kernels read and write the pinned plane over the host
link.  The probes of ``roles`` run on the CPU: a lint checks the code, not
the card.

Run with ``python -m repro_torch.analysis`` (add ``--format github`` in CI).
"""

from __future__ import annotations

from repro_torch.analysis.findings import (WAIVERS, Finding, apply_waivers, format_github,
                                           format_text, unwaived)

__all__ = ["CHECKERS", "Finding", "WAIVERS", "apply_waivers", "format_github", "format_text",
           "run_all", "unwaived"]

CHECKERS = ("kernel-parity", "roles", "oracle-coupling", "telemetry")


def _checkers() -> dict:
    from repro_torch.analysis.kernel_parity import check_kernel_parity
    from repro_torch.analysis.oracle_coupling import check_oracle_coupling
    from repro_torch.analysis.roles import check_roles
    from repro_torch.analysis.telemetry import check_telemetry

    return {"kernel-parity": check_kernel_parity, "roles": check_roles,
            "oracle-coupling": check_oracle_coupling, "telemetry": check_telemetry}


def run_all(only=None) -> list:
    """Run the checkers (all, or the named ones) and apply the waivers."""
    table = _checkers()
    names = list(only) if only else list(CHECKERS)
    findings = []
    for name in names:
        if name not in table:
            raise SystemExit(f"unknown checker {name!r}; choose from {', '.join(CHECKERS)}")
        findings.extend(table[name]())
    return apply_waivers(findings, WAIVERS)
