"""The finding model, waivers and output formats of the port's lint
(port of ``repro/analysis/findings.py``).

A Finding is one contract violation, located as precisely as the checker
can (a repository-relative path and line where there is one, else the
subject's name).  Findings are data; policy (exit status, display) lives in
the CLI.

Waivers are in the code and carry their reason: a finding a checker cannot
be satisfied on, for a legitimate reason, gets an entry in ``WAIVERS``
below, and is reported as waived (shown, not fatal).  An empty waiver list
is the healthy state.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Iterable, Optional

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Finding:
    checker: str                     # kernel-parity | roles | oracle-coupling | telemetry
    rule: str                        # short machine id, e.g. "unbound-kernel"
    subject: str                     # the kernel, op or file the finding is about
    message: str                     # what is wrong, with the contract
    path: Optional[str] = None       # repository-relative file
    line: Optional[int] = None       # 1-indexed
    severity: str = ERROR
    waived: bool = False
    waiver_reason: Optional[str] = None

    def location(self) -> str:
        if self.path and self.line:
            return f"{self.path}:{self.line}"
        return self.path or self.subject


@dataclasses.dataclass(frozen=True)
class Waiver:
    """An explicit, justified exemption.  `subject` may be a glob."""

    checker: str
    rule: str
    subject: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.checker == f.checker and self.rule == f.rule
                and fnmatch.fnmatch(f.subject, self.subject))


# The shipped tree is clean: no waivers.  To waive a finding, add
#   Waiver("<checker>", "<rule>", "<subject-glob>", "why this is OK"),
# here; the reason is shown beside the finding in every report.
WAIVERS: tuple[Waiver, ...] = ()


def apply_waivers(findings: Iterable[Finding],
                  waivers: Iterable[Waiver] = WAIVERS) -> list[Finding]:
    out = []
    waivers = list(waivers)
    for f in findings:
        for w in waivers:
            if w.matches(f):
                f = dataclasses.replace(f, waived=True, waiver_reason=w.reason)
                break
        out.append(f)
    return out


def unwaived(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if not f.waived and f.severity == ERROR]


def format_text(findings: list[Finding]) -> str:
    """One line a finding and a summary line (always present)."""
    lines = []
    for f in findings:
        tag = f"[{f.checker}/{f.rule}]"
        waive = f" (WAIVED: {f.waiver_reason})" if f.waived else ""
        lines.append(f"{f.location()}: {f.severity}: {tag} {f.subject}: {f.message}{waive}")
    fatal = len(unwaived(findings))
    waived_n = sum(1 for f in findings if f.waived)
    lines.append(f"hkv-lint: {len(findings)} finding(s), {fatal} fatal, {waived_n} waived")
    return "\n".join(lines)


def format_github(findings: list[Finding]) -> str:
    """GitHub Actions workflow-command annotations (::error / ::warning)."""
    lines = []
    for f in findings:
        level = "warning" if (f.waived or f.severity == WARNING) else "error"
        loc = ""
        if f.path:
            loc = f" file={f.path}"
            if f.line:
                loc += f",line={f.line}"
        msg = f.message
        if f.waived:
            msg += f" (waived: {f.waiver_reason})"
        # a workflow command ends at a newline; escape as its spec says
        msg = msg.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
        lines.append(f"::{level}{loc},title={f.checker}/{f.rule}::{f.subject}: {msg}")
    return "\n".join(lines)
