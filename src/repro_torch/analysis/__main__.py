"""The port's lint CLI: ``python -m repro_torch.analysis``.

The exit status is the number of unwaived findings (at most 99), so CI can
gate on it directly.  ``--format github`` prints ``::error file=...``
workflow commands (PR annotations); ``--format text``, the default, one
line a finding and a summary.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="hkv-lint: static contract checks of the port")
    ap.add_argument("--format", choices=("text", "github"), default="text",
                    help="finding output format (github: workflow-command annotations)")
    ap.add_argument("--checker", action="append", metavar="NAME", choices=analysis.CHECKERS,
                    help="run only this checker (repeatable); default: all")
    args = ap.parse_args(argv)
    findings = analysis.run_all(only=args.checker)
    fmt = analysis.format_github if args.format == "github" else analysis.format_text
    out = fmt(findings)
    if out:
        print(out)
    return min(len(analysis.unwaived(findings)), 99)


if __name__ == "__main__":
    sys.exit(main())
