"""torchlint CLI (port of ``repro/analysis/lint.py``)::

    python -m repro_torch.analysis.lint src/repro_torch \
        --baseline src/repro_torch/analysis/baseline.json

Exit codes: 0 = clean (all findings accepted by the baseline), 1 = new
findings, 2 = bad arguments / unreadable baseline / syntax error in a
target file. Stdlib only: runs in an interpreter without torch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .findings import Finding, load_baseline, write_baseline
from .passes import ALL_CODES, ModuleContext, run_passes


def iter_py_files(paths: List[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.is_file():
            out.append(path)
        else:
            raise FileNotFoundError(p)
    return out


def lint_paths(
    paths: List[str], select: Optional[List[str]] = None
) -> List[Finding]:
    """Run the selected passes over every .py file under `paths`."""
    findings: List[Finding] = []
    for file in iter_py_files(paths):
        source = file.read_text()
        ctx = ModuleContext.parse(file.as_posix(), source)
        findings.extend(run_passes(ctx, select))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static analysis of the port's serving tick.",
    )
    parser.add_argument("paths", nargs="+", help="files or directories to lint")
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help="accepted-findings JSON; matched findings don't fail the run",
    )
    parser.add_argument(
        "--select",
        default=None,
        help="comma-separated codes to run (default: all of %s)"
        % ",".join(ALL_CODES),
    )
    parser.add_argument(
        "--write-baseline",
        type=Path,
        default=None,
        metavar="FILE",
        help="write every current finding to FILE as the new baseline and "
        "exit 0",
    )
    parser.add_argument(
        "--reason",
        default="accepted at baseline creation",
        help="reason recorded for entries written by --write-baseline",
    )
    parser.add_argument(
        "--quiet", action="store_true", help="suppress accepted-findings note"
    )
    args = parser.parse_args(argv)

    select = None
    if args.select:
        select = [c.strip().upper() for c in args.select.split(",") if c.strip()]
        bad = [c for c in select if c not in ALL_CODES]
        if bad:
            print(f"error: unknown code(s) {bad}; known: {list(ALL_CODES)}",
                  file=sys.stderr)
            return 2

    try:
        findings = lint_paths(args.paths, select)
    except FileNotFoundError as e:
        print(f"error: no such path: {e}", file=sys.stderr)
        return 2
    except SyntaxError as e:
        print(f"error: {e.filename}:{e.lineno}: syntax error: {e.msg}",
              file=sys.stderr)
        return 2

    if args.write_baseline is not None:
        write_baseline(findings, args.write_baseline, reason=args.reason)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    accepted: List[Finding] = []
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot load baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        new, accepted = baseline.split(findings)
    else:
        new = findings

    for f in new:
        print(f.render())
    if accepted and not args.quiet:
        print(f"note: {len(accepted)} finding(s) accepted by baseline")
    if new:
        print(f"{len(new)} new finding(s)")
        return 1
    print("clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
