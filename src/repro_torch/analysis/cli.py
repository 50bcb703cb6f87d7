"""simlint command line for the port.

Usage (repo root):

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --report simlint-torch-report.json

Exit status: 0 when no *active* (unsuppressed, unbaselined) findings and
no stale baseline entries; 1 otherwise; 2 on usage/baseline errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.core import (
    DEFAULT_BASELINE_NAME,
    Baseline,
    LintReport,
    find_repo_root,
    iter_py_files,
    make_baseline,
    run_paths,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simlint",
        description="repo-specific invariant checker for the PyTorch "
                    "port (RNG discipline, host/device boundaries, purity "
                    "under torch.func and autograd Functions, obs "
                    "read-only)")
    p.add_argument("paths", nargs="*", type=Path,
                   help="files or directories to lint")
    p.add_argument("--select", metavar="CODES",
                   help="comma-separated rule codes to run (default all)")
    p.add_argument("--baseline", type=Path, default=None,
                   help=f"baseline JSON (default <repo>/"
                        f"{DEFAULT_BASELINE_NAME} when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather all active findings into the "
                        "baseline file (justifications start as TODO)")
    p.add_argument("--report", type=Path, default=None,
                   help="write a JSON diagnostic report here")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print the summary line")
    return p


def _print_rules() -> None:
    from repro_torch.analysis.rules import REGISTRY
    for r in REGISTRY:
        print(f"{r.code}  {r.name}")
        print(f"        {r.doc}")


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        _print_rules()
        return 0
    if not args.paths:
        _parser().error("the following arguments are required: paths")

    repo_root = find_repo_root(args.paths[0])
    baseline_path = args.baseline or repo_root / DEFAULT_BASELINE_NAME
    baseline = None
    if not args.no_baseline and not args.write_baseline \
            and baseline_path.exists():
        try:
            baseline = Baseline.load(baseline_path)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"simlint: bad baseline: {e}", file=sys.stderr)
            return 2

    select = ([c.strip().upper() for c in args.select.split(",")]
              if args.select else None)
    report = run_paths(args.paths, repo_root=repo_root,
                       baseline=baseline, select=select)

    if args.write_baseline:
        lines_of = {}
        for f in iter_py_files(args.paths):
            try:
                rel = f.resolve().relative_to(repo_root).as_posix()
            except ValueError:
                rel = f.as_posix()
            lines_of[rel] = f.read_text().splitlines()
        make_baseline(report, lines_of).save(baseline_path)
        print(f"simlint: wrote {len(report.active)} entries to "
              f"{baseline_path}; fill in every 'why' before committing")
        return 0

    return _emit(report, args)


def _emit(report: LintReport, args) -> int:
    active = report.active
    if not args.quiet:
        for f in active:
            print(f.render())
        for e in report.errors:
            print(f"simlint: error: {e}", file=sys.stderr)
        for entry in report.stale_baseline:
            print(f"simlint: stale baseline entry: {entry.file} "
                  f"{entry.code} ({entry.match!r}) — prune it",
                  file=sys.stderr)

    if args.report is not None:
        args.report.write_text(
            json.dumps(report.to_json(), indent=2) + "\n")

    n_sup = sum(1 for f in report.findings if f.status == "suppressed")
    n_base = sum(1 for f in report.findings if f.status == "baselined")
    print(f"simlint: {len(active)} active, {n_sup} suppressed, "
          f"{n_base} baselined, {len(report.stale_baseline)} stale "
          f"baseline entries")
    bad = bool(active) or bool(report.stale_baseline) \
        or bool(report.errors)
    return 1 if bad else 0


if __name__ == "__main__":       # pragma: no cover
    sys.exit(main())
