"""`trtpu check` for the port (the port's copy of
``transferia_tpu/analysis/cli.py``): the port's lint over its own tree.

Exit codes:
  0 — no new (non-baselined) findings
  1 — new findings and --strict
  2 — unusable invocation (bad path, bad rule id)

Without --strict the command always exits 0 so it can run as an
informational step; `python -m transferia_tpu_torch.cli.main check
--strict` is the port's fast pre-test gate (no device, no compile).

Paths are relative to the directory holding `transferia_tpu_torch`,
the default path is that package, and the baseline is the port's own
`.trtpu-torch-baseline.json` there; the JAX package's
`.trtpu-baseline.json` is neither read nor written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from transferia_tpu_torch.analysis import baseline as baseline_mod
from transferia_tpu_torch.analysis.engine import format_human, run_rules
from transferia_tpu_torch.analysis.rules import default_rules

DEFAULT_PATH = "transferia_tpu_torch"


def repo_root() -> str:
    """The directory holding the `transferia_tpu_torch` package (baseline
    and reported paths are relative to it)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def add_check_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*", default=[],
                   help="files/dirs to analyze "
                        "(default: the transferia_tpu_torch/ tree)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any new (non-baselined) finding")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: "
                        f"{baseline_mod.DEFAULT_BASELINE} at the repo "
                        f"root; 'none' disables)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to accept all current "
                        "findings")
    p.add_argument("--rules", default="",
                   help="comma-separated rule ids to run "
                        "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule set and exit")


def run_check(args) -> int:
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            scope = " [" + ", ".join(r.paths) + "]" if r.paths else ""
            print(f"{r.id} ({r.severity}){scope}: {r.description}")
        return 0
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")
                  if r.strip()}
        known = {r.id for r in rules}
        unknown = wanted - known
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}; "
                  f"known: {', '.join(sorted(known))}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    root = repo_root()
    paths = args.paths or [DEFAULT_PATH]
    for p in paths:
        abs_p = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(abs_p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2
    result = run_rules(paths, rules, root=root)

    baseline_path: Optional[str] = None
    if args.baseline != "none":
        baseline_path = args.baseline or os.path.join(
            root, baseline_mod.DEFAULT_BASELINE)
    if args.update_baseline:
        if baseline_path is None:
            print("--update-baseline requires a baseline file",
                  file=sys.stderr)
            return 2
        if args.paths or args.rules:
            # a narrowed run only sees a subset of findings; saving it
            # would silently drop every other tree's baselined entry
            print("--update-baseline requires a full run (no explicit "
                  "paths or --rules)", file=sys.stderr)
            return 2
        n = baseline_mod.save(baseline_path, result.findings)
        print(f"baseline: {n} finding(s) -> {baseline_path}")
        return 0
    known = baseline_mod.load(baseline_path) if baseline_path else set()
    new, old = baseline_mod.split(result.findings, known)

    if args.as_json:
        print(json.dumps({
            "files_checked": result.files_checked,
            "new": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in old],
            "parse_errors": [f.to_json() for f in result.parse_errors],
        }, indent=1))
    else:
        print(format_human(result, new, len(old)))
        dead = baseline_mod.stale(result.findings, known)
        if dead:
            print(f"note: {len(dead)} baseline entr"
                  f"{'y is' if len(dead) == 1 else 'ies are'} stale "
                  f"(fixed findings) — rerun with --update-baseline")
    failed = bool(new or result.parse_errors)
    return 1 if (args.strict and failed) else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="trtpu-check",
        description="framework-aware static analysis of the "
                    "transferia_tpu_torch tree")
    add_check_args(p)
    return run_check(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
