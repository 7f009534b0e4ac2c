"""Runner + CLI for the analysis pass: ``python -m repro_torch.analysis
[paths]`` (default: the port's own package directory).

Exit status is 0 when every finding is suppressed with a justified
``# repro: allow[RULE]`` comment (or there are none), 1 when any live
violation remains, 2 on usage errors. ``--json`` emits machine output;
``--bench PATH`` records per-rule violation counts as a ``bench.v1``
record via :mod:`repro_torch.obs.bench` (the reference's metric names,
ratchet flags and ``meta`` keys).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from .base import Checker, FileContext, Violation
from .host_sync import HostSyncChecker
from .kernel_routing import KernelRoutingChecker
from .locks import LockDisciplineChecker
from .plan_leaves import PlanLeafChecker
from .recompile import RecompileChecker

CHECKERS: tuple[Checker, ...] = (HostSyncChecker(), RecompileChecker(),
                                 LockDisciplineChecker(), PlanLeafChecker(),
                                 KernelRoutingChecker())
RULES = tuple(c.rule for c in CHECKERS)
PACKAGE_DIR = str(Path(__file__).resolve().parents[1])

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def collect_targets(paths: Sequence[str]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(
                f for f in path.rglob("*.py")
                if not _SKIP_DIRS & set(part.name for part in f.parents)))
        elif path.suffix == ".py":
            out.append(path)
        else:
            raise FileNotFoundError(f"not a .py file or directory: {p}")
    return out


class Report:
    """All findings of one run, plus the counts the CLI/bench emit."""

    def __init__(self, violations: list[Violation], files: int,
                 rules: Sequence[str] = RULES):
        self.violations = violations
        self.files = files
        self.rules = tuple(rules)

    @property
    def active(self) -> list[Violation]:
        return [v for v in self.violations if not v.allowed]

    @property
    def allowed(self) -> list[Violation]:
        return [v for v in self.violations if v.allowed]

    @property
    def exit_code(self) -> int:
        return 1 if self.active else 0

    def counts(self, allowed: bool = False) -> dict:
        pool = self.allowed if allowed else self.active
        out = {r: 0 for r in self.rules}
        for v in pool:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def human(self) -> str:
        lines = [v.format() for v in sorted(
            self.violations, key=lambda v: (v.path, v.line, v.col, v.rule))]
        act, alw = len(self.active), len(self.allowed)
        lines.append(f"{self.files} file(s) analyzed: {act} violation(s), "
                     f"{alw} allowed")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"files": self.files,
                "violations": [v.to_dict() for v in self.violations],
                "counts": self.counts(),
                "allowed_counts": self.counts(allowed=True)}


def analyze(paths: Sequence[str],
            rules: Optional[Sequence[str]] = None) -> Report:
    """Run the checkers over ``paths`` (files or directories)."""
    targets = collect_targets(paths)
    ctxs = [FileContext.from_path(p) for p in targets]
    violations: list[Violation] = []
    for ctx in ctxs:
        if ctx.error is not None:
            violations.append(Violation(
                "RL000", ctx.path, ctx.error.lineno or 0, 0,
                f"syntax error: {ctx.error.msg}"))
    active = [c for c in CHECKERS if rules is None or c.rule in rules]
    for checker in active:
        violations.extend(checker.check(ctxs))
    return Report(violations, len(ctxs),
                  rules=[c.rule for c in active] or RULES)


def write_bench(report: Report, path: str, targets: Sequence[str]) -> None:
    from repro_torch.obs import bench
    metrics = {}
    for rule, n in report.counts().items():
        metrics[f"static.{rule}.violations"] = bench.metric(
            n, unit="violations", direction="lower", ratchet=True, tol=0.0)
    for rule, n in report.counts(allowed=True).items():
        metrics[f"static.{rule}.allowed"] = bench.metric(
            n, unit="sites", direction="lower", ratchet=False)
    metrics["static.files"] = bench.metric(
        report.files, unit="files", direction="higher", ratchet=False)
    # the envelope of bench.record without its device meta: the pass reads
    # source on no device, and so imports no torch
    bench.write(path, {"schema": bench.SCHEMA, "name": "static_analysis",
                       "created": time.time(),
                       "meta": {"targets": list(targets),
                                "rules": list(report.rules)},
                       "metrics": metrics})


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the PyTorch port's static analysis "
                    "(RL001 host-sync, RL002 rebuild-hazard, "
                    "RL003 lock-discipline, RL004 plan-leaf, "
                    "RL005 kernel-routing)")
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files or directories (default: the repro_torch "
                         "package directory)")
    ap.add_argument("--rules", help="comma-separated rule subset "
                                    f"(of {', '.join(RULES)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--bench", metavar="PATH",
                    help="also write a bench.v1 record of per-rule counts")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for c in CHECKERS:
            print(f"{c.rule}  {c.title}")
        return 0
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = set(rules) - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
    try:
        report = analyze(args.paths, rules=rules)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.bench:
        write_bench(report, args.bench, args.paths)
    print(json.dumps(report.to_json(), indent=2) if args.as_json
          else report.human())
    return report.exit_code
