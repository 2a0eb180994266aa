"""CLI for the invariant checker — the CI gate's entry point.

Usage::

    python -m repro_torch.analysis check [PATH ...] [--only RULE,...]
                                   [--baseline FILE | --no-baseline]
                                   [--format text|json]
    python -m repro_torch.analysis baseline [PATH ...] [--baseline FILE]
    python -m repro_torch.analysis rules

Exit codes: 0 clean, 1 findings outside the baseline, 2 usage error
(unknown rule id, unreadable baseline). ``check`` with no paths scans
``src/repro_torch chip_smoke.py tools`` (tests are opt-in; see
engine.py).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_io
from repro_torch.analysis.engine import (DEFAULT_ROOTS, analyze_paths,
                                         summarize)
from repro_torch.core.selectors import SelectorError


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant checker: fork safety, lock "
                    "discipline, device hygiene, exception and "
                    "schema/trace discipline.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p: argparse.ArgumentParser) -> None:
        p.add_argument("paths", nargs="*", metavar="PATH",
                       help=f"files/dirs to scan (default: "
                            f"{' '.join(DEFAULT_ROOTS)})")
        p.add_argument("--only", action="append", metavar="RULE,...",
                       help="run only these rule ids (comma-separated, "
                            "repeatable); unknown ids are an error")
        p.add_argument("--root", default=".",
                       help="repo root paths are relative to")
        p.add_argument("--baseline", default=baseline_io.DEFAULT_BASELINE,
                       metavar="FILE",
                       help="baseline file of grandfathered findings "
                            "(default: %(default)s)")

    p_check = sub.add_parser("check", help="scan and fail on findings")
    common(p_check)
    p_check.add_argument("--no-baseline", action="store_true",
                         help="ignore the baseline: every finding fails")
    p_check.add_argument("--format", choices=("text", "json"),
                         default="text")

    p_base = sub.add_parser(
        "baseline", help="rewrite the baseline from the current tree")
    common(p_base)

    sub.add_parser("rules", help="list the rule catalog")
    return ap


def _cmd_check(args: argparse.Namespace) -> int:
    findings = analyze_paths(args.paths or None, root=args.root,
                             only=args.only)
    known = set() if args.no_baseline else \
        baseline_io.load_baseline(args.baseline)
    new = baseline_io.partition(findings, known)
    grandfathered = len(findings) - len(new)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_json() for f in new],
                          "grandfathered": grandfathered}, indent=2))
        return 1 if new else 0
    for f in new:
        print(f.render())
    if new:
        counts = ", ".join(f"{r}: {n}"
                           for r, n in summarize(new).items())
        print(f"\n{len(new)} finding(s) [{counts}]"
              + (f" (+{grandfathered} baselined)" if grandfathered
                 else ""))
        print("fix, suppress with `# repro: ignore[rule-id] -- why`, "
              "or re-baseline deliberately")
        return 1
    extra = f" ({grandfathered} baselined)" if grandfathered else ""
    print(f"analysis clean{extra}")
    return 0


def _cmd_baseline(args: argparse.Namespace) -> int:
    findings = analyze_paths(args.paths or None, root=args.root,
                             only=args.only)
    baseline_io.write_baseline(args.baseline, findings)
    print(f"wrote {len(findings)} finding(s) to {args.baseline}")
    return 0


def _cmd_rules() -> int:
    from repro_torch.analysis.rules import RULES
    for rule_id, cls in sorted(RULES.items()):
        print(f"{rule_id}\n    {cls.summary}\n    why: {cls.motivation}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.cmd == "check":
            return _cmd_check(args)
        if args.cmd == "baseline":
            return _cmd_baseline(args)
        return _cmd_rules()
    except SelectorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:                 # unreadable baseline file
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
