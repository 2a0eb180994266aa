"""The analysis engine: file discovery, parsing, suppression, dispatch.

One ``Module`` per source file carries everything a rule needs — the
AST, a child->parent map (``ast`` has no parent links), raw source
lines, and the parsed ``# repro: ignore[...]`` suppressions. Rules are
``ast.NodeVisitor`` subclasses (see ``rules.base``); the engine
instantiates each rule fresh per module, collects findings, and drops
any finding whose line carries a matching suppression.

Suppression grammar (mirrors ``noqa`` so it reads familiar)::

    self.skips = state          # repro: ignore[lock-unguarded-write] -- why
    # repro: ignore[except-swallow] -- best-effort probe, failure is data
    except Exception:

An inline comment covers its own line; a standalone comment line covers
the next line. Multiple rule ids separate with commas. Everything after
``--`` is the human justification (required by convention, not parsed).

Baseline identity is ``path::rule::message`` — deliberately *not* the
line number, so grandfathered findings survive unrelated edits above
them instead of churning the baseline file on every diff.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

#: Checked by default: the port, its card smoke run, and the tools.
#: Tests are excluded by design — they intentionally hold locks wrong,
#: swallow exceptions, and build malformed records to prove the system
#: rejects them; run ``check tests`` explicitly to audit them anyway.
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py", "tools")

#: Rule id assigned to files the engine cannot parse at all.
PARSE_ERROR = "parse-error"

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*ignore\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str              # repo-relative, '/'-separated
    line: int              # 1-based
    col: int               # 0-based (ast convention)
    message: str

    @property
    def key(self) -> str:
        """Baseline identity: stable across pure line moves."""
        return f"{self.path}::{self.rule}::{self.message}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule}: {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Line number (1-based) -> rule ids suppressed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {t.strip() for t in m.group(1).split(",") if t.strip()}
        if not rules:
            continue
        out.setdefault(i, set()).update(rules)
        if line.lstrip().startswith("#"):
            # a standalone suppression comment covers the line below it
            out.setdefault(i + 1, set()).update(rules)
    return out


class Module:
    """One parsed source file plus the indexes rules share."""

    def __init__(self, rel_path: str, source: str):
        self.path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel_path)
        self.suppressions = parse_suppressions(self.lines)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def suppressed(self, finding: Finding) -> bool:
        return finding.rule in self.suppressions.get(finding.line, ())


def iter_python_files(paths: Sequence[str], *,
                      root: str = ".") -> Iterator[str]:
    """Yield repo-relative .py paths under ``paths``, sorted, skipping
    hidden directories and ``__pycache__``."""
    seen: Set[str] = set()
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            if full.endswith(".py"):
                seen.add(os.path.normpath(p).replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for fname in filenames:
                if not fname.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                seen.add(rel.replace(os.sep, "/"))
    yield from sorted(seen)


def analyze_module(module: Module, rule_classes: Sequence[type]
                   ) -> List[Finding]:
    findings: List[Finding] = []
    for cls in rule_classes:
        findings.extend(cls().run(module))
    return [f for f in findings if not module.suppressed(f)]


def analyze_source(source: str, *, path: str = "<memory>.py",
                   only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze one source string — the fixture-test entry point."""
    from repro_torch.analysis.rules import resolve_rules
    return analyze_module(Module(path, source), resolve_rules(only))


def analyze_paths(paths: Optional[Sequence[str]] = None, *,
                  root: str = ".",
                  only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze every python file under ``paths`` (repo-relative).

    Unparseable files surface as ``parse-error`` findings rather than
    crashing the run — a syntax error anywhere must fail the gate, not
    hide the rest of the report.
    """
    from repro_torch.analysis.rules import resolve_rules
    rule_classes = resolve_rules(only)
    findings: List[Finding] = []
    for rel in iter_python_files(paths or DEFAULT_ROOTS, root=root):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                source = f.read()
            module = Module(rel, source)
        except (SyntaxError, ValueError, UnicodeDecodeError) as e:
            findings.append(Finding(PARSE_ERROR, rel,
                                    getattr(e, "lineno", None) or 1, 0,
                                    f"cannot analyze: {e}"))
            continue
        findings.extend(analyze_module(module, rule_classes))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def summarize(findings: Iterable[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))
