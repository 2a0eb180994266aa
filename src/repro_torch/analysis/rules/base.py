"""Rule base class and the small AST helpers every rule family shares."""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.engine import Finding, Module


class Rule(ast.NodeVisitor):
    """One invariant, one class. Subclasses set the identity fields and
    implement ``visit_*`` methods calling ``self.report(node, msg)``.

    ``id`` is the suppression/selection token; ``summary`` is one line
    for the catalog; ``motivation`` names the historical bug in this
    repo (or its class) that the rule exists to prevent recurring.
    """

    id: str = ""
    summary: str = ""
    motivation: str = ""

    def run(self, module: Module) -> List[Finding]:
        self.module = module
        self.findings: List[Finding] = []
        self.setup(module)
        self.visit(module.tree)
        return self.findings

    def setup(self, module: Module) -> None:
        """Per-module pre-pass hook (e.g. collect pallas kernel names)."""

    def report(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            self.id, self.module.path, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0), message))


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal(name: Optional[str]) -> str:
    """Last segment of a dotted name ('' for None)."""
    return name.rsplit(".", 1)[-1] if name else ""


def keyword_value(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is exactly ``self.x``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def const_strs(node: Optional[ast.AST]) -> Set[str]:
    """String constants inside a Constant/Tuple/List/Set node."""
    out: Set[str] = set()
    if node is None:
        return out
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.add(node.value)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
    return out


def enclosing_class(module: Module, node: ast.AST
                    ) -> Optional[ast.ClassDef]:
    for anc in module.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None
