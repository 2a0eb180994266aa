"""Exception discipline: broad handlers must not swallow silently.

``except Exception`` is sometimes right in this repo — per-image decode
isolation in the loader, per-cell isolation in the bench harness —
but every such site either re-raises, records the exception object
somewhere (ledger, log, result row), or carries an explicit
``# repro: ignore[except-swallow]`` with its justification. What this
rule forbids is the fourth shape: catch everything, use nothing, tell
no one — the kind of handler that turns a corrupt shard or a dead
worker into a silent zero-sample epoch.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.rules.base import Rule, dotted, terminal

_BROAD = {"Exception", "BaseException"}


def _is_broad(type_node: Optional[ast.AST]) -> bool:
    if type_node is None:
        return True                               # bare ``except:``
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(el) for el in type_node.elts)
    return terminal(dotted(type_node)) in _BROAD


class ExceptSwallow(Rule):
    id = "except-swallow"
    summary = ("a broad except must re-raise or use the caught "
               "exception, never discard it")
    motivation = ("a swallowed decode error in a worker surfaces as a "
                  "mysteriously short epoch hours later; the skip "
                  "ledger exists so every drop is recorded with its "
                  "cause")

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if _is_broad(node.type) and not self._handled(node):
            what = "bare except" if node.type is None else \
                f"except {terminal(dotted(node.type)) or 'Exception'}"
            self.report(node,
                        f"{what} swallows the exception — re-raise, "
                        f"record it (bind `as e` and use it), or "
                        f"suppress with a justification")
        self.generic_visit(node)

    @staticmethod
    def _handled(node: ast.ExceptHandler) -> bool:
        for child in ast.walk(node):
            if isinstance(child, ast.Raise):
                return True
            if node.name and isinstance(child, ast.Name) \
                    and child.id == node.name \
                    and isinstance(child.ctx, ast.Load):
                return True
        return False
