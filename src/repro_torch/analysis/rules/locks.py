"""Lock discipline: an attribute guarded somewhere is guarded everywhere.

The service/loader/obs classes all follow one convention: shared mutable
state lives behind ``with self._lock`` (any self attribute whose name
contains "lock"). The dangerous drift is partial protection — one method
takes the lock, another writes the same attribute bare (the shipped
example: ``SkipLedger.restore`` replacing ``self.skips`` unlocked while
``record`` appended under the lock). This rule finds exactly that shape.

Scope decisions, deliberately conservative to stay actionable:

* Only *writes* are flagged (assignment, augmented assignment,
  subscript stores, and known container mutators like ``append``/
  ``update``). Unlocked *reads* are frequently legitimate fast paths
  re-checked under the lock (``DecodeService.submit``) and would bury
  the signal in noise.
* ``__init__``/``__new__``/``__post_init__`` are exempt — the object is
  not yet shared during construction.
* Methods named ``*_locked`` are exempt by convention: they document
  that the caller holds the lock (``MicroBatcher._pop_locked``).
* Functions nested inside a method are treated as running where they
  are defined — a worker closure defined under the lock but invoked
  later can evade the rule; keep pool/thread targets at module level
  (which the fork-safety rules require anyway).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.rules.base import Rule, dotted, self_attr

_LOCK_NAME = re.compile(r"lock", re.IGNORECASE)
_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}

#: Method names that mutate their receiver in place.
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse",
}

# one recorded write: (attr, node, method, lock-held-or-None)
_Write = Tuple[str, ast.AST, str, Optional[str]]


def _lock_attr_of_with(node: ast.With) -> Optional[str]:
    """The self lock attribute a ``with`` statement acquires, if any."""
    for item in node.items:
        expr = item.context_expr
        # unwrap ``with self._lock.acquire_timeout(...)``-style wrappers
        if isinstance(expr, ast.Call):
            expr = expr.func
        name = dotted(expr)
        if name and name.startswith("self."):
            attr = name.split(".")[1]
            if _LOCK_NAME.search(attr):
                return attr
    return None


class LockUnguardedWrite(Rule):
    id = "lock-unguarded-write"
    summary = ("attribute written under a self lock in one method must "
               "not be written bare in another")
    motivation = ("SkipLedger.restore replaced self.skips without the "
                  "lock that record()/state() hold — a checkpoint "
                  "restore racing a recording worker could lose skips")

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        locked_by: Dict[str, str] = {}       # attr -> lock attr name
        writes: List[_Write] = []
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if stmt.name in _EXEMPT_METHODS or \
                    stmt.name.endswith("_locked"):
                continue
            for child in ast.iter_child_nodes(stmt):
                self._walk(child, stmt.name, None, locked_by, writes)
        for attr, write_node, method, lock in writes:
            if lock is None and attr in locked_by:
                self.report(write_node,
                            f"self.{attr} is written under self."
                            f"{locked_by[attr]} elsewhere in this class "
                            f"but written in {method}() without it")
        self.generic_visit(node)          # nested classes: their own pass

    # ------------------------------------------------------------ walking
    def _walk(self, node: ast.AST, method: str, lock: Optional[str],
              locked_by: Dict[str, str], writes: List[_Write]) -> None:
        if isinstance(node, ast.ClassDef):
            return                        # visit_ClassDef handles it
        self._record(node, method, lock, locked_by, writes)
        if isinstance(node, ast.With):
            inner = _lock_attr_of_with(node) or lock
            for item in node.items:       # header runs before acquisition
                self._walk(item, method, lock, locked_by, writes)
            for stmt in node.body:
                self._walk(stmt, method, inner, locked_by, writes)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, method, lock, locked_by, writes)

    def _record(self, node: ast.AST, method: str, lock: Optional[str],
                locked_by: Dict[str, str], writes: List[_Write]) -> None:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
                attr = self_attr(func.value)
                if attr is not None:
                    self._note(attr, node, method, lock, locked_by,
                               writes)
            return
        else:
            return
        for target in targets:
            for t in self._flatten(target):
                if isinstance(t, ast.Subscript):
                    t = t.value
                attr = self_attr(t)
                if attr is not None:
                    self._note(attr, node, method, lock, locked_by,
                               writes)

    @staticmethod
    def _flatten(target: ast.AST) -> List[ast.AST]:
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[ast.AST] = []
            for el in target.elts:
                out.extend(LockUnguardedWrite._flatten(el))
            return out
        return [target]

    @staticmethod
    def _note(attr: str, node: ast.AST, method: str, lock: Optional[str],
              locked_by: Dict[str, str], writes: List[_Write]) -> None:
        if _LOCK_NAME.search(attr):
            return                        # the lock itself is not guarded
        writes.append((attr, node, method, lock))
        if lock is not None:
            locked_by.setdefault(attr, lock)
