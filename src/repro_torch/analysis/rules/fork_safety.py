"""Fork/pickle safety: what may cross a process-pool boundary.

The shard store's whole design is that workers reopen shards *by
path* — no corpus bytes, mmap handles, or ``ShardReader`` objects ever
ride ``initargs``. Before that design landed, the loader materialized
the entire corpus into ``initargs`` via ``list(self.files)`` on every
epoch (the rebuilt-pool bug). The ``initargs-have-no-bytes`` test pins
the loader; these rules pin *every* pool the repo will ever grow —
multi-process service workers included — at the AST instead of one
callsite at a time.
"""
from __future__ import annotations

import ast
import re
from typing import Optional

from repro_torch.analysis.rules.base import (Rule, dotted,
                                             enclosing_class, keyword_value,
                                             terminal)

#: Constructors that spawn worker processes taking initializer/initargs.
_POOL_CTORS = {"Pool", "ProcessPoolExecutor"}

#: Materializing calls: these build a by-value copy right in initargs.
_MATERIALIZERS = {"list", "tuple", "dict", "bytes", "bytearray"}

#: Terminal identifiers that name corpus payloads or per-process
#: resources (mmaps, readers) rather than picklable worker handles.
_BANNED = re.compile(
    r"^_?(files?|corpus|corpora|datas?|bytes|bufs?|buffers?|records?|"
    r"images?|readers?|mmaps?|blobs?|samples?)$", re.IGNORECASE)


def _is_pool_ctor(call: ast.Call) -> bool:
    return terminal(dotted(call.func)) in _POOL_CTORS


class ForkInitargsBytes(Rule):
    id = "fork-initargs-bytes"
    summary = ("Pool initargs must carry picklable handles, never corpus "
               "bytes, readers, or mmap objects")
    motivation = ("the per-epoch rebuilt pool re-materialized the whole "
                  "corpus into initargs via list(self.files) (since "
                  "fixed); shard workers reopen by path instead")

    def visit_Call(self, node: ast.Call) -> None:
        if _is_pool_ctor(node):
            initargs = keyword_value(node, "initargs")
            if initargs is not None:
                self._check_value(initargs)
        self.generic_visit(node)

    # ------------------------------------------------------------ checks
    def _check_value(self, value: ast.AST) -> None:
        if isinstance(value, (ast.Tuple, ast.List)):
            for el in value.elts:
                self._check_element(el)
            return
        resolved = self._resolve_self_method(value)
        if resolved is not None:
            for ret in resolved:
                self._check_value(ret)
            return
        # opaque expression: nothing to prove either way — the committed
        # convention is a literal tuple or a self-method returning one
        name = terminal(dotted(value))
        if name and _BANNED.match(name):
            self._check_element(value)

    def _check_element(self, el: ast.AST) -> None:
        if isinstance(el, ast.Starred):
            el = el.value
        if isinstance(el, ast.Call):
            fname = terminal(dotted(el.func))
            if fname in _MATERIALIZERS:
                self.report(el, f"initargs materializes a container via "
                                f"{fname}(...) — every worker inherits a "
                                f"full copy; pass a reopen-by-path handle "
                                f"(e.g. ByteSource.open_in_worker())")
            # other calls produce handles by convention (open_in_worker,
            # worker_config) — their return values are the audited seam
            return
        if isinstance(el, ast.Subscript):
            el = el.value
        name = terminal(dotted(el))
        if name and _BANNED.match(name):
            self.report(el, f"initargs references {dotted(el)!r} — names "
                            f"like files/corpus/reader/mmap are corpus "
                            f"payloads or per-process resources; ship a "
                            f"path-shaped worker handle instead")

    def _resolve_self_method(self, value: ast.AST):
        """``initargs=self._proc_initargs()`` -> that method's returned
        tuples, resolved within the enclosing class."""
        if not (isinstance(value, ast.Call) and not value.args
                and not value.keywords):
            return None
        name = dotted(value.func)
        if not (name and name.startswith("self.")):
            return None
        cls = enclosing_class(self.module, value)
        if cls is None:
            return None
        method = name.split(".", 1)[1]
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == method:
                return [r.value for r in ast.walk(stmt)
                        if isinstance(r, ast.Return)
                        and r.value is not None]
        return None


class ForkInitializerClosure(Rule):
    id = "fork-initializer-closure"
    summary = ("Pool initializer must be a module-level function, not a "
               "lambda or bound method")
    motivation = ("a bound-method or closure initializer drags its whole "
                  "enclosing object (corpus references included) across "
                  "the fork and cannot pickle under spawn")

    def visit_Call(self, node: ast.Call) -> None:
        if _is_pool_ctor(node):
            init = keyword_value(node, "initializer")
            bad = self._why_bad(init)
            if bad:
                self.report(init, bad)
        self.generic_visit(node)

    @staticmethod
    def _why_bad(init: Optional[ast.AST]) -> Optional[str]:
        if isinstance(init, ast.Lambda):
            return ("pool initializer is a lambda — it captures enclosing "
                    "state under fork and cannot pickle under spawn; use "
                    "a module-level function taking initargs")
        if isinstance(init, ast.Attribute):
            name = dotted(init)
            return (f"pool initializer {name or init.attr!r} is an "
                    f"attribute lookup (a bound method drags its whole "
                    f"object across the fork); use a module-level "
                    f"function taking initargs")
        return None
