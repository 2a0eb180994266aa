"""Schema and trace discipline: the validated constructors are the API.

``core.schema`` owns the record invariants: ``RunRecord.from_json``
routes through ``validate_record`` (required keys, non-negative stats,
version gate). Splatting a raw dict straight into the dataclass —
``RunRecord(**d)`` — type-checks, imports fine, and quietly readmits
every malformed-payload bug the validator exists to reject. Field-by-
field construction (``RunRecord(platform=..., ...)``) stays allowed:
it cannot smuggle unknown keys and is how producers build records.

``obs.trace`` spans are context managers: timing closes in
``__exit__``. A ``span()`` call that is never ``with``-entered records
nothing (Tracer) or leaks an open span (capturing tracers) — either
way the trace silently loses the region it claims to cover.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.rules.base import Rule, dotted, terminal

#: The one module allowed to construct records from raw dicts — it is
#: where the validation itself lives.
_SCHEMA_MODULE = "core/schema.py"


class SchemaRawRecord(Rule):
    id = "schema-raw-record"
    summary = ("RunRecord(**d) outside core.schema bypasses "
               "validate_record — use RunRecord.from_json")
    motivation = ("comparing against an old results file with a "
                  "malformed record should fail at load with a clear "
                  "message, not propagate NaNs into the delta table")

    def visit_Call(self, node: ast.Call) -> None:
        if terminal(dotted(node.func)) == "RunRecord" \
                and any(kw.arg is None for kw in node.keywords) \
                and not self.module.path.endswith(_SCHEMA_MODULE):
            self.report(node,
                        "RunRecord(**d) bypasses validate_record — "
                        "construct via RunRecord.from_json(d) so "
                        "malformed payloads fail loudly at the boundary")
        self.generic_visit(node)


class TraceSpanNoWith(Rule):
    id = "trace-span-no-with"
    summary = "tracer span() calls must be entered with `with`"
    motivation = ("a span created but never entered times nothing; the "
                  "per-stage attribution tables read as if the stage "
                  "were free")

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        if terminal(dotted(node.func)) != "span":
            return
        parent = self.module.parent(node)
        if isinstance(parent, (ast.withitem, ast.Return)):
            # ``with ...span(...)`` / a forwarding helper like
            # obs.trace.span() returning the context manager to enter
            return
        self.report(node,
                    "span(...) is created but not entered — wrap it in "
                    "`with` (or return it for the caller to enter); an "
                    "unentered span records nothing")
