"""Baseline IO: grandfathered findings the gate tolerates (and no more).

The baseline is a committed JSON file mapping each tolerated finding to
its identity key (``path::rule::message`` — no line number, so edits
above a grandfathered site don't churn the file). ``check --baseline``
fails only on findings *outside* the baseline; ``baseline`` rewrites
the file from the current tree. Policy: the baseline starts (and should
stay) minimal — new code fixes or suppresses inline with a
justification; the baseline exists so adopting a new rule never forces
a big-bang cleanup commit.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List, Set

from repro_torch.analysis.engine import Finding

DEFAULT_BASELINE = "analysis-baseline-torch.json"
_VERSION = 1


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    entries = sorted({(f.path, f.rule, f.message) for f in findings})
    payload = {
        "version": _VERSION,
        "findings": [{"path": p, "rule": r, "message": m}
                     for p, r, m in entries],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> Set[str]:
    """Finding keys the baseline tolerates; {} if the file is absent."""
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    if not isinstance(payload, dict) or \
            payload.get("version") != _VERSION:
        raise ValueError(f"{path}: not a version-{_VERSION} analysis "
                         f"baseline")
    out: Set[str] = set()
    for e in payload.get("findings", []):
        out.add(f"{e['path']}::{e['rule']}::{e['message']}")
    return out


def partition(findings: Iterable[Finding], known: Set[str]
              ) -> List[Finding]:
    """Findings not covered by the baseline, order preserved."""
    return [f for f in findings if f.key not in known]
