"""Markdown table generators (the artifact's render-readme analogue)."""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.decision import TierEntry
from repro_torch.core.schema import RunRecord


def md_table(headers: List[str], rows: List[List[str]]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join(["---"] * len(headers)) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def single_thread_report(records: Sequence[RunRecord]) -> str:
    rows = []
    for r in sorted(records, key=lambda r: -r.throughput_mean):
        if r.protocol != "single_thread" or not r.ok:
            continue
        rows.append([r.decoder, f"{r.throughput_mean:.1f}",
                     f"{r.throughput_std:.1f}", r.skips,
                     r.meta.get("engine", "")])
    return md_table(["decoder", "img/s", "±std", "skips", "engine"], rows)


def loader_report(records: Sequence[RunRecord]) -> str:
    rows = []
    for r in sorted(records, key=lambda r: (r.decoder, r.workers)):
        if r.protocol != "dataloader" or not r.ok:
            continue
        rows.append([r.decoder, r.workers, r.mode,
                     f"{r.throughput_mean:.1f}", f"{r.throughput_std:.1f}",
                     r.skips,
                     "yes" if r.meta.get("eligible", True) else "no"])
    return md_table(["decoder", "workers", "mode", "img/s", "±std",
                     "skips", "eligible"], rows)


def tier_report(tier: List[TierEntry]) -> str:
    rows = [[t.decoder, f"{100*t.mean_norm:.1f}%", f"{100*t.min_norm:.1f}%",
             f"{100*t.max_norm:.1f}%", t.platforms] for t in tier]
    return md_table(["decoder", "mean", "min", "max", "platforms"], rows)


def status_report(records: Sequence[RunRecord]) -> str:
    """Scenario completeness: one row per protocol with ok/skip counts —
    the 'present or explicitly skipped' accounting the smoke gate asserts."""
    counts = {}
    for r in records:
        c = counts.setdefault(r.protocol, {"ok": 0, "skipped": 0,
                                           "error": 0})
        c[r.status] = c.get(r.status, 0) + 1
    rows = [[p, c["ok"], c["skipped"], c["error"]]
            for p, c in sorted(counts.items())]
    return md_table(["protocol", "ok", "skipped", "error"], rows)


def flip_report(disagreements: dict) -> str:
    """decision.recommend()'s protocol_disagreement as a table: the rank
    flips that are the paper's headline result."""
    rows = []
    for plat, d in sorted(disagreements.items()):
        mv = d["largest_move"]
        rows.append([plat, d["single_leader"], d["loader_leader"],
                     f"{d['rho']:.2f}", f"{100*d['single_leader_gap']:.1f}%",
                     f"{mv[0]} {mv[1]}->{mv[2]}" if mv[0] else "-"])
    return md_table(["platform", "single-thread leader", "loader leader",
                     "rho", "leader gap", "largest rank move"], rows)


def compare_report(entries: Sequence) -> str:
    """Rendered view of bench.compare results (one row per scenario)."""
    rows = []
    for e in entries:
        rows.append([e.scenario, f"{e.old_mean:.1f}", f"{e.new_mean:.1f}",
                     f"{e.ratio:.2f}x" if e.ratio else "-",
                     f"{100*e.threshold:.1f}%", e.verdict])
    return md_table(["scenario", "old img/s", "new img/s", "new/old",
                     "gate", "verdict"], rows)
