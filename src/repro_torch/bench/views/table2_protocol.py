"""Paper Table 2 + Figure 1: single-thread vs peak-DataLoader disagreement.

Two parts:
  recorded — validate the paper's own derived claims from its published
             numbers (leader disagreement count, single-leader gaps).
  live     — the same diagnostics (leaders, Spearman rho, largest rank
             move) computed from the shared bench-harness sweep on the
             one platform it ran on (the card's name, or "live-host" on
             the CPU); this view measures nothing itself.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.views.common import (live_platform, save_json,
                                            sweep_records)
from repro_torch.core import decision, paper_data as PD


def run(quick: bool = True):
    rows = []

    # ---- recorded (paper) -------------------------------------------
    n_disagree = sum(1 for r in PD.TABLE2.values()
                     if r["single_leader"] != r["loader_leader"])
    gaps_ok = []
    for plat, want in PD.SINGLE_LEADER_GAPS.items():
        t5 = dict((d, v) for d, v, _ in PD.TABLE5[plat])
        leader = PD.TABLE2[plat]["loader_leader"]
        sleader = PD.TABLE2[plat]["single_leader"]
        if sleader in t5 and leader in t5:
            gap = 1.0 - t5[sleader] / t5[leader]
            gaps_ok.append(abs(gap - want) < 0.002)
    rows.append(("table2.recorded", 0.0,
                 f"disagree={n_disagree}/5 gaps_validated="
                 f"{sum(gaps_ok)}/{len(gaps_ok)}"))

    # ---- live (derived from the shared sweep) -----------------------
    recs = sweep_records(quick)
    # the sweep labels its records with the card's name on the card and
    # "live-host" on the CPU: read the one platform it ran on
    platform = live_platform(recs)
    rec = decision.recommend(recs)
    d = rec["protocol_disagreement"].get(platform)
    if d is None:
        bad = sorted({(r.protocol, r.meta.get("reason", r.status))
                      for r in recs if not r.ok})[:4]
        raise RuntimeError(
            "table2 needs overlapping ok single-thread and loader "
            f"records on {platform}; non-ok cells include: {bad}")
    single = {r.decoder: r.throughput_mean for r in recs
              if r.protocol == "single_thread" and r.ok}
    st_thr = np.mean(list(single.values()))
    rows.append(("table2.live_single_thread", 1e6 / st_thr,
                 f"leader={d['single_leader']}"))
    rows.append(("table2.live_loader", 0.0,
                 f"leader={d['loader_leader']} rho={d['rho']:.2f} "
                 f"largest_move={d['largest_move']}"))
    save_json("table2_live.json", d)
    return rows
