"""Paper Table 5 / Appendix B: per-platform zero-skip starting points.

recorded — regenerate the per-platform leaders from the recorded matrix via
           the decision engine and verify against the published first
           choices.
live     — the same table for this host (the card, or the CPU with
           ``--device cpu``), from the shared sweep.
"""
from __future__ import annotations

from repro_torch.bench.views.common import (live_platform, save_json,
                                            sweep_records)
from repro_torch.core import decision, paper_data as PD
from repro_torch.core.schema import RunRecord


def run(quick: bool = True):
    rows = []
    recs = []
    for plat, entries in PD.TABLE5.items():
        for dec, thr, w in entries:
            recs.append(RunRecord(
                platform=plat, decoder=dec, protocol="dataloader",
                workers=w, mode="thread", throughput_mean=float(thr),
                throughput_std=0.0, samples=[float(thr)],
                num_images=50000, skip_indices=[]))
    peaks = decision.peak_loader_throughput(recs)
    match = 0
    for plat, entries in PD.TABLE5.items():
        ours = max(peaks[plat].items(),
                   key=lambda kv: kv[1].throughput_mean)[0]
        match += ours == entries[0][0]
    rows.append(("table5.recorded", 0.0,
                 f"first_choice_match={match}/5"))

    live = sweep_records(quick)
    lp = decision.peak_loader_throughput(live).get(live_platform(live),
                                                   {})
    zs = decision.zero_skip(lp)
    top = sorted(zs.values(), key=lambda r: -r.throughput_mean)[:3]
    rows.append(("table5.live", 0.0, " / ".join(
        f"{r.decoder}:{r.throughput_mean:.0f}img/s(w={r.workers})"
        for r in top)))
    save_json("table5_live.json",
              [(r.decoder, r.throughput_mean, r.workers) for r in top])
    return rows
