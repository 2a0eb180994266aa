"""Paper Table 3 + Figure 2: worker-count scaling by platform.

recorded — consistency checks on the published counts (11 decoders split
           between w=4 and w=8 peaks; Zen 4 the only w=4-majority platform).
live     — per-decoder peak worker count and peak/w0 speedup, read from
           the shared bench-harness sweep's thread-mode loader records.
           (This host has few vCPUs, so speedups ~<=1 are expected and
           documented — the point is the protocol, which transfers
           unchanged to 16-vCPU nodes.)
"""
from __future__ import annotations

from repro_torch.bench.views.common import save_json, sweep_records
from repro_torch.core import paper_data as PD


def run(quick: bool = True):
    rows = []
    ok = all(r["peak_w4"] + r["peak_w8"] == PD.NUM_LOADER_DECODERS
             for r in PD.TABLE3.values())
    w4major = [p for p, r in PD.TABLE3.items() if r["peak_w4"] > r["peak_w8"]]
    rows.append(("table3.recorded", 0.0,
                 f"counts_ok={ok} w4_majority={w4major}"))

    sweep = {}
    per_path: dict = {}
    for r in sweep_records(quick):
        if r.protocol == "dataloader" and r.ok and r.mode == "thread":
            per_path.setdefault(r.decoder, {})[r.workers] = \
                r.throughput_mean
    for nm, per in sorted(per_path.items()):
        if len(per) < 2:
            continue                      # no sweep to rank on this path
        peak_w = max(per, key=per.get)
        speedup = per[peak_w] / per[0] if per.get(0) else 0.0
        sweep[nm] = {"per_worker": per, "peak_w": peak_w,
                     "speedup": speedup}
        rows.append((f"table3.live.{nm}", 1e6 / max(per.values()),
                     f"peak_w={peak_w} speedup={speedup:.2f}x"))
    save_json("table3_live.json", sweep)
    return rows
