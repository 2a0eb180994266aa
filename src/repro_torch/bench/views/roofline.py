"""Roofline summary over the dry-run artifacts (deliverable g).

Reads artifacts/dryrun_torch/*.json (the port's own dry-run artifacts,
written by ``python -m repro_torch.launch.dryrun``; never the reference's
TPU ones in artifacts/dryrun/), renders the single-pod table + the
multi-pod shardability check, and names the dominant bottleneck per cell.
The port's dry-run counts one H100 (``common.hw.H100_SXM``): its pod
records are one card's, its multi-pod records one rank's of the
reference's 2 x 16 x 16 mesh. With no dry-run written yet the view
reports zero cells.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict

from repro_torch.bench.views.common import save_json

DRYRUN_DIR = os.path.join("artifacts", "dryrun_torch")


def load_cells(tag: str = "") -> Dict[str, dict]:
    cells = {}
    suffix_pod = f"pod-{tag}.json" if tag else "pod.json"
    suffix_multi = f"multipod-{tag}.json" if tag else "multipod.json"
    for f in glob.glob(os.path.join(DRYRUN_DIR, "*.json")):
        base = os.path.basename(f)
        parts = base[:-5].split("__")
        if len(parts) != 3:
            continue
        arch, shape, mesh_name = parts
        if base.endswith(suffix_multi) and f"__{suffix_multi}" in "__" + base:
            kind = "multipod"
        elif base.endswith(suffix_pod):
            kind = "pod"
        else:
            continue
        if tag and f"-{tag}" not in mesh_name:
            continue
        if not tag and "-" in mesh_name.replace("multipod", "").replace(
                "pod", ""):
            continue
        cells[(arch, shape, kind)] = json.load(open(f))
    return cells


def run(quick: bool = True):
    rows = []
    cells = load_cells()
    pods = {(a, s): r for (a, s, k), r in cells.items() if k == "pod"}
    multis = {(a, s): r for (a, s, k), r in cells.items() if k == "multipod"}

    ok = sum(1 for r in pods.values() if r["status"] == "ok")
    skipped = sum(1 for r in pods.values() if r["status"] == "skipped")
    err = sum(1 for r in pods.values() if r["status"] == "error")
    mok = sum(1 for r in multis.values() if r["status"] == "ok")
    rows.append(("roofline.matrix", 0.0,
                 f"pod ok={ok} skipped={skipped} err={err}; "
                 f"multipod ok={mok}"))

    table = []
    for (arch, shape), r in sorted(pods.items()):
        if r["status"] != "ok":
            table.append({"arch": arch, "shape": shape,
                          "status": r["status"],
                          "reason": r.get("reason", r.get("error",
                                                          ""))[:80]})
            continue
        ro = r["roofline"]
        mem = r["memory"]
        table.append({
            "arch": arch, "shape": shape, "status": "ok",
            "compute_s": ro["compute_s"], "memory_s": ro["memory_s"],
            "collective_s": ro["collective_s"],
            "dominant": ro["dominant"],
            "roofline_fraction": ro["roofline_fraction"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "hbm_gib": (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30,
            "fits_hbm": mem["fits_hbm"],
        })
        rows.append((f"roofline.{arch}.{shape}",
                     ro["bound_s"] * 1e6,
                     f"dom={ro['dominant'][:-2]} "
                     f"frac={ro['roofline_fraction']:.3f} "
                     f"useful={r['useful_flops_ratio']:.2f} "
                     f"hbm={table[-1]['hbm_gib']:.1f}GiB"))
    save_json("roofline_table.json", table)

    if pods:
        worst = min((t for t in table if t.get("status") == "ok"),
                    key=lambda t: t["roofline_fraction"])
        coll = [t for t in table if t.get("dominant") == "collective_s"]
        rows.append(("roofline.worst_cell", 0.0,
                     f"{worst['arch']}x{worst['shape']} "
                     f"frac={worst['roofline_fraction']:.4f}"))
        rows.append(("roofline.collective_bound_cells", 0.0,
                     str([f"{t['arch']}x{t['shape']}" for t in coll])))
    return rows
