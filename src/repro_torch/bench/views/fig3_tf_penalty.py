"""Paper Figure 3: the TensorFlow single-thread ARM penalty (recorded), and
its framework analogue: heavyweight-engine decode paths (torch-backed) vs
lean numpy paths in single-thread decode on this host (dispatch/runtime
overhead is the mechanism behind both). Live numbers come from the shared
bench-harness sweep; the reference reads ``jnp-fused`` where this view
reads ``torch-fused``."""
from __future__ import annotations

from repro_torch.bench.views.common import save_json, sweep_records
from repro_torch.core import paper_data as PD

ENGINE_PATH = "torch-fused"
LEAN_PATH = "numpy-fast"


def run(quick: bool = True):
    rows = []
    tf = PD.TENSORFLOW_SINGLE_THREAD
    x86 = (tf["Intel 8581C"] + tf["AMD Zen 5"]) / 2
    arm = (tf["Neoverse V2"] + tf["Neoverse N1"]) / 2
    rows.append(("fig3.recorded", 0.0,
                 f"tf_arm_vs_x86={arm / x86:.2f} (paper: ~3/5 of local "
                 f"winner on ARM)"))

    recs = sweep_records(quick)
    thr = {r.decoder: r.throughput_mean for r in recs
           if r.protocol == "single_thread" and r.ok}
    missing = [d for d in (ENGINE_PATH, LEAN_PATH) if d not in thr]
    if missing:
        reasons = {r.decoder: r.meta.get("reason", r.status)
                   for r in recs if r.protocol == "single_thread"
                   and r.decoder in missing}
        raise RuntimeError(
            f"fig3 needs single-thread cells {missing}: {reasons}")
    ratio = thr[ENGINE_PATH] / thr[LEAN_PATH]
    rows.append(("fig3.live_engine_overhead", 1e6 / thr[ENGINE_PATH],
                 f"torch_vs_numpy_single_thread={ratio:.2f}"))
    save_json("fig3_live.json",
              {"thr": {k: thr[k] for k in (LEAN_PATH, ENGINE_PATH)},
               "ratio": ratio})
    return rows
