"""The operational decision protocol (paper Table 1 + §4.5 as code).

Converts benchmark records into deployment recommendations:
  * zero-skip filter (robustness accounting changes eligibility)
  * normalization to the platform-local winner
  * the 90% practical floor -> the recommended *tier*, not one winner
  * Table-1 protocol-selection guide: each deployment question names the
    evidence protocol that can support it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.schema import RunRecord
from repro_torch.core import stats

PRACTICAL_FLOOR = 0.90

# Paper Table 1, encoded.
PROTOCOL_GUIDE = {
    "fastest_component": {
        "question": "Which decoder is fastest?",
        "insufficient": "Unqualified fastest claim",
        "required": "single_thread table with CPU/workload scope",
        "claim": "Component speed only",
    },
    "feed_dataloader": {
        "question": "Which decoder should feed the DataLoader?",
        "insufficient": "Single-thread ranking",
        "required": "dataloader throughput",
        "claim": "Loader-scale top tier",
    },
    "worker_count": {
        "question": "How many workers?",
        "insufficient": "One CPU family",
        "required": "worker sweep per CPU",
        "claim": "CPU-generation-specific worker policy",
    },
    "safe_default": {
        "question": "Is it safe by default?",
        "insufficient": "Throughput only",
        "required": "skip/failure accounting",
        "claim": "Operational tier",
    },
}


def required_protocol(question: str) -> str:
    return PROTOCOL_GUIDE[question]["required"]


# ------------------------------------------------------------- aggregation
def peak_loader_throughput(records: Sequence[RunRecord]
                           ) -> Dict[str, Dict[str, RunRecord]]:
    """platform -> decoder -> peak-worker loader record.

    Explicit scenario skips/errors (``not r.ok``) carry zero throughput
    and never enter an aggregate."""
    out: Dict[str, Dict[str, RunRecord]] = {}
    for r in records:
        if r.protocol != "dataloader" or not r.meta.get("eligible", True) \
                or not r.ok:
            continue
        best = out.setdefault(r.platform, {}).get(r.decoder)
        if best is None or r.throughput_mean > best.throughput_mean:
            out[r.platform][r.decoder] = r
    return out


def single_thread_table(records: Sequence[RunRecord]
                        ) -> Dict[str, Dict[str, RunRecord]]:
    out: Dict[str, Dict[str, RunRecord]] = {}
    for r in records:
        if r.protocol == "single_thread" and r.ok:
            out.setdefault(r.platform, {})[r.decoder] = r
    return out


def zero_skip(records_by_decoder: Dict[str, RunRecord]) -> Dict[str, RunRecord]:
    return {d: r for d, r in records_by_decoder.items() if r.skips == 0}


def normalized(records_by_decoder: Dict[str, RunRecord]) -> Dict[str, float]:
    peak = max((r.throughput_mean for r in records_by_decoder.values()),
               default=0.0)
    if peak <= 0:
        return {}
    return {d: r.throughput_mean / peak
            for d, r in records_by_decoder.items()}


@dataclasses.dataclass
class TierEntry:
    decoder: str
    mean_norm: float
    min_norm: float
    max_norm: float
    platforms: str


def robust_tier(records: Sequence[RunRecord], *,
                floor: float = PRACTICAL_FLOOR) -> List[TierEntry]:
    """Paper Table 4: zero-skip decoders above the practical floor on every
    platform, ranked by mean normalized peak loader throughput."""
    peaks = peak_loader_throughput(records)
    platforms = sorted(peaks)
    per_decoder: Dict[str, List[float]] = {}
    for plat in platforms:
        # normalization vs *all* eligible decoders (platform-local winner)
        norm = normalized(peaks[plat])
        zs = zero_skip(peaks[plat])
        for d, v in norm.items():
            if d in zs:
                per_decoder.setdefault(d, [None] * len(platforms))
                per_decoder[d][platforms.index(plat)] = v
    tier = []
    for d, vals in per_decoder.items():
        if any(v is None for v in vals):
            continue                      # not zero-skip everywhere
        if min(vals) < floor:
            continue
        tier.append(TierEntry(d, float(np.mean(vals)), float(min(vals)),
                              float(max(vals)),
                              f"{len(vals)}/{len(platforms)}"))
    tier.sort(key=lambda t: -t.mean_norm)
    return tier


def recommend(records: Sequence[RunRecord]) -> Dict[str, object]:
    """The paper's §5 recommendation structure, computed from records."""
    tier = robust_tier(records)
    rec: Dict[str, object] = {"tier": tier}
    if tier:
        rec["best_mean"] = max(tier, key=lambda t: t.mean_norm).decoder
        rec["best_floor"] = max(tier, key=lambda t: t.min_norm).decoder
    peaks = peak_loader_throughput(records)
    singles = single_thread_table(records)
    disagreements = {}
    for plat in peaks:
        if plat not in singles:
            continue
        s = {d: r.throughput_mean for d, r in singles[plat].items()
             if d in peaks[plat]}
        ld = {d: r.throughput_mean for d, r in peaks[plat].items()
              if d in s}
        if not s or not ld:
            continue
        s_leader = max(s, key=s.get)
        l_leader = max(ld, key=ld.get)
        gap = 0.0
        if s_leader != l_leader and ld[l_leader] > 0:
            gap = 1.0 - ld[s_leader] / ld[l_leader]
        disagreements[plat] = {
            "single_leader": s_leader, "loader_leader": l_leader,
            "rho": stats.spearman_rho(list(s.values()), list(ld.values())),
            "single_leader_gap": gap,
            "largest_move": stats.largest_rank_move(s, ld),
        }
    rec["protocol_disagreement"] = disagreements
    return rec
