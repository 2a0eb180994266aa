"""Append-only bench-run history + stage-level regression attribution.

The nightly compare gate can say a cell got slower; this module makes it
say *what* got slower. Two pieces:

:class:`HistoryStore` — a JSONL file of whole sweep runs, one line per
run, keyed by ``host_fingerprint()`` so cross-machine records never get
compared as if they were the same hardware. In the port the fingerprint
names the device too (``repro_torch.common.hw``), so a CPU run is never
taken as a same-host baseline for a card run. The lines have the
reference's format, so either package reads the other's store.
Append-only by design: the nightly job restores the file from a cache, appends today's run, and
saves it back, so the store accretes a per-host time series without any
rewrite step (a torn final line from an interrupted writer is skipped
and *counted*, never silently absorbed).

``attribute_stages()`` — given a baseline and a candidate record that
both carry the traced ``meta.stage_s`` rollup (``sweep --trace`` stamps
it; ``core.schema`` validates it), normalize each stage to seconds per
image and name the stage whose time moved the most: the compare gate's
"cell X is 2.1x slower" becomes "entropy 1.8x on cell X". Stage names
are the terminal component of the span name (``jpeg.entropy`` →
``entropy``, ``loader.queue_wait`` → ``queue_wait``), matching the
vocabulary the tracer's instrumented seams emit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.common.hw import host_fingerprint
from repro_torch.core.schema import RunRecord, SchemaError, validate_record

__all__ = ["HistoryStore", "HistoryRun", "attribute_stages",
           "stage_per_image"]

#: stages with less wall time than this (s/image) on BOTH sides are not
#: attributable: a 3x ratio between two microsecond blips is noise
MIN_STAGE_S = 1e-4
#: smallest per-stage ratio worth naming
MIN_RATIO = 1.2


@dataclasses.dataclass
class HistoryRun:
    """One appended sweep: identity + its full validated record set."""

    run_id: str
    t: float
    fingerprint: str
    host: Dict
    profile: str
    records: List[RunRecord]

    def record_for(self, scenario: str) -> Optional[RunRecord]:
        for r in self.records:
            if r.scenario == scenario:
                return r
        return None


def _fp_of(host: Dict) -> str:
    """The 12-hex host hash from either shape: a ``host_fingerprint()``
    dict, or a record payload's ``host`` whose ``fingerprint`` key holds
    that dict."""
    fp = (host or {}).get("fingerprint", "")
    if isinstance(fp, dict):
        fp = fp.get("fingerprint", "")
    return str(fp)


class HistoryStore:
    """Append-only JSONL store of sweep runs, host-fingerprint-keyed."""

    def __init__(self, path: str):
        self.path = path

    # ------------------------------------------------------------ write
    def append(self, records: Sequence[RunRecord], *,
               host: Optional[Dict] = None, profile: str = "",
               run_id: str = "", t: Optional[float] = None) -> HistoryRun:
        """Validate and append one run; returns the stored view."""
        if not records:
            raise SchemaError("refusing to append an empty run")
        host = dict(host) if host else host_fingerprint()
        fp = _fp_of(host)
        if not fp:
            raise SchemaError(f"host carries no fingerprint: {host}")
        now = time.time() if t is None else float(t)
        rid = run_id or f"{int(now)}-{fp}"
        line = {
            "run_id": rid, "t": now, "fingerprint": fp, "host": host,
            "profile": profile,
            "records": [validate_record(r.to_json()) for r in records],
        }
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        return HistoryRun(rid, now, fp, host, profile, list(records))

    # ------------------------------------------------------------- read
    def scan(self) -> Tuple[List[HistoryRun], int]:
        """All runs oldest-first, plus the count of unreadable lines
        (torn writes, schema drift) — surfaced, never silently dropped."""
        runs: List[HistoryRun] = []
        dropped = 0
        if not os.path.exists(self.path):
            return runs, dropped
        with open(self.path) as f:
            for raw in f:
                if not raw.strip():
                    continue
                try:
                    d = json.loads(raw)
                    recs = [RunRecord.from_json(r) for r in d["records"]]
                    runs.append(HistoryRun(
                        str(d["run_id"]), float(d["t"]),
                        str(d["fingerprint"]), dict(d.get("host") or {}),
                        str(d.get("profile", "")), recs))
                except (json.JSONDecodeError, SchemaError, KeyError,
                        TypeError, ValueError):
                    dropped += 1
        return runs, dropped

    def runs(self, fingerprint: str = "") -> List[HistoryRun]:
        runs, _ = self.scan()
        if fingerprint:
            runs = [r for r in runs if r.fingerprint == fingerprint]
        return runs

    def latest(self, fingerprint: str = "") -> Optional[HistoryRun]:
        runs = self.runs(fingerprint)
        return runs[-1] if runs else None

    def stage_baseline(self, scenario: str, fingerprint: str = ""
                       ) -> Optional[Tuple[HistoryRun, RunRecord]]:
        """Newest same-host run holding an ok, stage-traced record for
        ``scenario`` — what a regression gets attributed against."""
        for run in reversed(self.runs(fingerprint)):
            rec = run.record_for(scenario)
            if rec is not None and rec.ok and rec.meta.get("stage_s"):
                return run, rec
        return None


# -------------------------------------------------------- attribution
def stage_per_image(rec: RunRecord) -> Dict[str, float]:
    """``meta.stage_s`` folded to seconds-per-image by terminal span-name
    component (two span names sharing a terminal sum together)."""
    stage_s = rec.meta.get("stage_s") or {}
    images = rec.num_images if rec.num_images > 0 else 1
    out: Dict[str, float] = {}
    for name, secs in stage_s.items():
        stage = name.rsplit(".", 1)[-1]
        out[stage] = out.get(stage, 0.0) + float(secs) / images
    return out


def attribute_stages(old: RunRecord, new: RunRecord, *,
                     min_stage_s: float = MIN_STAGE_S,
                     min_ratio: float = MIN_RATIO) -> str:
    """Name the stage that moved between two traced records.

    Returns e.g. ``"entropy 1.8x (2.10→3.79 ms/img)"`` for the largest
    per-image stage slowdown past ``min_ratio``, ``"<stage> new
    (+X ms/img)"`` for a stage absent from the baseline, or ``""`` when
    neither record carries stage data / nothing moved enough to name.
    """
    olds, news = stage_per_image(old), stage_per_image(new)
    if not olds or not news:
        return ""
    best: Tuple[float, str] = (0.0, "")
    for stage, new_s in news.items():
        old_s = olds.get(stage, 0.0)
        if new_s < min_stage_s:
            continue                     # too small to matter either way
        if old_s < min_stage_s:
            note = (f"{stage} new "
                    f"(+{new_s * 1e3:.2f} ms/img vs baseline)")
            score = new_s / min_stage_s          # rank by absolute size
        else:
            ratio = new_s / old_s
            if ratio < min_ratio:
                continue
            note = (f"{stage} {ratio:.1f}x "
                    f"({old_s * 1e3:.2f}→{new_s * 1e3:.2f} ms/img)")
            score = ratio
        if score > best[0]:
            best = (score, note)
    return best[1]
