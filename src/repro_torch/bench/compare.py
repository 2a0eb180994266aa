"""Cross-commit record-set comparison with noise-aware gates.

Two record sets (baseline vs candidate) are matched scenario-by-scenario
and each pair is classified:

  fail      — throughput dropped below 1/fail_ratio of baseline (default
              2x). A drop that size is beyond any accepted noise: the
              gate that turns a perf PR red.
  warn      — regression beyond the scenario's gate threshold: the larger
              of the paper's practical-significance floor for that
              protocol (1% single-thread / 5% pooled) and the measured
              run-to-run noise (2 sigma of the combined coefficient of
              variation). Noisy scenarios gate loosely; tight ones gate
              tightly.
  improved  — same threshold, other direction.
  ok        — inside the gate either way.

Skipped/error cells and one-sided scenarios are reported but never gate:
a scenario leaving the matrix must be visible, not fatal, because
profiles legitimately differ across hosts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import stats
from repro_torch.core.schema import RunRecord, load_payload

FAIL_RATIO = 2.0          # >2x slowdown fails regardless of noise
NOISE_Z = 2.0


@dataclasses.dataclass
class CompareEntry:
    scenario: str
    verdict: str              # fail|warn|improved|ok|skipped|missing-*
    old_mean: float = 0.0
    new_mean: float = 0.0
    ratio: float = 0.0        # new/old (>1 means faster)
    threshold: float = 0.0    # relative warn gate applied
    detail: str = ""
    attribution: str = ""     # stage-level blame, e.g. "entropy 1.8x"


@dataclasses.dataclass
class CompareResult:
    entries: List[CompareEntry]
    fail_ratio: float
    old_host: Dict
    new_host: Dict

    def by_verdict(self, verdict: str) -> List[CompareEntry]:
        return [e for e in self.entries if e.verdict == verdict]

    @property
    def n_fail(self) -> int:
        return len(self.by_verdict("fail"))

    @property
    def n_warn(self) -> int:
        return len(self.by_verdict("warn"))

    def exit_code(self, *, warn_only: bool = False) -> int:
        if self.n_fail and not warn_only:
            return 2
        return 0

    def summary_line(self) -> str:
        counts = {}
        for e in self.entries:
            counts[e.verdict] = counts.get(e.verdict, 0) + 1
        fields = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        host_note = ""
        of = (self.old_host or {}).get("fingerprint", {})
        nf = (self.new_host or {}).get("fingerprint", {})
        if isinstance(of, dict):
            of = of.get("fingerprint", "")
        if isinstance(nf, dict):
            nf = nf.get("fingerprint", "")
        if of and nf and of != nf:
            host_note = (" [host fingerprints differ: "
                         f"{of} vs {nf} — deltas may be hardware]")
        return f"compare: {fields}{host_note}"


def _index(records: Sequence[RunRecord]) -> Dict[str, RunRecord]:
    return {r.scenario: r for r in records}


def compare_records(old: Sequence[RunRecord], new: Sequence[RunRecord], *,
                    fail_ratio: float = FAIL_RATIO,
                    z: float = NOISE_Z,
                    old_host: Optional[Dict] = None,
                    new_host: Optional[Dict] = None) -> CompareResult:
    oi, ni = _index(old), _index(new)
    entries: List[CompareEntry] = []
    for name in sorted(set(oi) | set(ni)):
        a, b = oi.get(name), ni.get(name)
        if a is None:
            entries.append(CompareEntry(name, "missing-old",
                                        new_mean=b.throughput_mean,
                                        detail="scenario new in candidate"))
            continue
        if b is None:
            entries.append(CompareEntry(name, "missing-new",
                                        old_mean=a.throughput_mean,
                                        detail="scenario dropped"))
            continue
        if not (a.ok and b.ok):
            entries.append(CompareEntry(
                name, "skipped", old_mean=a.throughput_mean,
                new_mean=b.throughput_mean,
                detail=f"status {a.status}/{b.status}"))
            continue
        if a.throughput_mean <= 0:
            entries.append(CompareEntry(name, "skipped",
                                        detail="zero baseline throughput"))
            continue
        ratio = b.throughput_mean / a.throughput_mean
        threshold = max(stats.protocol_threshold(a.protocol),
                        stats.noise_gate(a.samples, b.samples, z=z))
        if ratio < 1.0 / fail_ratio:
            verdict = "fail"
        elif ratio < 1.0 - threshold:
            verdict = "warn"
        elif ratio > 1.0 + threshold:
            verdict = "improved"
        else:
            verdict = "ok"
        entries.append(CompareEntry(
            name, verdict, old_mean=a.throughput_mean,
            new_mean=b.throughput_mean, ratio=ratio, threshold=threshold))
    return CompareResult(entries=entries, fail_ratio=fail_ratio,
                         old_host=old_host or {}, new_host=new_host or {})


def summary_markdown(res: CompareResult, *, max_rows: int = 20) -> str:
    """Render a compare result as the GitHub-flavored markdown summary
    the CI jobs append to ``$GITHUB_STEP_SUMMARY`` — regressions ranked
    worst-first, then improvements best-first, so the checks page answers
    "what moved?" without opening the uploaded JSON."""
    lines = ["## Bench compare", "", res.summary_line(), ""]
    attributed = any(e.attribution for e in res.entries)

    def table(title: str, entries: List[CompareEntry]) -> None:
        if not entries:
            return
        shown = entries[:max_rows]
        lines.append(f"### {title} ({len(entries)})")
        lines.append("")
        stage_h = " stage |" if attributed else ""
        lines.append("| scenario | baseline img/s | candidate img/s "
                     f"| ratio | gate |{stage_h}")
        lines.append("|---|---:|---:|---:|---:|" + ("---|" if attributed
                                                    else ""))
        for e in shown:
            stage_c = f" {e.attribution} |" if attributed else ""
            lines.append(
                f"| `{e.scenario}` | {e.old_mean:.1f} | {e.new_mean:.1f} "
                f"| {e.ratio:.3f}x | ±{e.threshold:.1%} |{stage_c}")
        if len(entries) > max_rows:
            pad = " |" if attributed else ""
            lines.append(f"| … {len(entries) - max_rows} more rows "
                         f"omitted | | | | |{pad}")
        lines.append("")

    table("Failures", sorted(res.by_verdict("fail"),
                             key=lambda e: e.ratio))
    table("Regressions", sorted(res.by_verdict("warn"),
                                key=lambda e: e.ratio))
    table("Improvements", sorted(res.by_verdict("improved"),
                                 key=lambda e: -e.ratio))
    moved = res.n_fail + res.n_warn + len(res.by_verdict("improved"))
    if not moved:
        lines.append("No scenarios moved beyond their noise gates.")
        lines.append("")
    unmatched = [e for e in res.entries
                 if e.verdict in ("missing-old", "missing-new", "skipped")]
    if unmatched:
        lines.append(f"<sub>{len(unmatched)} scenario(s) not gated "
                     "(skipped / one-sided); see the records artifact."
                     "</sub>")
        lines.append("")
    return "\n".join(lines)


def compare_paths(old_path: str, new_path: str, *,
                  fail_ratio: float = FAIL_RATIO,
                  z: float = NOISE_Z) -> CompareResult:
    old = load_payload(old_path)
    new = load_payload(new_path)
    return compare_records(
        [RunRecord.from_json(r) for r in old["records"]],
        [RunRecord.from_json(r) for r in new["records"]],
        fail_ratio=fail_ratio, z=z,
        old_host=old.get("host"), new_host=new.get("host"))


def attribute_result(res: CompareResult, old: Sequence[RunRecord],
                     new: Sequence[RunRecord], *, history=None) -> int:
    """Stage-attribute every fail/warn entry in ``res`` in place.

    The candidate record's ``meta.stage_s`` is compared against the
    newest same-fingerprint run in ``history`` (a
    :class:`~repro_torch.bench.history.HistoryStore`) that traced the same
    scenario, falling back to the compare baseline itself when the
    store has none. Entries that cannot be attributed get an explicit
    "unattributed: …" note — the absence of stage data is a finding,
    not a blank. Returns the number of entries that got a stage name.
    """
    from repro_torch.bench.history import _fp_of, attribute_stages
    oi, ni = _index(old), _index(new)
    fingerprint = _fp_of(res.new_host)
    named = 0
    for e in res.entries:
        if e.verdict not in ("fail", "warn"):
            continue
        new_rec = ni.get(e.scenario)
        old_rec = None
        if history is not None:
            hit = history.stage_baseline(e.scenario, fingerprint)
            if hit is not None:
                old_rec = hit[1]
        if old_rec is None:
            old_rec = oi.get(e.scenario)
        if (new_rec is None or old_rec is None
                or not new_rec.meta.get("stage_s")
                or not old_rec.meta.get("stage_s")):
            e.attribution = ("unattributed: no stage_s rollup "
                             "(run sweep --trace)")
            continue
        note = attribute_stages(old_rec, new_rec)
        if note:
            e.attribution = note
            named += 1
        else:
            e.attribution = "unattributed: no single stage moved enough"
    return named
