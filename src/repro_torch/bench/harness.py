"""Scenario-sweep harness: one entry point for every perf number.

Runs the selected slice of the scenario registry over a shared synthetic
corpus, stamps each emitted RunRecord with its scenario name and the
host fingerprint, validates everything against ``core.schema``, and
writes:

  artifacts/bench_torch/records_<profile>.json  — the full validated set
  artifacts/bench_torch/scenarios/<name>.json   — one payload per scenario
  artifacts/bench_torch/report_<profile>.md     — derived views (status,
      single-thread table, loader table, zero-skip tier, rank flips)
  artifacts/bench_torch/summary_<profile>.json  — decision.recommend
      output + status counts + wall-clock

The whole sweep runs on one device: the card unless the caller asks for
the CPU (``device="cpu"``); records carry the card's name as their
``platform`` and the record files its identity (``host.fingerprint``).

Downstream consumers (paper-table views, the CI regression gate, future
perf PRs) read records — never re-measure — so results stay comparable
across commits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.bench import service_load
from repro_torch.bench.registry import (ENTROPY_PARALLEL_WORKERS,
                                        KIND_BATCHED, KIND_LOADER,
                                        KIND_SERVICE_CLOSED,
                                        KIND_SERVICE_OPEN, KIND_SINGLE,
                                        PROFILES, Profile, Scenario,
                                        select_scenarios)
from repro_torch.common.hw import host_fingerprint
from repro_torch.core import decision, report
from repro_torch.core.protocols import LoaderProtocol, SingleThreadProtocol
from repro_torch.core.schema import RunRecord, save_records, validate_record
from repro_torch.device import DeviceLike, current_device, use_device
from repro_torch.jpeg.corpus import (build_corpus, corpus_fingerprint,
                                     load_corpus_shards,
                                     write_corpus_shards)
from repro_torch.obs import trace as obs_trace
from repro_torch.store import ShardError, manifest_path

# beside the reference's artifacts/bench, never over it
DEFAULT_OUT = os.path.join("artifacts", "bench_torch")


@dataclasses.dataclass
class SweepResult:
    profile: str
    records: List[RunRecord]
    elapsed_s: float
    out_dir: Optional[str]
    files: List[str]
    trace_path: Optional[str] = None

    def ok_records(self) -> List[RunRecord]:
        return [r for r in self.records if r.ok]


def _skip_record(s: Scenario, reason: str, platform: str) -> RunRecord:
    return RunRecord(
        platform=platform, decoder=s.path or "service",
        protocol=s.kind, workers=s.workers, mode=s.mode,
        throughput_mean=0.0, throughput_std=0.0, samples=[],
        meta={"status": "skipped", "reason": reason, "scenario": s.name})


def _error_record(s: Scenario, err: BaseException,
                  platform: str) -> RunRecord:
    return RunRecord(
        platform=platform, decoder=s.path or "service",
        protocol=s.kind, workers=s.workers, mode=s.mode,
        throughput_mean=0.0, throughput_std=0.0, samples=[],
        meta={"status": "error", "scenario": s.name,
              "reason": f"{type(err).__name__}: {err}"})


class _SweepContext:
    """Lazily-built shared state (corpus, protocol instances, shard
    ingest, request stream) so a --only run pays only for what it
    touches."""

    def __init__(self, profile: Profile, platform: str,
                 out_dir: Optional[str] = None,
                 shard_dir: Optional[str] = None):
        self.profile = profile
        self.platform = platform
        self.out_dir = out_dir
        self._shard_dir = shard_dir
        self._tmp_shards = None
        self._shard_source = None
        self._corpus = None
        self._corpora: Dict[str, object] = {}
        self._single = None
        self._singles: Dict[str, SingleThreadProtocol] = {}
        self._loaders: Dict[Tuple[str, str], LoaderProtocol] = {}
        self._stream = None
        self.peak_closed_ips = 0.0

    @property
    def corpus(self):
        if self._corpus is None:
            self._corpus = build_corpus(
                self.profile.corpus_n, seed=self.profile.corpus_seed,
                restart_intervals=list(self.profile.corpus_dri) or None)
        return self._corpus

    @property
    def shard_dir(self) -> str:
        if self._shard_dir is None:
            if self.out_dir:
                self._shard_dir = os.path.join(self.out_dir, "shards")
            else:
                self._tmp_shards = tempfile.TemporaryDirectory(
                    prefix="bench-shards-")
                self._shard_dir = self._tmp_shards.name
        return self._shard_dir

    @property
    def shard_source(self):
        """The storage-backed twin of ``corpus``: reuse an existing
        ingest when the directory already holds a manifest (the CI path:
        ``python -m repro_torch.bench ingest`` ran first), else ingest
        in-context. Either
        way the fingerprint must match the profile corpus — a shard
        cell must decode byte-identical records to its memory twin, or
        the comparison is meaningless."""
        if self._shard_source is None:
            root = self.shard_dir
            if not os.path.exists(manifest_path(root)):
                write_corpus_shards(self.corpus, root)
            src = load_corpus_shards(root)
            want = corpus_fingerprint(self.corpus)
            if src.fingerprint != want:
                raise ShardError(
                    f"shard corpus at {root} has fingerprint "
                    f"{src.fingerprint}, but profile "
                    f"{self.profile.name!r} (n={self.profile.corpus_n}, "
                    f"seed={self.profile.corpus_seed}) needs {want}; "
                    "re-ingest with `python -m repro_torch.bench ingest`")
            self._shard_source = src
        return self._shard_source

    def loader(self, mode: str, source: str = "memory") -> LoaderProtocol:
        key = (mode, source)
        if key not in self._loaders:
            self._loaders[key] = LoaderProtocol(
                self.corpus, repeats=self.profile.loader_repeats,
                mode=mode, platform=self.platform,
                source=self.shard_source if source == "shard" else None,
                source_name=source)
        return self._loaders[key]

    @property
    def single(self) -> SingleThreadProtocol:
        if self._single is None:
            self._single = SingleThreadProtocol(
                self.corpus, repeats=self.profile.st_repeats,
                platform=self.platform)
        return self._single

    def corpus_for(self, kind: str):
        """The corpus-axis variants of the profile corpus: same n, seed,
        and DRI pool, differing only in the progressive fraction (mixed
        = half the non-rare images, progressive = all of them)."""
        if kind == "baseline":
            return self.corpus
        if kind not in self._corpora:
            frac = {"mixed": 0.5, "progressive": 1.0}[kind]
            self._corpora[kind] = build_corpus(
                self.profile.corpus_n, seed=self.profile.corpus_seed,
                restart_intervals=list(self.profile.corpus_dri) or None,
                progressive=frac)
        return self._corpora[kind]

    def single_for(self, kind: str) -> SingleThreadProtocol:
        if kind == "baseline":
            return self.single
        if kind not in self._singles:
            self._singles[kind] = SingleThreadProtocol(
                self.corpus_for(kind), repeats=self.profile.st_repeats,
                platform=self.platform, corpus_kind=kind)
        return self._singles[kind]

    def close(self) -> None:
        if self._shard_source is not None:
            self._shard_source.close()
            self._shard_source = None
        if self._tmp_shards is not None:
            self._tmp_shards.cleanup()
            self._tmp_shards = None

    @property
    def stream(self):
        if self._stream is None:
            self._stream = service_load.request_stream(
                self.corpus, self.profile.service_requests,
                seed=self.profile.corpus_seed + 1)
        return self._stream


def _run_scenario(s: Scenario, ctx: _SweepContext) -> RunRecord:
    if s.kind == KIND_SINGLE:
        rec = ctx.single_for(s.corpus).run_path(
            s.path,
            entropy_workers=(ENTROPY_PARALLEL_WORKERS
                             if s.entropy == "parallel" else 0))
        if s.corpus != "baseline":
            rec.meta["corpus"] = s.corpus
        return rec
    if s.kind == KIND_LOADER:
        rec = ctx.loader(s.mode, s.source).run_path(s.path, s.workers)
        if s.source == "shard":
            rec.meta["corpus_fingerprint"] = ctx.shard_source.fingerprint
            if ctx._tmp_shards is None:
                # only record a manifest path that outlives the sweep;
                # a temp-dir ingest (out_dir=None) is deleted on close
                rec.meta["shard_manifest"] = manifest_path(ctx.shard_dir)
        return rec
    if s.kind == KIND_BATCHED:
        r = service_load.batched_vs_serial(
            ctx.corpus, n_requests=ctx.profile.batched_requests,
            seed=3, path_name=s.path)
        return RunRecord(
            platform=ctx.platform, decoder=s.path, protocol=KIND_BATCHED,
            workers=0, mode="", throughput_mean=r["batched_ips"],
            throughput_std=0.0, samples=[r["batched_ips"]],
            num_images=r["n_requests"],
            meta={"serial_ips": r["serial_ips"], "ratio": r["ratio"],
                  "n_buckets": r["n_buckets"]})
    if s.kind == KIND_SERVICE_CLOSED:
        r = service_load.closed_loop(ctx.stream, s.workers)
        ctx.peak_closed_ips = max(ctx.peak_closed_ips, r["throughput_ips"])
        return RunRecord(
            platform=ctx.platform, decoder="service",
            protocol=KIND_SERVICE_CLOSED, workers=s.workers, mode=s.mode,
            throughput_mean=r["throughput_ips"], throughput_std=0.0,
            samples=[r["throughput_ips"]], num_images=len(ctx.stream),
            meta={"router_best": r["router_best"],
                  "cache_hits": r["cache_hits"], "p99_s": r["p99_s"]})
    if s.kind == KIND_SERVICE_OPEN:
        # offered rate pinned above capacity: the overload regime. Use the
        # sweep's own measured closed-loop peak when available, else the
        # serial baseline, as the capacity estimate.
        cap = ctx.peak_closed_ips or service_load.serial_baseline(ctx.stream)
        r = service_load.open_loop(ctx.stream, s.workers,
                                   offered_rps=1.5 * cap)
        return RunRecord(
            platform=ctx.platform, decoder="service",
            protocol=KIND_SERVICE_OPEN, workers=s.workers, mode=s.mode,
            throughput_mean=r["delivered_ips"], throughput_std=0.0,
            samples=[r["delivered_ips"]], num_images=len(ctx.stream),
            meta={"offered_rps": r["offered_rps"],
                  "shed_frac": r["shed_frac"], "p99_s": r["p99_s"]})
    raise ValueError(f"unknown scenario kind {s.kind!r}")


def run_sweep(profile: str = "quick", *, only: Optional[List[str]] = None,
              out_dir: Optional[str] = DEFAULT_OUT,
              shard_dir: Optional[str] = None,
              platform: Optional[str] = None,
              trace: bool = False,
              progress=None,
              device: Optional[DeviceLike] = None) -> SweepResult:
    """Execute the scenario matrix under ``profile``.

    ``only`` restricts the sweep to matching scenarios (see
    registry.select_scenarios); unmatched cells are omitted entirely.
    Cells matched but outside the profile's budget become explicit
    skipped records. Scenario failures become error records — one broken
    path must not take down the sweep that measures the other thirteen.

    The sweep runs inside ``use_device(device)`` when ``device`` is
    given, else on the device the calling context selected (the card by
    default); with a card selected and none visible it raises before
    any cell runs. ``platform`` labels every record: by default the
    card's name on the card and ``"live-host"`` on the CPU.

    Storage-backed (``source == "shard"``) cells read the profile corpus
    through the ``repro_torch.store`` shard store: from ``shard_dir``
    when it already holds a matching ingest (``python -m
    repro_torch.bench ingest``), else ingested on first touch into
    ``<out_dir>/shards`` (a temp dir when ``out_dir`` is None).

    ``trace=True`` attaches a ``repro_torch.obs`` tracer to every
    measured cell: each measured record's ``meta.stage_s`` carries the
    per-stage wall-time breakdown (parse/entropy/transform/queue-wait/...),
    and the merged Chrome trace-event artifact ``trace_<profile>.json`` —
    loader-worker process timelines aligned against the main process —
    is written next to the record JSON (Perfetto-loadable).
    """
    if device is not None:
        with use_device(device):
            return run_sweep(profile, only=only, out_dir=out_dir,
                             shard_dir=shard_dir, platform=platform,
                             trace=trace, progress=progress)
    dev = current_device()
    if platform is None:
        platform = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "live-host")
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; "
                         f"valid: {sorted(PROFILES)}")
    prof = PROFILES[profile]
    scenarios = select_scenarios(only)
    ctx = _SweepContext(prof, platform, out_dir=out_dir,
                        shard_dir=shard_dir)
    records: List[RunRecord] = []
    trace_events: List[dict] = []
    trace_tmp = None
    trace_root = None
    if trace:
        if out_dir:
            trace_root = os.path.join(out_dir, "trace_shards")
        else:
            trace_tmp = tempfile.TemporaryDirectory(prefix="bench-trace-")
            trace_root = trace_tmp.name
    t_start = time.perf_counter()
    try:
        for s in scenarios:
            run_it, reason = prof.wants(s)
            if not run_it:
                records.append(_skip_record(s, reason, platform))
                continue
            tracer = None
            if trace:
                # one tracer (and shard dir) per cell: pool workers of
                # one scenario can never bleed spans into another's
                # stage_s accounting
                tracer = obs_trace.Tracer(shard_dir=os.path.join(
                    trace_root, _scenario_file(s.name)[:-len(".json")]))
            t0 = time.perf_counter()
            try:
                if tracer is not None:
                    with obs_trace.use_tracer(tracer):
                        rec = _run_scenario(s, ctx)
                else:
                    rec = _run_scenario(s, ctx)
                # ineligible cells (e.g. CUDA paths x process pool) already
                # arrive as schema "skipped" records from the protocols —
                # everything else measured is ok
                rec.meta.setdefault("status", "ok")
                rec.meta["scenario"] = s.name
                # 6 decimals: single-image smoke cells finish in well
                # under a millisecond — 3 decimals erased them entirely
                rec.meta["elapsed_s"] = round(time.perf_counter() - t0, 6)
                if tracer is not None:
                    cell_events = tracer.collect()
                    rec.meta["stage_s"] = obs_trace.stage_seconds(
                        cell_events)
                    trace_events.extend(cell_events)
            except Exception as e:             # noqa: BLE001 — isolate cell
                rec = _error_record(s, e, platform)
            validate_record(rec.to_json())
            records.append(rec)
            if progress is not None:
                progress(s, rec)
    finally:
        ctx.close()
        if trace_tmp is not None:
            trace_tmp.cleanup()
    elapsed = time.perf_counter() - t_start
    files = []
    trace_path = None
    if out_dir:
        files = _save(records, prof, elapsed, out_dir,
                      trace_events=trace_events if trace else None)
        if trace:
            trace_path = files[-1]
    return SweepResult(profile=profile, records=records,
                       elapsed_s=elapsed, out_dir=out_dir, files=files,
                       trace_path=trace_path)


# ---------------------------------------------------------------- artifacts
def _scenario_file(name: str) -> str:
    return name.replace("/", "__") + ".json"


def _save(records: List[RunRecord], prof: Profile, elapsed: float,
          out_dir: str,
          trace_events: Optional[List[dict]] = None) -> List[str]:
    os.makedirs(os.path.join(out_dir, "scenarios"), exist_ok=True)
    files = []

    combined = os.path.join(out_dir, f"records_{prof.name}.json")
    save_records(records, combined,
                 extra={"profile": prof.name,
                        "elapsed_s": round(elapsed, 3)})
    files.append(combined)

    for r in records:
        p = os.path.join(out_dir, "scenarios",
                         _scenario_file(r.scenario))
        save_records([r], p, extra={"profile": prof.name})
        files.append(p)

    rec = decision.recommend(records)
    summary = {
        "profile": prof.name,
        "elapsed_s": round(elapsed, 3),
        "budget_s": prof.budget_s,
        "host": host_fingerprint(),
        "status_counts": _status_counts(records),
        "tier": [dataclasses.asdict(t) for t in rec["tier"]],
        "best_mean": rec.get("best_mean"),
        "best_floor": rec.get("best_floor"),
        "protocol_disagreement": rec["protocol_disagreement"],
    }
    sp = os.path.join(out_dir, f"summary_{prof.name}.json")
    with open(sp, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    files.append(sp)

    rp = os.path.join(out_dir, f"report_{prof.name}.md")
    with open(rp, "w") as f:
        f.write(render_report(records, summary))
    files.append(rp)

    if trace_events is not None:
        # last element by contract: run_sweep reads files[-1] as the
        # trace artifact path
        tp = os.path.join(out_dir, f"trace_{prof.name}.json")
        obs_trace.write_chrome_trace(tp, trace_events)
        files.append(tp)
    return files


def _status_counts(records: List[RunRecord]) -> Dict[str, int]:
    out = {"ok": 0, "skipped": 0, "error": 0}
    for r in records:
        out[r.status] = out.get(r.status, 0) + 1
    return out


def render_report(records: List[RunRecord], summary: dict) -> str:
    """The derived markdown report: scenario accounting + the paper's
    decision views, regenerated from records only."""
    host = summary["host"]
    live = [r for r in records if r.ok]
    tier = decision.robust_tier(records, floor=0.5)
    parts = [
        f"# Bench sweep — profile `{summary['profile']}`",
        "",
        f"Host: {host['cpu_model']} ({host['cpus']} cpus, "
        f"{host['machine']}) — fingerprint `{host['fingerprint']}` — "
        f"python {host['python']}, torch {host['torch']}, "
        f"CUDA {host['cuda']}, numpy {host['numpy']}",
        f"Device: {host['device']}, power limit {host['power_limit']}",
        f"Wall clock: {summary['elapsed_s']:.1f}s "
        f"(budget {summary['budget_s']:.0f}s)",
        "",
        "*Per-stage timelines: re-run with `python -m repro_torch.bench "
        "sweep --trace` to get `trace_<profile>.json` (Chrome trace-event "
        "format; open in Perfetto or chrome://tracing) plus a "
        "`meta.stage_s` breakdown on every measured record.*",
        "",
        "## Scenario status",
        report.status_report(records),
        "",
        "## Single-thread protocol",
        report.single_thread_report(live),
        "",
        "## DataLoader protocol",
        report.loader_report(live),
        "",
        "## Zero-skip tier (floor 50%)",
        report.tier_report(tier),
        "",
        "## Protocol disagreement (single-thread vs loader rank)",
        report.flip_report(summary["protocol_disagreement"]),
        "",
    ]
    norm = {}
    peaks = decision.peak_loader_throughput(records)
    for plat, by_dec in peaks.items():
        norm[plat] = decision.normalized(by_dec)
    if norm:
        parts.append("## Normalized loader throughput "
                     "(1.0 = platform-local winner)")
        for plat, vals in sorted(norm.items()):
            rows = [[d, f"{v:.3f}"] for d, v in
                    sorted(vals.items(), key=lambda kv: -kv[1])]
            parts.append(report.md_table(["decoder", f"{plat}"], rows))
            parts.append("")
    np_note = ("\n*(speedups <= 1 are expected on few-vCPU hosts; the "
               "protocol — not this host's numbers — is the artifact)*\n")
    parts.append(np_note)
    return "\n".join(parts)
