"""Benchmark CLI of the port — ``python -m repro_torch.bench``.

Subcommands:

  sweep    (default) run the scenario-matrix harness; emits validated
           RunRecord JSON + derived reports into artifacts/bench_torch/.
           ``--smoke`` / ``--full`` pick the profile; ``--only`` narrows
           to named scenarios (validated — typos are hard errors);
           ``--shards`` points storage-backed cells at an existing
           ingest (fingerprint-checked against the profile corpus);
           ``--device`` picks where it runs (default: the card; ``cpu``
           runs every path's plain version on the host).
  ingest   write a profile's synthetic corpus into a shard directory
           (repro_torch.store format: crc32'd shards + JSON manifest) for
           the sweep's ``source=shard`` cells — or any external consumer.
  tables   regenerate the per-paper-table CSV views (table1..5, fig3,
           kernels, roofline, service; ``repro_torch.bench.views``),
           every live row derived from one shared sweep; ``--full`` for
           the full profile and sizes, ``--only`` to narrow (validated),
           ``--device`` as for ``sweep``.
  compare  diff two record sets with noise-aware gates; exits nonzero on
           a hard (>2x by default) regression unless --warn-only.
           ``--attribute`` names the pipeline stage behind each
           regression from traced ``meta.stage_s`` rollups, preferring
           a same-host baseline from ``--history``.
  history  append a record set to (or inspect) an append-only JSONL
           history store keyed by host fingerprint — the nightly job's
           cross-run memory that stage attribution reads.
  list     print every scenario name and whether each profile runs it.

Arguments are parsed strictly: unknown flags error out instead of being
silently swallowed. Exit codes: 2 for a usage error (and for ``compare``
on a hard regression, as the reference's), 1 when a sweep cell or a
table view errors.
"""
import argparse
import sys

SUBCOMMANDS = ("sweep", "tables", "compare", "list", "ingest", "history")
TABLES = ("table1", "table2", "table3", "table4", "table5",
          "fig3", "kernels", "roofline", "service")


def _profile_from_flags(args) -> str:
    if args.smoke and args.full:
        raise SystemExit("--smoke and --full are mutually exclusive")
    if args.smoke:
        return "smoke"
    if args.full:
        return "full"
    return args.profile


def _add_profile_flags(ap) -> None:
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized profile (tiny corpus, strict budget)")
    ap.add_argument("--full", action="store_true",
                    help="full matrix: all 14 paths x {0,2,4,8} x modes")
    ap.add_argument("--profile", default="quick",
                    choices=("smoke", "quick", "full"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd")

    sw = sub.add_parser("sweep", help="run the scenario-matrix harness")
    _add_profile_flags(sw)
    sw.add_argument("--only", default=None,
                    help="comma-separated scenario names or family "
                         "prefixes (e.g. 'single,loader/numpy-fast')")
    sw.add_argument("--out", default=None,
                    help="artifact directory "
                         "(default artifacts/bench_torch)")
    sw.add_argument("--shards", default=None,
                    help="existing shard-ingest directory for "
                         "source=shard cells (default: ingest into "
                         "<out>/shards on first touch)")
    sw.add_argument("--trace", action="store_true",
                    help="attach a repro_torch.obs tracer to every "
                         "measured cell: writes trace_<profile>.json "
                         "(Chrome trace-event / Perfetto) next to the "
                         "records and a meta.stage_s breakdown per record")
    sw.add_argument("--device", default=None,
                    help="where the sweep runs, e.g. 'cpu' or 'cuda:0' "
                         "(default: the card)")

    ig = sub.add_parser("ingest",
                        help="write a profile corpus as "
                             "repro_torch.store shards + manifest")
    _add_profile_flags(ig)
    ig.add_argument("--out", required=True,
                    help="shard directory to create/populate")
    ig.add_argument("--shard-size", type=int, default=64,
                    help="records per shard file (default 64)")

    tb = sub.add_parser("tables", help="regenerate paper-table CSV views")
    tb.add_argument("--full", action="store_true",
                    help="the full profile's sweep and the full kernel "
                         "sizes")
    tb.add_argument("--only", default=None,
                    help=f"comma-separated table names from: "
                         f"{', '.join(TABLES)}")
    tb.add_argument("--device", default=None,
                    help="where the views run, e.g. 'cpu' or 'cuda:0' "
                         "(default: the card)")

    cp = sub.add_parser("compare", help="gate candidate records vs baseline")
    cp.add_argument("baseline", help="baseline record-set JSON")
    cp.add_argument("candidate", help="candidate record-set JSON")
    cp.add_argument("--fail-ratio", type=float, default=2.0,
                    help="hard-fail when throughput drops more than this "
                         "factor (default 2.0)")
    cp.add_argument("--warn-only", action="store_true",
                    help="report failures but exit 0 (bootstrap mode "
                         "while baselines stabilize)")
    cp.add_argument("--summary-md", default=None, metavar="PATH",
                    help="also write a ranked regressions/improvements "
                         "markdown table (CI appends it to "
                         "$GITHUB_STEP_SUMMARY)")
    cp.add_argument("--attribute", action="store_true",
                    help="name the stage behind each fail/warn from "
                         "traced meta.stage_s (needs sweep --trace "
                         "records on at least one side)")
    cp.add_argument("--history", default=None, metavar="PATH",
                    help="HistoryStore JSONL: prefer its newest "
                         "same-host traced run as the attribution "
                         "baseline")

    hi = sub.add_parser("history",
                        help="append to / inspect the run-history store")
    hi.add_argument("action", choices=("append", "show"))
    hi.add_argument("records", nargs="?", default=None,
                    help="record-set JSON to append (append only)")
    hi.add_argument("--store", required=True, metavar="PATH",
                    help="history JSONL path (created on first append)")
    hi.add_argument("--profile", default="",
                    help="profile tag stored with the appended run")
    hi.add_argument("--last", type=int, default=10,
                    help="show: how many newest runs to print")

    sub.add_parser("list", help="print the scenario registry")
    return ap


def _device_error(device) -> bool:
    """True (after saying why) when ``device``, or the selected device,
    cannot run: a device torch cannot parse, or a card that is not there,
    is the caller's to fix (--device cpu), not a traceback."""
    from repro_torch.device import (current_device, selected_device,
                                    use_device)
    try:
        with use_device(device or selected_device()):
            current_device()
    except RuntimeError as e:
        print(f"error: {e} (here: --device cpu)", file=sys.stderr)
        return True
    return False


def cmd_sweep(args) -> int:
    from repro_torch.bench import BenchSelectionError, run_sweep
    from repro_torch.core.selectors import parse_selector
    if _device_error(args.device):
        return 2
    # tokenize only: sweep selectors allow family *prefixes*, which the
    # bench registry validates (BenchSelectionError below)
    only = parse_selector(args.only)
    kw = {}
    if args.out:
        kw["out_dir"] = args.out
    if args.shards:
        kw["shard_dir"] = args.shards
    if args.trace:
        kw["trace"] = True
    if args.device:
        kw["device"] = args.device
    try:
        res = run_sweep(_profile_from_flags(args), only=only, **kw)
    except BenchSelectionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print("scenario,status,images_per_s,detail")
    errors = 0
    for r in res.records:
        detail = r.meta.get("reason", "") or \
            f"skips={r.skips} workers={r.workers} mode={r.mode or '-'}"
        print(f"{r.scenario},{r.status},{r.throughput_mean:.1f},{detail}")
        errors += r.status == "error"
    print(f"# profile={res.profile} scenarios={len(res.records)} "
          f"elapsed={res.elapsed_s:.1f}s artifacts={len(res.files)}",
          file=sys.stderr)
    if res.out_dir:
        print(f"# records: {res.files[0]}", file=sys.stderr)
    if res.trace_path:
        print(f"# trace: {res.trace_path}", file=sys.stderr)
    return 1 if errors else 0


def cmd_ingest(args) -> int:
    from repro_torch.bench import PROFILES
    from repro_torch.jpeg.corpus import build_corpus, write_corpus_shards
    from repro_torch.store import load_manifest
    prof = PROFILES[_profile_from_flags(args)]
    corpus = build_corpus(prof.corpus_n, seed=prof.corpus_seed,
                          restart_intervals=list(prof.corpus_dri) or None)
    manifest = write_corpus_shards(corpus, args.out,
                                   shard_size=args.shard_size)
    man = load_manifest(args.out)
    print(f"ingested {man['record_count']} records "
          f"({len(man['shards'])} shard(s), profile {prof.name!r}, "
          f"n={prof.corpus_n}, seed={prof.corpus_seed})")
    print(f"fingerprint {man['fingerprint']}")
    print(f"manifest {manifest}")
    return 0


def cmd_tables(args) -> int:
    import traceback

    from repro_torch.bench.views import VIEWS
    from repro_torch.core.selectors import SelectorError, parse_selector
    from repro_torch.device import selected_device, use_device
    try:
        only = parse_selector(args.only, valid=VIEWS, what="table")
    except SelectorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if _device_error(args.device):
        return 2
    quick = not args.full
    print("name,us_per_call,derived")
    failures = 0
    with use_device(args.device or selected_device()):
        for name, mod in VIEWS.items():
            if only and name not in only:
                continue
            try:
                for n, us, derived in mod.run(quick=quick):
                    print(f"{n},{us:.1f},{derived}")
            # one broken view must not hide the other eight
            except Exception as e:
                failures += 1
                print(f"{name}.ERROR,0.0,{type(e).__name__}: {e}")
                traceback.print_exc(file=sys.stderr)
    return 1 if failures else 0


def cmd_compare(args) -> int:
    from repro_torch.bench.compare import (attribute_result,
                                           compare_records,
                                           summary_markdown)
    from repro_torch.bench.history import HistoryStore
    from repro_torch.core.report import compare_report
    from repro_torch.core.schema import RunRecord, SchemaError, load_payload
    try:
        old_p = load_payload(args.baseline)
        new_p = load_payload(args.candidate)
        old = [RunRecord.from_json(r) for r in old_p["records"]]
        new = [RunRecord.from_json(r) for r in new_p["records"]]
        res = compare_records(old, new, fail_ratio=args.fail_ratio,
                              old_host=old_p.get("host"),
                              new_host=new_p.get("host"))
    except (OSError, SchemaError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.attribute:
        history = HistoryStore(args.history) if args.history else None
        attribute_result(res, old, new, history=history)
        for e in res.entries:
            if e.attribution:
                print(f"# attribution {e.scenario}: {e.attribution}")
    if args.summary_md:
        with open(args.summary_md, "w") as f:
            f.write(summary_markdown(res))
    gated_verdicts = ("fail", "warn", "improved", "ok")
    gated = [e for e in res.entries if e.verdict in gated_verdicts]
    print(compare_report(gated))
    other = [e for e in res.entries if e.verdict not in gated_verdicts]
    for e in other:
        print(f"# {e.scenario}: {e.verdict} ({e.detail})")
    print(res.summary_line())
    code = res.exit_code(warn_only=args.warn_only)
    if res.n_fail and args.warn_only:
        print(f"warn-only: {res.n_fail} failure(s) demoted to warnings")
    return code


def cmd_history(args) -> int:
    import time

    from repro_torch.bench.history import HistoryStore
    from repro_torch.core.schema import RunRecord, SchemaError, load_payload
    store = HistoryStore(args.store)
    if args.action == "append":
        if not args.records:
            print("error: history append needs a record-set JSON path",
                  file=sys.stderr)
            return 2
        try:
            payload = load_payload(args.records)
            records = [RunRecord.from_json(r)
                       for r in payload["records"]]
            run = store.append(records, host=payload.get("host"),
                               profile=args.profile)
        except (OSError, SchemaError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        traced = sum(1 for r in records if r.meta.get("stage_s"))
        print(f"appended run {run.run_id} (host {run.fingerprint}, "
              f"{len(records)} records, {traced} stage-traced) "
              f"to {store.path}")
        return 0
    runs, dropped = store.scan()
    print(f"{len(runs)} run(s) in {store.path}")
    if dropped:
        print(f"# {dropped} unreadable line(s) skipped (torn write or "
              "schema drift)")
    for run in runs[-max(0, args.last):]:
        traced = sum(1 for r in run.records if r.meta.get("stage_s"))
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.gmtime(run.t))
        print(f"{run.run_id}  {when}Z  host={run.fingerprint}  "
              f"profile={run.profile or '-'}  records={len(run.records)}"
              f"  stage-traced={traced}")
    return 0


def cmd_list(_args) -> int:
    from repro_torch.bench import PROFILES, build_registry
    profs = list(PROFILES.values())
    print("scenario," + ",".join(p.name for p in profs))
    for s in build_registry():
        cells = ",".join("run" if p.wants(s)[0] else "skip" for p in profs)
        print(f"{s.name},{cells}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # default subcommand: bare flags mean "sweep" (``--smoke`` alone
    # sweeps), but never swallow a typo'd first positional.
    if argv and not argv[0].startswith("-") and argv[0] not in SUBCOMMANDS:
        print(f"error: unknown command {argv[0]!r}; "
              f"valid: {', '.join(SUBCOMMANDS)}", file=sys.stderr)
        return 2
    if not argv or argv[0].startswith("-"):
        if "-h" not in argv and "--help" not in argv:
            argv.insert(0, "sweep")
    args = build_parser().parse_args(argv)
    handler = {"sweep": cmd_sweep, "tables": cmd_tables,
               "compare": cmd_compare, "list": cmd_list,
               "ingest": cmd_ingest, "history": cmd_history}[args.cmd]
    return handler(args)
