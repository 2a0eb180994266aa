"""The port's bench harness (``repro_torch.bench``) against the
reference's (``repro.bench``) on the CPU, at smoke size: the scenario
registry and profiles, scenario selection, the compare gate on the same
record sets, a CPU sweep over the cells both smoke profiles run, the
port's own smoke sweep (``device="cpu"``: every path's plain version),
the service load's threads, and the CLI's exit codes. Mirrors
tests/test_bench.py where the two packages share behaviour."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.bench import compare as jcompare
from repro.bench import harness as jharness
from repro.bench import registry as jregistry
from repro.core import schema as jschema
from repro_torch.bench import (PROFILES, BenchSelectionError, cli,
                               build_registry, compare_records, run_sweep,
                               select_scenarios, service_load)
from repro_torch.bench import compare, registry
from repro_torch.codecs import decoder_names, list_decoders
from repro_torch.core import schema
from repro_torch.core.schema import RunRecord
from repro_torch.device import selected_device, use_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: decoders both registries hold, with the same name and capabilities
SHARED = ("numpy-ref", "numpy-fast", "numpy-int", "numpy-sparse",
          "fft-idct", "strict-fast")
#: the cells both smoke profiles run (as --only tokens)
BOTH_SMOKE = ["single/numpy-fast", "loader/numpy-fast/w2/process",
              "single/strict-fast/corpus-progressive"]


def _fields(scenarios, path):
    return [dataclasses.asdict(s) for s in scenarios if s.path == path]


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("path", SHARED)
def test_shared_decoders_get_the_references_scenarios(path):
    assert path in decoder_names()
    assert _fields(build_registry(), path) == \
        _fields(jregistry.build_registry(), path)


def _shape(scenarios, path):
    return [(s.name.replace(path, "<p>"), s.kind, s.workers, s.mode,
             s.source, s.entropy, s.corpus)
            for s in scenarios if s.path == path]


@pytest.mark.parametrize("path", decoder_names())
def test_every_port_path_gets_the_references_per_path_shape(path):
    """A path's cells depend only on its capabilities: a batchable port
    path is shaped like ``jnp-fused``, the others like ``numpy-fast``."""
    spec = {s.name: s for s in list_decoders()}[path]
    like = "jnp-fused" if spec.caps.batchable else "numpy-fast"
    assert spec.caps.parallel_entropy
    assert _shape(build_registry(), path) == \
        _shape(jregistry.build_registry(), like)


def test_registry_covers_the_matrix_and_service_cells():
    scenarios = build_registry()
    names = [s.name for s in scenarios]
    assert len(names) == len(set(names))
    assert {s.path for s in scenarios if s.path} == set(decoder_names())
    assert len(decoder_names()) == 14
    assert [dataclasses.asdict(s) for s in scenarios if not s.path] == \
        [dataclasses.asdict(s) for s in jregistry.build_registry()
         if not s.path]
    assert (registry.WORKER_SWEEP, registry.POOL_MODES, registry.SOURCES,
            registry.ENTROPY_PARALLEL_WORKERS) == \
        (jregistry.WORKER_SWEEP, jregistry.POOL_MODES, jregistry.SOURCES,
         jregistry.ENTROPY_PARALLEL_WORKERS)
    assert {s.kind for s in scenarios} == {
        jregistry.KIND_SINGLE, jregistry.KIND_LOADER, jregistry.KIND_BATCHED,
        jregistry.KIND_SERVICE_CLOSED, jregistry.KIND_SERVICE_OPEN}
    assert registry.scenario_names() == names


# --------------------------------------------------- profiles and selection
@pytest.mark.parametrize("profile", ["smoke", "quick", "full"])
def test_profiles_want_the_references_cells_for_shared_paths(profile):
    """Both packages run and skip the same cells of every decoder they
    share and of the service, with the same reason."""
    mine, ref = PROFILES[profile], jregistry.PROFILES[profile]
    for s in build_registry():
        if s.path and s.path not in SHARED:
            continue
        assert mine.wants(s) == ref.wants(s), s.name
    for field in ("corpus_n", "corpus_seed", "st_repeats", "loader_repeats",
                  "service_requests", "batched_requests", "service_closed",
                  "service_open", "budget_s", "corpus_dri"):
        assert getattr(mine, field) == getattr(ref, field), field


def test_the_smoke_profile_runs_the_cuda_paths():
    prof = PROFILES["smoke"]
    runs = {s.name for s in build_registry() if prof.wants(s)[0]}
    singles = {s.name for s in build_registry()
               if s.kind == registry.KIND_SINGLE and s.entropy == "serial"
               and s.corpus == "baseline"}
    assert singles <= runs and len(singles) == 14
    assert runs - singles == {
        "loader/numpy-fast/w0/thread", "loader/numpy-fast/w2/thread",
        "loader/cuda-batch/w0/thread", "loader/cuda-batch/w2/thread",
        "loader/numpy-fast/w2/process",
        "loader/numpy-fast/w2/process/shard",
        "loader/cuda-batch/w2/process",
        "batched/cuda-batch", "service/closed/w2",
        "single/numpy-fast/entropy-par", "single/cuda-batch/entropy-par",
        "single/cuda-fused/corpus-mixed",
        "single/strict-fast/corpus-progressive",
        "single/strict-cuda/corpus-progressive"}


def test_quick_reads_jnp_as_torch_and_full_stays_open():
    mine, ref = PROFILES["quick"], jregistry.PROFILES["quick"]

    def port_name(name):
        return {"strict-turbo": "strict-torch"}.get(
            name, name.replace("jnp-", "torch-").replace("pallas-", "cuda-"))
    ported = {port_name(p) for p in ref.single_paths} & \
        set(decoder_names())
    assert mine.single_paths == ported
    assert mine.batched_paths == {port_name(p) for p in ref.batched_paths}
    assert mine.single_entropy == {port_name(p)
                                   for p in ref.single_entropy}
    assert mine.single_corpus == {(port_name(p), c)
                                  for p, c in ref.single_corpus}
    assert mine.loader_cells == {
        (port_name(p), w, m, src) for p, w, m, src in ref.loader_cells
        if port_name(p) in ported}
    full = PROFILES["full"]
    assert (full.single_paths, full.loader_cells, full.batched_paths,
            full.single_entropy, full.single_corpus) == (None,) * 5


def test_select_scenarios_prefix_and_errors():
    picked = select_scenarios(["loader/numpy-fast"])
    assert picked and all(s.path == "numpy-fast" for s in picked)
    assert len(picked) == 14
    exact = select_scenarios(["single/cuda-fused"])
    assert [s.name for s in exact] == [
        "single/cuda-fused", "single/cuda-fused/entropy-par",
        "single/cuda-fused/corpus-mixed",
        "single/cuda-fused/corpus-progressive"]
    assert select_scenarios(["service/"]) == \
        [s for s in build_registry() if s.name.startswith("service/")]
    assert select_scenarios(None) == build_registry()
    with pytest.raises(BenchSelectionError,
                       match="single/numpy-ref.*python -m repro_torch"
                             ".bench list"):
        select_scenarios(["single/nvjpeg"])
    with pytest.raises(BenchSelectionError, match="Valid families"):
        select_scenarios(["single/numpy-fast", "bogus"])


# ----------------------------------------------------------------- compare
def _rec(scenario, thr=100.0, samples=None, status="ok", **kw):
    d = dict(platform="live-host", decoder=kw.get("decoder", "numpy-fast"),
             protocol=kw.get("protocol", "single_thread"),
             workers=kw.get("workers", 0), mode=kw.get("mode", ""),
             throughput_mean=thr, throughput_std=1.0,
             samples=list(samples if samples is not None
                          else [thr - 1, thr, thr + 1]),
             num_images=10, skip_indices=[],
             meta={"status": status, "scenario": scenario})
    if "stage_s" in kw:
        d["meta"]["stage_s"] = kw["stage_s"]
    return d


def _random_sets(seed, n=24):
    """Two record sets with every verdict: drops past 2x, drops inside
    the noise, gains, skips and one-sided scenarios."""
    rng = np.random.RandomState(seed)
    old, new = [], []
    for i in range(n):
        name = f"single/cell-{i:02d}"
        base = float(rng.uniform(20, 200))
        noise = float(rng.choice([0.5, 5.0, 30.0]))
        ratio = float(rng.choice([0.3, 0.6, 0.9, 0.99, 1.0, 1.2, 2.5]))
        s_old = list(base + noise * rng.randn(3))
        s_new = list(base * ratio + noise * rng.randn(3))
        kind = rng.randint(6)
        if kind == 0:
            old.append(_rec(name, 0.0, [], status="skipped"))
        elif kind == 1 and i % 2:
            new.append(_rec(name, float(np.mean(s_new)), s_new))
            continue
        else:
            old.append(_rec(name, float(np.mean(s_old)), s_old))
        if kind == 2 and not i % 2:
            continue
        new.append(_rec(name, float(np.mean(s_new)), s_new,
                        protocol="dataloader" if i % 3 else "single_thread",
                        workers=2 if i % 3 else 0,
                        mode="thread" if i % 3 else ""))
    return old, new


def _both(old, new, **kw):
    mine = compare_records([RunRecord.from_json(d) for d in old],
                           [RunRecord.from_json(d) for d in new], **kw)
    ref = jcompare.compare_records(
        [jschema.RunRecord.from_json(d) for d in old],
        [jschema.RunRecord.from_json(d) for d in new], **kw)
    return mine, ref


@pytest.mark.parametrize("seed", range(6))
def test_compare_gives_the_references_verdicts_and_markdown(seed):
    old, new = _random_sets(seed)
    hosts = dict(old_host={"fingerprint": {"fingerprint": "aaa111aaa111"}},
                 new_host={"fingerprint": {"fingerprint": "bbb222bbb222"}})
    mine, ref = _both(old, new, **hosts)
    assert [dataclasses.asdict(e) for e in mine.entries] == \
        [dataclasses.asdict(e) for e in ref.entries]
    assert {e.verdict for e in mine.entries} >= {"ok", "warn", "fail"}
    assert mine.summary_line() == ref.summary_line()
    assert "host fingerprints differ" in mine.summary_line()
    for max_rows in (3, 20):
        assert compare.summary_markdown(mine, max_rows=max_rows) == \
            jcompare.summary_markdown(ref, max_rows=max_rows)
    for warn_only in (False, True):
        assert mine.exit_code(warn_only=warn_only) == \
            ref.exit_code(warn_only=warn_only)


@pytest.mark.parametrize("change, verdict", [
    (1.0, "ok"), (0.33, "fail"), (0.84, "warn"), (1.5, "improved")])
def test_compare_gates_as_the_reference(change, verdict):
    old = [_rec("single/numpy-fast", 100.0, [99.0, 100.0, 101.0])]
    new = [_rec("single/numpy-fast", 100.0 * change,
                [100.0 * change - 1, 100.0 * change, 100.0 * change + 1])]
    mine, ref = _both(old, new)
    assert mine.entries[0].verdict == ref.entries[0].verdict == verdict
    assert mine.exit_code() == (2 if verdict == "fail" else 0)


def test_compare_attribution_matches_the_reference():
    old = [_rec("single/numpy-fast",
                stage_s={"jpeg.entropy": 0.02, "jpeg.parse": 0.05})]
    new = [_rec("single/numpy-fast", 30.0,
                stage_s={"jpeg.entropy": 0.08, "jpeg.parse": 0.05})]
    mine, ref = _both(old, new)
    o, n = ([RunRecord.from_json(d) for d in old],
            [RunRecord.from_json(d) for d in new])
    jo, jn = ([jschema.RunRecord.from_json(d) for d in old],
              [jschema.RunRecord.from_json(d) for d in new])
    assert compare.attribute_result(mine, o, n) == \
        jcompare.attribute_result(ref, jo, jn) == 1
    assert mine.entries[0].attribution == ref.entries[0].attribution == \
        "entropy 4.0x (2.00→8.00 ms/img)"
    assert compare.summary_markdown(mine) == jcompare.summary_markdown(ref)


def test_either_packages_compare_reads_either_packages_record_files(
        tmp_path):
    old, new = _random_sets(11)
    paths = {}
    for who, save, Rec in (("port", schema.save_records, RunRecord),
                           ("ref", jschema.save_records,
                            jschema.RunRecord)):
        for side, recs in (("old", old), ("new", new)):
            p = str(tmp_path / f"{who}_{side}.json")
            with use_device("cpu"):
                save([Rec.from_json(d) for d in recs], p)
            paths[who, side] = p
    for a in ("port", "ref"):
        for b in ("port", "ref"):
            mine = compare.compare_paths(paths[a, "old"], paths[b, "new"])
            ref = jcompare.compare_paths(paths[a, "old"], paths[b, "new"])
            assert [dataclasses.asdict(e) for e in mine.entries] == \
                [dataclasses.asdict(e) for e in ref.entries]
            assert mine.summary_line() == ref.summary_line()
    # a CPU run's records and a reference run's never read as one host
    cross = compare.compare_paths(paths["ref", "old"], paths["port", "new"])
    assert "host fingerprints differ" in cross.summary_line()


# ------------------------------------------------------------------- sweep
@pytest.fixture(scope="module")
def shared_sweeps(tmp_path_factory):
    """The port (on the CPU) and the reference over the cells both smoke
    profiles run."""
    out = tmp_path_factory.mktemp("shared")
    mine = run_sweep("smoke", only=BOTH_SMOKE, out_dir=str(out / "port"),
                     device="cpu")
    ref = jharness.run_sweep("smoke", only=BOTH_SMOKE,
                             out_dir=str(out / "ref"))
    return mine, ref


def test_cpu_sweep_matches_the_references_over_shared_cells(shared_sweeps):
    mine, ref = shared_sweeps

    def view(res):
        return [(r.scenario, r.status, r.meta.get("reason", ""),
                 r.num_images, r.decoder, r.protocol, r.workers, r.mode,
                 r.skip_indices, r.meta.get("delivered"),
                 r.meta.get("source"), r.meta.get("corpus_fingerprint"))
                for r in res.records]
    assert view(mine) == view(ref)
    names = {r.scenario for r in mine.records}
    assert {"single/numpy-fast", "loader/numpy-fast/w2/process",
            "loader/numpy-fast/w2/process/shard",
            "single/strict-fast/corpus-progressive"} <= names
    by = {r.scenario: r for r in mine.records}
    assert by["loader/numpy-fast/w2/process/shard"].ok
    assert by["single/strict-fast/corpus-progressive"].status == "skipped"
    assert all(r.platform == "live-host" for r in mine.records)


def test_every_record_validates_under_both_schemas(shared_sweeps):
    mine, ref = shared_sweeps
    for res in (mine, ref):
        for r in res.records:
            d = r.to_json()
            assert schema.validate_record(dict(d)) == \
                jschema.validate_record(dict(d))
        # the record files, each read by the other package's loader
        assert len(jschema.load_records(mine.files[0])) == \
            len(schema.load_records(ref.files[0])) == len(res.records)
    host = json.load(open(mine.files[0]))["host"]
    assert host["fingerprint"]["device"] == "cpu"


@pytest.fixture(scope="module")
def smoke_sweep(tmp_path_factory):
    """The port's own smoke profile on the CPU, traced: every cuda-*
    cell runs its kernels' plain versions."""
    out = str(tmp_path_factory.mktemp("bench_torch"))
    return run_sweep("smoke", out_dir=out, trace=True, device="cpu")


def test_smoke_sweep_runs_every_cell_of_the_profile(smoke_sweep):
    prof = PROFILES["smoke"]
    assert smoke_sweep.elapsed_s < prof.budget_s
    assert not [r for r in smoke_sweep.records if r.status == "error"]
    by = {r.scenario: r for r in smoke_sweep.records}
    assert set(by) == set(registry.scenario_names())
    for s in build_registry():
        r = by[s.name]
        run_it, reason = prof.wants(s)
        if not run_it:
            assert r.status == "skipped" and r.meta["reason"] == reason
        elif not r.ok:
            assert r.meta["eligible"] is False and r.meta["reason"]
        else:
            assert r.throughput_mean > 0 and "stage_s" in r.meta
    for path in decoder_names():
        assert by[f"single/{path}"].ok, path
    assert by["single/cuda-fused/corpus-mixed"].ok
    assert by["batched/cuda-batch"].ok
    assert by["service/closed/w2"].ok
    assert {r.platform for r in smoke_sweep.records} == {"live-host"}


def test_cuda_batch_process_cell_is_the_resolvers_skip(smoke_sweep):
    by = {r.scenario: r for r in smoke_sweep.records}
    fork = by["loader/cuda-batch/w2/process"]
    assert fork.status == "skipped" and fork.samples == []
    assert fork.meta["eligible"] is False
    assert "not fork-safe" in fork.meta["reason"]
    assert "fork" in fork.meta["reason"]
    skip = by["single/strict-cuda/corpus-progressive"]
    assert skip.status == "skipped" and \
        "Capabilities.progressive" in skip.meta["reason"]


def test_smoke_sweep_shard_cell_and_memory_twin(smoke_sweep):
    by = {r.scenario: r for r in smoke_sweep.records}
    shard = by["loader/numpy-fast/w2/process/shard"]
    mem = by["loader/numpy-fast/w2/process"]
    assert shard.ok and mem.ok
    assert shard.num_images == mem.num_images == PROFILES["smoke"].corpus_n
    assert shard.meta["delivered"] == mem.meta["delivered"]
    assert os.path.exists(shard.meta["shard_manifest"])
    from repro.jpeg.corpus import build_corpus, corpus_fingerprint
    assert shard.meta["corpus_fingerprint"] == corpus_fingerprint(
        build_corpus(8, seed=42))


def test_smoke_sweep_artifacts_name_the_device(smoke_sweep):
    out = smoke_sweep.out_dir
    assert out and smoke_sweep.files[0] == os.path.join(
        out, "records_smoke.json")
    assert len(jschema.load_records(smoke_sweep.files[0])) == \
        len(smoke_sweep.records)
    assert len(os.listdir(os.path.join(out, "scenarios"))) == \
        len(smoke_sweep.records)
    summary = json.load(open(os.path.join(out, "summary_smoke.json")))
    assert summary["host"]["device"] == "cpu"
    assert summary["status_counts"]["error"] == 0
    report = open(os.path.join(out, "report_smoke.md")).read()
    assert f"torch {torch.__version__}" in report
    assert "Device: cpu, power limit none" in report
    assert "## Single-thread protocol" in report and "jax" not in report
    assert smoke_sweep.trace_path == os.path.join(out, "trace_smoke.json")
    evs = json.load(open(smoke_sweep.trace_path))["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"jpeg.parse", "jpeg.entropy", "jpeg.dequant_idct",
            "loader.decode"} <= names


def test_default_out_dir_is_beside_the_references():
    import inspect
    sig = inspect.signature(run_sweep)
    assert sig.parameters["out_dir"].default == os.path.join(
        "artifacts", "bench_torch") != jharness.DEFAULT_OUT
    assert sig.parameters["device"].default is None
    assert inspect.signature(service_load.batched_vs_serial).parameters[
        "path_name"].default == "cuda-batch"


def test_sweep_without_a_card_raises_before_any_cell(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_sweep("smoke", only=["single/numpy-ref"],
                  out_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
    # a use_device scope is the other way to ask for the CPU
    with use_device("cpu"):
        res = run_sweep("smoke", only=["single/numpy-int"], out_dir=None)
    assert res.records[0].ok and res.files == []


def test_closed_loop_clients_run_on_the_selected_device(monkeypatch):
    """A use_device scope does not reach a new thread: the closed loop's
    client threads must re-enter the caller's device (the fault class
    behind the service's thread bug)."""
    seen = []

    class FakeService:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def decode(self, data, client):
            seen.append(selected_device())

        def stats(self):
            return {"router_best": "numpy-fast",
                    "service": {"cache_hits": 0,
                                "latency_s": {"p99": 0.0}}}
    monkeypatch.setattr(service_load, "make_service",
                        lambda workers: FakeService())
    with use_device("cpu"):
        r = service_load.closed_loop([b"x"] * 12, workers=2, clients=4)
    assert len(seen) == 12 and set(seen) == {torch.device("cpu")}
    assert r["throughput_ips"] > 0


def test_service_arms_are_the_references_fork_safe_set():
    """The reference's arm set (fork-safe, non-strict decoders) over the
    decoders both packages hold: a service record means the same."""
    from repro.codecs import ExecContext, list_decoders as jlist
    with use_device("cpu"):
        with service_load.make_service(0) as svc:
            arms = sorted(svc.router.snapshot())
    ref = sorted(s.name for s in jlist(context=ExecContext.PROCESS_POOL,
                                       strict=False) if s.name in SHARED)
    assert arms == ref == sorted(set(SHARED) - {"strict-fast"})


# --------------------------------------------------------------------- cli
def test_cli_exit_codes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["sweep", "--only", "bogus", "--device", "cpu"]) == 2
    assert cli.main(["nonsense"]) == 2
    assert cli.main(["tables"]) == 2            # not ported: unknown
    assert cli.main(["sweep", "--device", "bogus"]) == 2
    assert cli.main(["--smoke", "--only", "single/numpy-ref"]) == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["sweep", "--no-such-flag"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--smoke", "--full", "--device", "cpu"])
    assert "mutually exclusive" in str(e.value.code)


def test_cli_sweep_list_and_ingest(tmp_path, capsys):
    out = str(tmp_path / "out")
    assert cli.main(["--smoke", "--device", "cpu", "--only",
                     "single/numpy-int", "--out", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "scenario,status,images_per_s,detail"
    assert lines[1].startswith("single/numpy-int,ok,")
    assert os.path.exists(os.path.join(out, "records_smoke.json"))
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert listed[0] == "scenario,smoke,quick,full"
    assert len(listed) == 1 + len(build_registry())
    assert "loader/cuda-batch/w2/process,run,skip,run" in listed
    shards = str(tmp_path / "shards")
    assert cli.main(["ingest", "--smoke", "--out", shards]) == 0
    text = capsys.readouterr().out
    from repro.jpeg.corpus import build_corpus, corpus_fingerprint
    assert f"fingerprint {corpus_fingerprint(build_corpus(8, seed=42))}" \
        in text


def _records(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    base = [_rec("single/numpy-fast", 100.0, [99.0, 100.0, 101.0])]
    slow = [_rec("single/numpy-fast", 20.0, [19.0, 20.0, 21.0])]
    with use_device("cpu"):
        schema.save_records([RunRecord.from_json(d) for d in base], a)
        schema.save_records([RunRecord.from_json(d) for d in slow], b)
    return a, b


def test_cli_compare_exit_codes_in_process(tmp_path, capsys):
    a, b = _records(tmp_path)
    assert cli.main(["compare", a, a]) == 0
    assert cli.main(["compare", a, b]) == 2
    assert cli.main(["compare", a, b, "--warn-only"]) == 0
    md = str(tmp_path / "summary.md")
    assert cli.main(["compare", a, b, "--summary-md", md,
                     "--attribute"]) == 2
    assert "### Failures (1)" in open(md).read()
    assert cli.main(["compare", a, str(tmp_path / "missing.json")]) == 2
    assert "fail" in capsys.readouterr().out


def test_cli_compare_exit_codes_as_a_module(tmp_path):
    a, b = _records(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.bench", "compare", a, b]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert "fail" in proc.stdout
    proc = subprocess.run(cmd + ["--warn-only"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "warn-only: 1 failure(s) demoted" in proc.stdout


def test_bench_imports_neither_jax_nor_repro():
    code = ("import json, sys\n"
            "import repro_torch.bench, repro_torch.bench.cli\n"
            "import repro_torch.bench.service_load\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.bench.harness" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
