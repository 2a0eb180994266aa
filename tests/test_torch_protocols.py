"""The paper's protocols in the port, held against the reference's.

The same seeded corpus goes through both packages'
``SingleThreadProtocol``, ``LoaderProtocol`` and ``WorkerSweep``: the
records must agree in every field but the timings (throughput means,
spreads and samples, and the loader's latency percentiles). The skip
envelope of an ineligible cell has the same shape in both; its reason
names the engine that is not fork-safe (jax in the reference, torch or
CUDA in the port). ``report.*`` must give the same text on the same
records, and the copied ``paper_data``, ``selectors`` and
``configs.paper_workload`` must equal their originals.

Everything runs on the CPU under ``use_device("cpu")``.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.configs import paper_workload as jpaper_workload
from repro.core import paper_data as jpaper_data
from repro.core import protocols as jprotocols
from repro.core import report as jreport
from repro.core import selectors as jselectors
from repro.core.decision import TierEntry as JTierEntry
from repro.core.schema import RunRecord as JRunRecord
from repro_torch import core, device
from repro_torch.configs import paper_workload
from repro_torch.core import paper_data, protocols, report, selectors
from repro_torch.core.decision import TierEntry
from repro_torch.core.schema import RunRecord
from repro_torch.jpeg.corpus import build_corpus
from repro_torch.store import ShardSource

TIMINGS = ("throughput_mean", "throughput_std", "samples")
LOADER_TIMINGS = ("latency_p50_s", "latency_p99_s")


@pytest.fixture(autouse=True)
def _on_cpu():
    with device.use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def small():
    """Eight images and the rare YCCK one: the smallest corpus with a
    strict skip and more than one loader batch."""
    return build_corpus(8, seed=3)


def _fields(rec) -> dict:
    """A record without its timings; ``samples`` keeps its length."""
    d = rec.to_json()
    d["n_samples"] = len(d["samples"])
    for key in TIMINGS:
        d.pop(key)
    loader = dict(d["meta"].get("loader", {}))
    for key in LOADER_TIMINGS:
        loader.pop(key, None)
    if "loader" in d["meta"]:
        d["meta"] = dict(d["meta"], loader=loader)
    return d


def _timed(rec, repeats):
    assert len(rec.samples) == repeats
    assert all(s > 0 for s in rec.samples)
    assert rec.throughput_mean > 0


# ------------------------------------------------------------ single-thread
@pytest.mark.parametrize("path", ["numpy-fast", "strict-fast"])
def test_single_thread_records_match_the_references(small, path):
    got = protocols.SingleThreadProtocol(small, repeats=2).run_path(path)
    want = jprotocols.SingleThreadProtocol(small, repeats=2).run_path(path)
    _timed(got, 2)
    assert _fields(got) == _fields(want)
    skips = [small.rare_index] if path == "strict-fast" else []
    assert got.skip_indices == skips
    assert got.meta["delivered"] == len(small.files) - len(skips)


def test_single_thread_entropy_axis_matches_the_references(small):
    got = protocols.SingleThreadProtocol(small, repeats=1, warmup=False) \
        .run_path("numpy-fast", entropy_workers=2)
    want = jprotocols.SingleThreadProtocol(small, repeats=1, warmup=False) \
        .run_path("numpy-fast", entropy_workers=2)
    assert got.meta["entropy"]["requested"] == 2
    assert _fields(got) == _fields(want)


def test_single_thread_ineligible_cell_gives_the_references_envelope(small):
    kw = dict(repeats=1, corpus_kind="progressive", platform="p")
    got = protocols.SingleThreadProtocol(small, **kw).run_path("strict-fast")
    want = jprotocols.SingleThreadProtocol(small, **kw) \
        .run_path("strict-fast")
    assert got.status == "skipped" and got.samples == []
    assert got.to_json() == want.to_json()


def test_single_thread_runs_the_ports_paths(small):
    """The card's paths run their plain versions here; the record
    carries the port's engine names."""
    recs = protocols.SingleThreadProtocol(small, repeats=1, warmup=False) \
        .run(["torch-batch", "cuda-batch", "strict-cuda"])
    assert [r.meta["engine"] for r in recs] == ["torch", "cuda", "cuda"]
    assert [r.skip_indices for r in recs] == [[], [], [small.rare_index]]
    assert all(r.ok and r.throughput_mean > 0 for r in recs)


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_worker_sweep_records_match_the_references(small, mode):
    kw = dict(repeats=1, batch_size=4, mode=mode, platform="p")
    got = protocols.WorkerSweep(small, **kw).run(["numpy-fast",
                                                  "strict-fast"],
                                                 workers=(0, 2))
    want = jprotocols.WorkerSweep(small, **kw).run(["numpy-fast",
                                                    "strict-fast"],
                                                   workers=(0, 2))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    for r in got:
        _timed(r, 1)
        assert r.skip_indices == ([small.rare_index]
                                  if r.decoder == "strict-fast" else [])


@pytest.mark.parametrize("path", ["torch-batch", "cuda-batch"])
def test_ineligible_loader_cell_gives_the_references_envelope(small, path):
    """Process mode refuses the port's torch and CUDA paths as the
    reference refuses its jax paths: the same envelope, whose reason and
    engine name the engine that is not fork-safe."""
    kw = dict(repeats=1, mode="process", platform="p")
    got = protocols.LoaderProtocol(small, **kw).run_path(path, 2)
    want = jprotocols.LoaderProtocol(small, **kw).run_path("jnp-batch", 2)
    assert got.status == want.status == "skipped"
    assert got.samples == want.samples == []
    g, w = got.to_json(), want.to_json()
    assert g.pop("decoder") == path and w.pop("decoder") == "jnp-batch"
    gm, wm = g.pop("meta"), w.pop("meta")
    assert g == w
    assert set(gm) == set(wm)
    assert gm["engine"] == path.split("-")[0] and wm["engine"] == "jnp"
    for m in (gm, wm):
        assert m["reason"].startswith("not process-loader eligible: engine")
    assert {k: v for k, v in gm.items() if k not in ("reason", "engine")} \
        == {k: v for k, v in wm.items() if k not in ("reason", "engine")}


def test_loader_protocol_over_shards_matches_the_references(small, tmp_path):
    from repro.jpeg.corpus import load_corpus_shards as jload
    from repro_torch.jpeg.corpus import write_corpus_shards
    root = str(tmp_path / "shards")
    write_corpus_shards(small, root, shard_size=4)
    kw = dict(repeats=1, batch_size=4, platform="p", source_name="shards")
    got = protocols.LoaderProtocol(small, source=ShardSource(root), **kw) \
        .run_path("strict-fast", 2)
    want = jprotocols.LoaderProtocol(small, source=jload(root), **kw) \
        .run_path("strict-fast", 2)
    assert got.meta["source"] == "shards"
    assert _fields(got) == _fields(want)


def test_the_thread_sweep_runs_the_ports_paths(small):
    recs = protocols.WorkerSweep(small, repeats=1, batch_size=4).run(
        ["torch-batch", "cuda-batch"], workers=(0, 2))
    assert [(r.decoder, r.workers) for r in recs] == [
        ("torch-batch", 0), ("torch-batch", 2), ("cuda-batch", 0),
        ("cuda-batch", 2)]
    for r in recs:
        assert r.ok and r.skip_indices == []
        assert r.meta["delivered"] == len(small.files)


# ----------------------------------------------------------------- reports
def _records(cls, seed):
    rng = np.random.RandomState(seed)
    out = []
    for plat in ("p0", "p1"):
        for d in ("cuda-batch", "numpy-fast", "strict-fast"):
            for proto, workers, mode in (("single_thread", 0, ""),
                                         ("dataloader", 0, "thread"),
                                         ("dataloader", 2, "thread"),
                                         ("dataloader", 8, "process")):
                samples = list(rng.uniform(5, 150, 3))
                meta = {"engine": d.split("-")[0]}
                if mode == "process" and d == "cuda-batch":
                    meta.update(status="skipped", eligible=False,
                                reason="not process-loader eligible")
                    samples = []
                out.append(cls(
                    platform=plat, decoder=d, protocol=proto,
                    workers=workers, mode=mode,
                    throughput_mean=float(np.mean(samples or [0.0])),
                    throughput_std=float(np.std(samples or [0.0])),
                    samples=samples, num_images=33,
                    skip_indices=[32] if d == "strict-fast" else [],
                    meta=meta))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_reports_give_the_references_text(seed):
    port, ref = _records(RunRecord, seed), _records(JRunRecord, seed)
    for name in ("single_thread_report", "loader_report", "status_report"):
        text = getattr(report, name)(port)
        assert text == getattr(jreport, name)(ref), name
        assert text.count("\n") > 2
    tier = [TierEntry("a", 1.0, 0.95, 1.0, "2/2"),
            TierEntry("b", 0.9312, 0.9, 0.96, "2/2")]
    jtier = [JTierEntry(**dataclasses.asdict(t)) for t in tier]
    assert report.tier_report(tier) == jreport.tier_report(jtier)
    flips = {"p0": {"single_leader": "cuda-batch",
                    "loader_leader": "numpy-fast", "rho": -0.5,
                    "single_leader_gap": 0.61,
                    "largest_move": ("cuda-batch", 1, 2)},
             "p1": {"single_leader": "a", "loader_leader": "a", "rho": 1.0,
                    "single_leader_gap": 0.0, "largest_move": ("", 0, 0)}}
    assert report.flip_report(flips) == jreport.flip_report(flips)
    entries = [types.SimpleNamespace(scenario="s", old_mean=10.0,
                                     new_mean=12.5, ratio=1.25,
                                     threshold=0.05, verdict="ok"),
               types.SimpleNamespace(scenario="t", old_mean=3.0,
                                     new_mean=0.0, ratio=None,
                                     threshold=0.5, verdict="missing")]
    assert report.compare_report(entries) == jreport.compare_report(entries)
    assert report.md_table(["a"], [[1], [2]]) == \
        jreport.md_table(["a"], [[1], [2]])


def test_reports_of_live_records_match_the_references(small):
    recs = protocols.SingleThreadProtocol(small, repeats=1, platform="p") \
        .run(["numpy-fast", "strict-fast"]) + \
        protocols.WorkerSweep(small, repeats=1, platform="p",
                              mode="process").run(["numpy-fast",
                                                   "cuda-batch"],
                                                  workers=(0, 2))
    jrecs = [JRunRecord.from_json(r.to_json()) for r in recs]
    for name in ("single_thread_report", "loader_report", "status_report"):
        assert getattr(report, name)(recs) == getattr(jreport, name)(jrecs)
    assert "| dataloader | 3 | 1 | 0 |" in report.status_report(recs)


# ------------------------------------------------------------------ copies
def _public(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and not callable(v)}


def test_paper_data_equals_the_references():
    mine, theirs = _public(paper_data), _public(jpaper_data)
    assert mine.keys() == theirs.keys()
    assert len(mine) > 10
    for key in mine:
        assert mine[key] == theirs[key], key
    for plat in paper_data.PLATFORMS:
        for dec in paper_data.DECODERS:
            assert paper_data.implied_peak(plat, dec) == \
                jpaper_data.implied_peak(plat, dec)


def test_selectors_equal_the_references():
    for spec in (None, "", " a, b ,,c ", ["a,b", "c"], ("x",), "a,a"):
        assert selectors.split_tokens(spec) == jselectors.split_tokens(spec)
        assert selectors.parse_selector(spec) == \
            jselectors.parse_selector(spec)
    valid = ["a", "b", "c"]
    assert selectors.parse_selector("a,c", valid=valid) == \
        jselectors.parse_selector("a,c", valid=valid)
    with pytest.raises(selectors.SelectorError) as mine:
        selectors.parse_selector("a,zz", valid=valid, what="table")
    with pytest.raises(jselectors.SelectorError) as theirs:
        jselectors.parse_selector("a,zz", valid=valid, what="table")
    assert str(mine.value) == str(theirs.value)
    assert issubclass(selectors.SelectorError, ValueError)


def test_paper_workload_config_equals_the_references():
    assert dataclasses.asdict(paper_workload.DEFAULT) == \
        dataclasses.asdict(jpaper_workload.DEFAULT)
    assert dataclasses.asdict(paper_workload.imagenet_val()) == \
        dataclasses.asdict(jpaper_workload.imagenet_val())
    assert paper_workload.DEFAULT.worker_counts == \
        protocols.WorkerSweep.WORKERS


def test_core_exports_the_protocol_modules():
    for name in ("decision", "paper_data", "protocols", "report", "schema",
                 "selectors", "stats"):
        assert getattr(core, name).__name__ == f"repro_torch.core.{name}"
