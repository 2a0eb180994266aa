"""The port's bench history store and stage attribution
(``repro_torch.bench.history``) against the reference's: tests/test_history.py
mirrored on the port, stores written by either package read by the
other, attribution notes equal on the same records, the history CLI,
and a deterministic injected-slowdown test.

The injected-slowdown test differs from the reference's
(tests/test_history.py ``test_injected_entropy_slowdown_is_attributed``):
there a fixed 10 ms sleep per entropy segment can leave the cell inside
its noise gate on a fast host (its verdict then reads ``ok``). Here the
lag is three times the cell's own measured time per image (one entropy
segment per image: the smoke corpus has no restart markers), so the cell
runs at a quarter of its rate or less, past the 2x fail gate whatever
the host's speed or noise."""
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from repro.bench import history as jhistory
from repro.core import schema as jschema
from repro_torch.bench import (PROFILES, HistoryStore, attribute_result,
                               attribute_stages, compare_records, run_sweep)
from repro_torch.bench.compare import summary_markdown
from repro_torch.bench.history import MIN_STAGE_S, stage_per_image
from repro_torch.common.hw import host_fingerprint
from repro_torch.core.schema import RunRecord, SchemaError, save_records
from repro_torch.device import use_device

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """Every default fingerprint in this module is the CPU's."""
    with use_device("cpu"):
        yield


def _json(scenario, thr=100.0, stage_s=None, num_images=10, status="ok",
          decoder="numpy-fast"):
    meta = {"status": status, "scenario": scenario}
    if stage_s is not None:
        meta["stage_s"] = dict(stage_s)
    samples = [thr - 1, thr, thr + 1] if status == "ok" else []
    return dict(platform="live-host", decoder=decoder,
                protocol="single_thread", workers=0, mode="",
                throughput_mean=thr if status == "ok" else 0.0,
                throughput_std=1.0, samples=samples,
                num_images=num_images, skip_indices=[], meta=meta)


def _rec(*a, **k):
    return RunRecord.from_json(_json(*a, **k))


# ------------------------------------------------------------------ store
def test_history_append_scan_roundtrip(tmp_path):
    store = HistoryStore(str(tmp_path / "nested" / "history.jsonl"))
    r1 = store.append([_rec("single/numpy-fast")], profile="smoke",
                      t=100.0)
    r2 = store.append([_rec("single/numpy-fast", thr=90.0),
                       _rec("single/cuda-fused")], profile="quick",
                      t=200.0)
    assert r1.fingerprint == r2.fingerprint == \
        host_fingerprint()["fingerprint"]
    assert r1.host["device"] == "cpu"
    runs, dropped = store.scan()
    assert dropped == 0 and [r.run_id for r in runs] == \
        [r1.run_id, r2.run_id]
    assert runs[0].t == 100.0 and runs[0].profile == "smoke"
    assert len(runs[1].records) == 2
    back = runs[1].record_for("single/numpy-fast")
    assert back is not None and back.throughput_mean == 90.0
    assert runs[1].record_for("nope") is None
    lines = open(store.path).read().splitlines()
    assert len(lines) == 2 and all(json.loads(ln) for ln in lines)


def test_history_append_rejects_empty_and_fingerprintless(tmp_path):
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    with pytest.raises(SchemaError, match="empty run"):
        store.append([])
    with pytest.raises(SchemaError, match="no fingerprint"):
        store.append([_rec("s")], host={"cpus": 4})
    assert not os.path.exists(store.path)


def test_history_fingerprint_filter_and_latest(tmp_path):
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    store.append([_rec("s")], host={"fingerprint": "aaa111aaa111"},
                 t=1.0, run_id="run-a")
    store.append([_rec("s")], host={"fingerprint": "bbb222bbb222"},
                 t=2.0, run_id="run-b")
    store.append([_rec("s")], host={"fingerprint": "aaa111aaa111"},
                 t=3.0, run_id="run-a2")
    assert [r.run_id for r in store.runs("aaa111aaa111")] == \
        ["run-a", "run-a2"]
    assert store.latest("bbb222bbb222").run_id == "run-b"
    assert store.latest().run_id == "run-a2"
    assert store.latest("ccc333ccc333") is None
    store.append([_rec("s")], t=4.0, run_id="run-c",
                 host={"cpus": 2, "fingerprint": {"cpu_model": "x",
                                                  "fingerprint":
                                                  "ddd444ddd444"}})
    assert store.latest("ddd444ddd444").run_id == "run-c"


def test_history_torn_line_dropped_and_counted(tmp_path):
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    store.append([_rec("s")], t=1.0)
    with open(store.path, "a") as f:
        f.write('{"run_id": "torn", "t": 2.0, "records": [{"bro')
    runs, dropped = store.scan()
    assert len(runs) == 1 and dropped == 1
    assert HistoryStore(str(tmp_path / "absent.jsonl")).scan() == ([], 0)


def test_stage_baseline_wants_newest_ok_traced(tmp_path):
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    traced = {"jpeg.parse": 0.01, "jpeg.entropy": 0.10}
    store.append([_rec("s", stage_s=traced)], t=1.0, run_id="old-traced")
    store.append([_rec("s")], t=2.0, run_id="untraced")
    store.append([_rec("s", status="error")], t=3.0, run_id="broken")
    run, rec = store.stage_baseline("s")
    assert run.run_id == "old-traced" and rec.meta["stage_s"] == traced
    assert store.stage_baseline("other") is None


def test_a_cpu_run_is_never_a_same_host_baseline_for_a_card_run(
        tmp_path, monkeypatch):
    """The store is keyed by the fingerprint, which names the device."""
    import torch

    from repro_torch.common import hw
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    cpu = store.append([_rec("s", stage_s={"jpeg.entropy": 0.1})], t=1.0)
    infos = (hw._host_info, hw._power_limits)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(hw, "_power_limits", lambda: {"c0": "700.00 W"})
    monkeypatch.setattr(hw, "_card_uuid", lambda index: "c0")
    infos[0].cache_clear()
    try:
        with use_device("cuda:0"):
            card_fp = host_fingerprint()["fingerprint"]
    finally:
        infos[0].cache_clear()
    assert card_fp != cpu.fingerprint
    assert store.stage_baseline("s", card_fp) is None
    assert store.stage_baseline("s", cpu.fingerprint)[0].run_id == \
        cpu.run_id


# ------------------------------------------------- either package's store
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_reads_the_others_store(tmp_path, writer):
    path = str(tmp_path / "h.jsonl")
    recs = [_json("single/numpy-fast", stage_s={"jpeg.entropy": 0.02}),
            _json("single/cuda-batch", thr=80.0),
            _json("single/pallas-idct", status="skipped")]
    host = {"fingerprint": {"fingerprint": "abcabcabcabc", "cpus": 8}}
    if writer == "port":
        HistoryStore(path).append([RunRecord.from_json(d) for d in recs],
                                  host=host, profile="smoke", t=5.0)
    else:
        jhistory.HistoryStore(path).append(
            [jschema.RunRecord.from_json(d) for d in recs], host=host,
            profile="smoke", t=5.0)
    for store in (HistoryStore(path), jhistory.HistoryStore(path)):
        runs, dropped = store.scan()
        assert dropped == 0 and len(runs) == 1
        run = runs[0]
        assert (run.fingerprint, run.profile, run.t, run.host) == \
            ("abcabcabcabc", "smoke", 5.0, host)
        assert [r.to_json() for r in run.records] == \
            [jschema.validate_record(dict(d)) for d in recs]
        assert store.stage_baseline("single/numpy-fast",
                                    "abcabcabcabc") is not None


# ------------------------------------------------------------ attribution
def test_stage_per_image_normalizes_and_folds_terminal_names():
    rec = _rec("s", num_images=10,
               stage_s={"jpeg.entropy": 0.10, "loader.decode": 0.05,
                        "svc.pipeline.decode": 0.05})
    per = stage_per_image(rec)
    assert per["entropy"] == pytest.approx(0.010)
    assert per["decode"] == pytest.approx(0.010)
    assert stage_per_image(_rec("s")) == {}
    zero = _rec("s", num_images=0, stage_s={"jpeg.parse": 0.02})
    assert stage_per_image(zero)["parse"] == pytest.approx(0.02)


@pytest.mark.parametrize("old, new, want", [
    ({"jpeg.parse": 0.05, "jpeg.entropy": 0.02},
     {"jpeg.parse": 0.05, "jpeg.entropy": 0.05},
     "entropy 2.5x (2.00→5.00 ms/img)"),
    ({"jpeg.parse": MIN_STAGE_S}, {"jpeg.parse": MIN_STAGE_S * 5}, ""),
    ({"jpeg.parse": 0.10}, {"jpeg.parse": 0.11}, ""),
    (None, {"jpeg.parse": 0.11}, ""),
    ({"jpeg.parse": 0.10}, None, ""),
    ({"jpeg.entropy": 0.02},
     {"jpeg.entropy": 0.02, "loader.queue_wait": 0.08},
     "queue_wait new (+8.00 ms/img vs baseline)"),
    ({"jpeg.parse": 0.02, "jpeg.entropy": 0.02},
     {"jpeg.parse": 0.04, "jpeg.entropy": 0.10},
     "entropy 5.0x (2.00→10.00 ms/img)"),
    ({"jpeg.dequant_idct": 0.01, "jpeg.entropy": 0.3},
     {"jpeg.dequant_idct": 0.04, "jpeg.entropy": 0.31},
     "dequant_idct 4.0x (1.00→4.00 ms/img)"),
])
def test_attribute_stages_names_what_the_reference_names(old, new, want):
    assert attribute_stages(_rec("s", stage_s=old),
                            _rec("s", stage_s=new)) == want
    assert jhistory.attribute_stages(
        jschema.RunRecord.from_json(_json("s", stage_s=old)),
        jschema.RunRecord.from_json(_json("s", stage_s=new))) == want


def test_attribute_result_prefers_history_then_falls_back(tmp_path):
    host = host_fingerprint()
    store = HistoryStore(str(tmp_path / "h.jsonl"))
    store.append([_rec("single/numpy-fast",
                       stage_s={"jpeg.entropy": 0.02,
                                "jpeg.parse": 0.05})], t=1.0)
    old = [_rec("single/numpy-fast")]
    new = [_rec("single/numpy-fast", thr=30.0,
                stage_s={"jpeg.entropy": 0.08, "jpeg.parse": 0.05})]
    res = compare_records(old, new, new_host=host)
    assert res.n_fail == 1
    assert attribute_result(res, old, new, history=store) == 1
    assert res.by_verdict("fail")[0].attribution == \
        "entropy 4.0x (2.00→8.00 ms/img)"
    res2 = compare_records(old, new, new_host=host)
    assert attribute_result(res2, old, new) == 0
    assert res2.by_verdict("fail")[0].attribution == \
        "unattributed: no stage_s rollup (run sweep --trace)"
    same = {"jpeg.entropy": 0.02, "jpeg.parse": 0.05}
    old3 = [_rec("single/numpy-fast", stage_s=same)]
    new3 = [_rec("single/numpy-fast", thr=30.0, stage_s=same)]
    res3 = compare_records(old3, new3, new_host=host)
    assert attribute_result(res3, old3, new3) == 0
    assert res3.by_verdict("fail")[0].attribution == \
        "unattributed: no single stage moved enough"
    assert all(not e.attribution for e in res3.entries
               if e.verdict not in ("fail", "warn"))


def test_summary_markdown_gains_stage_column_when_attributed():
    old = [_rec("single/numpy-fast", stage_s={"jpeg.entropy": 0.02})]
    new = [_rec("single/numpy-fast", thr=30.0,
                stage_s={"jpeg.entropy": 0.08})]
    res = compare_records(old, new)
    attribute_result(res, old, new)
    md = summary_markdown(res)
    assert "| ratio | gate | stage |" in md and "entropy 4.0x" in md
    assert "| stage |" not in summary_markdown(compare_records(old, new))


# ----------------------------------------------- acceptance: injected lag
def test_injected_entropy_lag_of_three_images_is_attributed(tmp_path,
                                                            monkeypatch):
    """Slow the entropy stage by three times the cell's measured time per
    image, re-sweep, and ``compare --attribute`` must fail the cell and
    name ``entropy`` (see the module docstring for why the lag scales
    with the cell)."""
    from repro_torch.jpeg import huffman
    cell = "single/numpy-fast"
    assert PROFILES["smoke"].corpus_dri == ()    # one segment per image
    base = run_sweep("smoke", only=[cell], trace=True, device="cpu",
                     out_dir=str(tmp_path / "base"))
    store = HistoryStore(str(tmp_path / "history.jsonl"))
    store.append(base.records, profile="smoke")
    rec = {r.scenario: r for r in base.records}[cell]
    lag = 3.0 / rec.throughput_mean              # 3 x seconds per image

    real = huffman.decode_segment

    def laggy(seg, tables_key, components, n_mcus):
        time.sleep(lag)                          # inside the entropy span
        return real(seg, tables_key, components, n_mcus)

    monkeypatch.setattr(huffman, "decode_segment", laggy)
    slow = run_sweep("smoke", only=[cell], trace=True, device="cpu",
                     out_dir=str(tmp_path / "slow"))
    host = host_fingerprint()
    res = compare_records(base.records, slow.records, old_host=host,
                          new_host=host)
    entry = {e.scenario: e for e in res.entries}[cell]
    assert entry.verdict == "fail" and entry.ratio < 0.5, entry
    assert attribute_result(res, base.records, slow.records,
                            history=store) >= 1
    assert entry.attribution.startswith("entropy "), entry.attribution
    assert "ms/img" in entry.attribution
    md = summary_markdown(res)
    assert "entropy " in md and "| stage |" in md
    # the same through the command line, against the history store
    from repro_torch.bench import cli
    code = cli.main(["compare", base.files[0], slow.files[0],
                     "--attribute", "--history", store.path])
    assert code == 2


# ------------------------------------------------------------------- cli
def test_history_cli_append_and_show(tmp_path):
    records = str(tmp_path / "records.json")
    save_records([_rec("single/numpy-fast",
                       stage_s={"jpeg.entropy": 0.02})], records)
    store = str(tmp_path / "history.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.bench", "history"]
    proc = subprocess.run(cmd + ["append", records, "--store", store,
                                 "--profile", "smoke"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "appended run" in proc.stdout
    assert "1 records, 1 stage-traced" in proc.stdout
    proc = subprocess.run(cmd + ["show", "--store", store], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "1 run(s)" in proc.stdout
    assert "profile=smoke" in proc.stdout and "stage-traced=1" \
        in proc.stdout
    proc = subprocess.run(cmd + ["append", "--store", store], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "needs a record-set" in proc.stderr
    # the reference's store reader takes the port's lines
    runs, dropped = jhistory.HistoryStore(store).scan()
    assert dropped == 0 and runs[0].profile == "smoke"
    assert runs[0].host["fingerprint"]["device"] == "cpu"
