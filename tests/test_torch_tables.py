"""The port's paper-table views (``repro_torch.bench.views``, ``python -m
repro_torch.bench tables``) against the reference's (``benchmarks/``) on
the CPU, with no sweep: every view that reads the shared sweep gets one
fixed record set (seeded numpy) through a monkeypatched
``sweep_records`` on both sides. Recorded rows and live rows must equal
the reference's exactly (name, time column and derived string); the
kernel view's plain outputs must equal ``repro.kernels.ref``'s jnp
references within tests/test_kernels.py's ``rtol=1e-5, atol=1e-3``."""
import json
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schema as jschema
from repro.kernels import ref as jref
from repro_torch.bench import cli
from repro_torch.bench import views
from repro_torch.bench.views import common, kernels_bench, roofline
from repro_torch.core import schema
from repro_torch.device import use_device
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig3_tf_penalty as jfig3  # noqa: E402
from benchmarks import roofline as jroofline  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from benchmarks import table1_guide as jtable1  # noqa: E402
from benchmarks import table2_protocol as jtable2  # noqa: E402
from benchmarks import table3_workers as jtable3  # noqa: E402
from benchmarks import table4_tiers as jtable4  # noqa: E402
from benchmarks import table5_guide as jtable5  # noqa: E402

RTOL, ATOL = 1e-5, 1e-3                 # tests/test_kernels.py
H100 = "NVIDIA H100 80GB HBM3"
#: views that read the shared sweep: (name, port module, reference module)
LIVE = {
    "table2": (views.VIEWS["table2"], jtable2),
    "table3": (views.VIEWS["table3"], jtable3),
    "table4": (views.VIEWS["table4"], jtable4),
    "table5": (views.VIEWS["table5"], jtable5),
    "fig3": (views.VIEWS["fig3"], jfig3),
}
#: the rows each view derives from the paper's published numbers
RECORDED = {"table1": 1, "table2": 1, "table3": 1, "table4": 1,
            "table5": 1, "fig3": 1}
REF_MODULES = {"table1": jtable1, **{k: v[1] for k, v in LIVE.items()}}
DECODERS = ("numpy-ref", "numpy-fast", "numpy-int", "numpy-sparse",
            "fft-idct", "torch-fused", "torch-batch", "strict-fast")


def _record_dicts(platform="live-host", seed=0):
    """A sweep's worth of records, drawn from ``seed``: single-thread and
    thread-mode loader records at workers 0, 2, 4 and 8 for every decoder
    (the strict path skips one image), a process-mode record, and a
    skipped and an error cell that no aggregate may read."""
    rng = np.random.RandomState(seed)
    out = []

    def rec(decoder, protocol, workers, mode, thr, **kw):
        samples = [float(v) for v in thr * (1 + 0.02 * rng.randn(2))]
        d = {"platform": platform, "decoder": decoder,
             "protocol": protocol, "workers": workers, "mode": mode,
             "throughput_mean": float(np.mean(samples)),
             "throughput_std": float(np.std(samples)),
             "samples": samples, "num_images": 48,
             "skip_indices": [], "meta": {}}
        d.update(kw)
        out.append(d)

    for name in DECODERS:
        base = float(rng.uniform(60, 240))
        skips = [3] if name.startswith("strict") else []
        rec(name, "single_thread", 0, "", base, skip_indices=skips)
        for w in (0, 2, 4, 8):
            rec(name, "dataloader", w, "thread",
                base * float(rng.uniform(0.6, 1.8)), skip_indices=skips)
    rec("numpy-fast", "dataloader", 2, "process", 150.0)
    out.append({"platform": platform, "decoder": "torch-batch",
                "protocol": "dataloader", "workers": 2, "mode": "process",
                "throughput_mean": 0.0, "throughput_std": 0.0,
                "samples": [], "num_images": 48, "skip_indices": [],
                "meta": {"status": "skipped", "eligible": False,
                         "reason": "fork: a torch path holds a context"}})
    out.append({"platform": platform, "decoder": "numpy-ref",
                "protocol": "single_thread", "workers": 0, "mode": "",
                "throughput_mean": 0.0, "throughput_std": 0.0,
                "samples": [], "num_images": 48, "skip_indices": [],
                "meta": {"status": "error", "reason": "boom"}})
    return out


def _as_reference(dicts, engine_path=False):
    """The same records in the reference's schema; with ``engine_path``
    its ``jnp-fused`` where the port has ``torch-fused`` (fig3's
    comparison; elsewhere the same name keeps the views' name order)."""
    return [jschema.RunRecord.from_json(
        dict(d, decoder="jnp-fused" if engine_path and
             d["decoder"] == "torch-fused" else d["decoder"]))
        for d in dicts]


def _as_port(dicts):
    return [schema.RunRecord.from_json(dict(d)) for d in dicts]


def _reference_row(row):
    """A reference row in the port's terms (fig3's engine path)."""
    name, us, derived = row
    return name, us, derived.replace("jnp_vs_numpy", "torch_vs_numpy")


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """Both packages' view artifacts go to temporary directories."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    monkeypatch.setattr(common, "ARTIFACTS", str(port))
    monkeypatch.setattr(jcommon, "ARTIFACTS", str(ref))
    return port, ref


def _run_both(name, monkeypatch, port_dicts, ref_dicts):
    """One view of each package, each over its own copy of the records."""
    port_mod = views.VIEWS[name]
    ref_mod = REF_MODULES[name]
    port_records = _as_port(port_dicts)
    ref_records = _as_reference(ref_dicts, engine_path=name == "fig3")
    if name in LIVE:
        monkeypatch.setattr(port_mod, "sweep_records",
                            lambda quick=True: port_records)
        monkeypatch.setattr(ref_mod, "sweep_records",
                            lambda quick=True: ref_records)
    with use_device("cpu"):
        got = port_mod.run(quick=True)
    want = [_reference_row(r) for r in ref_mod.run(quick=True)]
    return got, want


# --------------------------------------------------------------- the CLI
def test_views_are_the_references_in_its_order():
    assert tuple(views.VIEWS) == cli.TABLES == jrun.TABLES
    assert all(callable(mod.run) for mod in views.VIEWS.values())
    # each view keeps its counterpart's file name
    files = {mod.__name__.rsplit(".", 1)[1] for mod in views.VIEWS.values()}
    assert files == {
        p.stem for p in (ROOT / "benchmarks").glob("*.py")
        if p.stem not in ("run", "common")}


# ------------------------------------------------------- (a) recorded rows
@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorded_rows_equal_the_references(name, monkeypatch, artifacts):
    dicts = _record_dicts()
    got, want = _run_both(name, monkeypatch, dicts, dicts)
    n = RECORDED[name]
    assert got[:n] == want[:n]
    assert got[0][0].startswith(name)


# ----------------------------------------------------------- (b) live rows
@pytest.mark.parametrize("name", sorted(LIVE))
def test_live_rows_equal_the_references_on_the_same_records(
        name, monkeypatch, artifacts):
    dicts = _record_dicts()
    got, want = _run_both(name, monkeypatch, dicts, dicts)
    live = got[RECORDED[name]:]
    assert live, f"{name} gave no live row"
    assert got == want
    port_dir, ref_dir = artifacts
    saved = sorted(p.name for p in port_dir.iterdir())
    assert saved == sorted(p.name for p in ref_dir.iterdir())
    for f in saved:
        text = (port_dir / f).read_text()
        if name == "fig3":
            text = text.replace("torch-fused", "jnp-fused")
        assert json.loads(text) == json.loads((ref_dir / f).read_text())


def test_live_rows_move_with_the_records(monkeypatch, artifacts):
    """The live rows read the records: another seed, another table."""
    rows = []
    for seed in (0, 1):
        mod = views.VIEWS["table5"]
        recs = _as_port(_record_dicts(seed=seed))
        monkeypatch.setattr(mod, "sweep_records", lambda quick=True: recs)
        rows.append(mod.run(quick=True)[-1])
    assert rows[0] != rows[1]


# ----------------------------------------- (c) a sweep labelled by the card
@pytest.mark.parametrize("name", ["table2", "table5"])
def test_card_labelled_records_still_give_live_rows(name, monkeypatch,
                                                    artifacts):
    """On the card the harness labels every record with the card's name,
    not ``live-host``: the port's views read the one platform the sweep
    carries, so the rows are those of the same records on the CPU; the
    reference's lookup of ``live-host`` finds nothing there."""
    on_host, _ = _run_both(name, monkeypatch, _record_dicts(),
                           _record_dicts())
    card = _record_dicts(platform=H100)
    got, _ = _run_both(name, monkeypatch, card, _record_dicts())
    assert got == on_host
    ref_mod = REF_MODULES[name]
    monkeypatch.setattr(ref_mod, "sweep_records",
                        lambda quick=True: _as_reference(card))
    if name == "table2":
        with pytest.raises(RuntimeError, match="live-host"):
            ref_mod.run(quick=True)
    else:
        assert ref_mod.run(quick=True)[-1] == ("table5.live", 0.0, "")
        assert got[-1][2]


@pytest.mark.parametrize("name", ["table2", "table5"])
def test_records_of_two_platforms_are_refused(name, monkeypatch,
                                              artifacts):
    mixed = _as_port(_record_dicts() + _record_dicts(platform=H100))
    mod = views.VIEWS[name]
    monkeypatch.setattr(mod, "sweep_records", lambda quick=True: mixed)
    with pytest.raises(RuntimeError, match="one platform"):
        mod.run(quick=True)


def test_sweep_records_runs_once_per_profile_and_device(monkeypatch,
                                                        tmp_path):
    import repro_torch.bench as bench
    calls = []

    class Result:
        records = ["r"]

    def fake_sweep(profile, out_dir=None, device=None):
        calls.append((profile, out_dir, str(device)))
        return Result()
    monkeypatch.setattr(bench, "run_sweep", fake_sweep)
    monkeypatch.setattr(common, "_SWEEP_CACHE", {})
    monkeypatch.setattr(common, "ARTIFACTS", str(tmp_path))
    with use_device("cpu"):
        assert common.sweep_records(True) == ["r"]
        assert common.sweep_records(True) == ["r"]
        common.sweep_records(False)
    common.sweep_records(True, device="cpu")
    assert calls == [("quick", str(tmp_path), "cpu"),
                     ("full", str(tmp_path), "cpu")]


def test_sweep_records_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "_SWEEP_CACHE", {})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        common.sweep_records(True)


def test_time_us_on_the_cpu_takes_the_best_of_its_repeats():
    calls = []
    with use_device("cpu"):
        us = common.time_us(lambda: calls.append(1), repeats=3, number=4)
    assert len(calls) == 1 + 3 * 4
    assert 0 < us < 1e6


# ----------------------------------------------------- (d) the kernel view
def _plain_and_reference(name, quick=True):
    """The view's inputs through the wrapper's CPU route (the plain
    version) and through the reference's jnp oracle."""
    x, q, y = kernels_bench.row_inputs(quick)
    with use_device("cpu"):
        if name == "idct8x8":
            return (ops.idct8x8(torch.from_numpy(x)),
                    jref.idct8x8(jnp.asarray(x)))
        if name == "dequant_idct":
            return (ops.dequant_idct(torch.from_numpy(x),
                                     torch.from_numpy(q)),
                    jref.dequant_idct(jnp.asarray(x), jnp.asarray(q)))
        if name == "ycbcr2rgb":
            yt = torch.from_numpy(y)
            yj = jnp.asarray(y)
            return (ops.ycbcr2rgb(yt, yt, yt),
                    jnp.stack(jref.ycbcr2rgb(yj, yj, yj), axis=-1))
        xb, qt, qi, _, _ = kernels_bench.batched_inputs(quick)
        return (ops.decode_batch(torch.from_numpy(xb), torch.from_numpy(qi),
                                 torch.from_numpy(qt)),
                jref.decode_batch(jnp.asarray(xb), jnp.asarray(qi),
                                  jnp.asarray(qt)))


@pytest.mark.parametrize("name", ["idct8x8", "dequant_idct", "ycbcr2rgb",
                                  "decode_batch"])
def test_kernel_view_plain_outputs_equal_the_jnp_references(name):
    got, want = _plain_and_reference(name)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_kernel_view_inputs_are_the_references():
    """The reference's seeds and shapes (benchmarks/kernels_bench.py)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8192, 64).astype(np.float32) * 50
    q = rng.randint(1, 99, size=64).astype(np.float32)
    y = rng.uniform(0, 255, (256, 128)).astype(np.float32)
    for got, want in zip(kernels_bench.row_inputs(quick=False), (x, q, y)):
        np.testing.assert_array_equal(got, want)
    assert kernels_bench.row_inputs(quick=True)[0].shape == (1024, 64)
    xb, qt, qi, batch, blocks = kernels_bench.batched_inputs(quick=True)
    assert (batch, blocks, xb.shape, qt.shape) == (8, 256, (2048, 64),
                                                    (8, 64))
    assert kernels_bench.batched_inputs(quick=False)[4] == 2048


def test_kernel_view_batched_equals_serial():
    xb, qt, qi, batch, blocks = kernels_bench.batched_inputs(quick=True)
    x, q, i = map(torch.from_numpy, (xb, qt, qi))
    with use_device("cpu"):
        batched = ops.decode_batch(x, i, q)
        serial = torch.cat(kernels_bench.serial_dequant_idct(
            ops.dequant_idct, x, q, batch, blocks))
    assert torch.equal(batched, serial)


def test_kernel_view_rows_on_the_cpu_are_labelled_plain():
    with use_device("cpu"):
        rows = kernels_bench.run(quick=True)
    names = [r[0] for r in rows]
    assert not any(".cuda" in n for n in names)
    assert names == [
        "kernel.idct8x8.plain[1024x64]", "kernel.idct8x8.ref_torch[1024x64]",
        "kernel.dequant_idct.plain[1024x64]",
        "kernel.dequant_idct.ref_torch[1024x64]",
        "kernel.ycbcr2rgb.plain[256x128]",
        "kernel.ycbcr2rgb.ref_torch[256x128]",
        "kernel.decode_batch.batched.plain[8x256x64]",
        "kernel.decode_batch.serial_loop.plain[8x256x64]",
        "kernel.decode_batch.ref_torch[8x256x64]",
        "kernel.decode_batch.speedup.plain"]
    for name, us, derived in rows:
        assert us > 0, name
        if ".plain[" in name and "serial_loop" not in name:
            assert "max_abs_err=0.000e+00" in derived
            assert "frac_of_bound=n/a(host)" in derived
    # 1024 rows in and out and the IDCT matrix at 3.35 TB/s
    assert "bound_us=0.161 " in rows[0][2]
    assert "max_abs_diff_vs_batched=0.000e+00" in rows[7][2]


# ------------------------------------------------------- (e) the roofline
def _roofline_cell(dirpath):
    cell = {"status": "ok", "useful_flops_ratio": 0.83,
            "roofline": {"compute_s": 0.4, "memory_s": 0.25,
                         "collective_s": 0.1, "dominant": "compute_s",
                         "roofline_fraction": 0.91, "bound_s": 0.4},
            "memory": {"argument_bytes": 3 * 2**30, "temp_bytes": 2**30,
                       "fits_hbm": True}}
    (dirpath / "qwen2-7b__train_4k__pod.json").write_text(
        json.dumps(cell))
    (dirpath / "qwen2-7b__train_4k__multipod.json").write_text(
        json.dumps(cell))
    (dirpath / "gemma3__decode__pod.json").write_text(json.dumps(
        {"status": "skipped", "reason": "no kernel for head dim 256"}))


@pytest.mark.parametrize("cells", ["empty", "fixture"])
def test_roofline_rows_equal_the_references(cells, tmp_path, monkeypatch,
                                            artifacts):
    dry = tmp_path / "dry"
    dry.mkdir()
    if cells == "fixture":
        _roofline_cell(dry)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(dry))
    monkeypatch.setattr(jroofline, "DRYRUN_DIR", str(dry))
    got = roofline.run(quick=True)
    assert got == jroofline.run(quick=True)
    port_dir, ref_dir = artifacts
    assert json.loads((port_dir / "roofline_table.json").read_text()) == \
        json.loads((ref_dir / "roofline_table.json").read_text())
    if cells == "empty":
        assert got == [("roofline.matrix", 0.0,
                        "pod ok=0 skipped=0 err=0; multipod ok=0")]
    else:
        assert got[0] == ("roofline.matrix", 0.0,
                          "pod ok=1 skipped=1 err=0; multipod ok=1")


def test_roofline_reads_the_ports_own_directory():
    assert os.path.normpath(roofline.DRYRUN_DIR) == os.path.join(
        "artifacts", "dryrun_torch")
    assert os.path.basename(os.path.normpath(jroofline.DRYRUN_DIR)) == \
        "dryrun"


# ------------------------------------------------------- (f) the service
def test_service_smoke_completes(artifacts):
    from repro_torch.bench.views import service_bench
    with use_device("cpu"):
        rows = service_bench.smoke()
    (name, us, derived), = rows
    assert name == "service.smoke.batched_vs_serial"
    assert us > 0 and "ratio=" in derived and "buckets=" in derived


# ----------------------------------------------------- (g)-(i) the command
def test_tables_only_typo_exits_2(capsys):
    assert cli.main(["tables", "--only", "bogus", "--device", "cpu"]) == 2
    assert "bogus" in capsys.readouterr().err


def test_tables_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["tables"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_tables_on_the_cpu_prints_rows_and_no_error(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(common, "ARTIFACTS", str(tmp_path / "bench"))
    assert cli.main(["tables", "--device", "cpu", "--only",
                     "table1,roofline,kernels"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert not any(".ERROR," in ln for ln in lines)
    views_seen = {ln.split(".", 1)[0] for ln in lines[1:]}
    assert views_seen == {"table1", "roofline", "kernel"}
    assert not any(".cuda" in ln for ln in lines)


def test_a_view_that_raises_is_an_error_row_and_exit_1(monkeypatch,
                                                       capsys):
    def boom(quick=True):
        raise ValueError("broken view")
    monkeypatch.setattr(views.VIEWS["table1"], "run", boom)
    assert cli.main(["tables", "--device", "cpu", "--only", "table1"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived",
                   "table1.ERROR,0.0,ValueError: broken view"]
