"""The port's ``common/hw.py``: the H100 spec every ``bound_ms`` reads,
the host fingerprint that names the device (a CPU run and a card run
never share one), the roofline terms, ``common/pytypes.py`` and the
fingerprint in ``core.schema.host_metadata``."""
import os
import pathlib
import platform
import subprocess
import sys

import pytest
import torch

from repro.common import hw as jhw
from repro.core import schema as jschema
from repro_torch.common import hw
from repro_torch.core import schema
from repro_torch.device import use_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fresh(monkeypatch):
    """Clear the per-device and per-process caches around a test."""
    caches = (hw._host_info, hw._power_limits)
    for c in caches:
        c.cache_clear()
    yield monkeypatch
    for c in caches:
        c.cache_clear()


@pytest.fixture
def card(fresh):
    """A visible card, as torch and nvidia-smi would report one."""
    fresh.setattr(torch.cuda, "is_available", lambda: True)
    fresh.setattr(torch.cuda, "get_device_name", lambda index=0: CARD)
    fresh.setattr(hw, "_power_limits", lambda: {"c0": "700.00 W"})
    fresh.setattr(hw, "_card_uuid", lambda index: "c0")
    return fresh


def test_h100_spec_holds_the_rates_the_bounds_were_computed_with():
    """PERF.md §6's bounds: bytes at 3.35 TB/s, FLOPs at 67 (FP32) or
    989 (bf16) TFLOP/s; with the data sheet's sizes."""
    spec = hw.H100_SXM
    assert (spec.hbm_bandwidth, spec.peak_fp32_flops,
            spec.peak_bf16_flops) == (3.35e12, 67e12, 989e12)
    assert spec.hbm_bytes == 80 * 10**9
    assert (spec.sm_count, spec.smem_bytes_per_sm) == (132, 228 * 1024)
    assert spec.links_per_chip == 18
    assert spec.link_bandwidth * spec.links_per_chip * 2 == 900e9
    perf = " ".join((ROOT / "PERF.md").read_text().split())
    assert "3.35 TB/s" in perf and "67 (FP32) / 989 (bf16)" in perf


@pytest.mark.parametrize("nbytes, flops, rate, want", [
    (3.35e9, 0.0, None, (1.0, "bytes")),
    (0.0, 67e9, None, (1.0, "operations")),
    (0.0, 989e9, "bf16", (1.0, "operations")),
    (6.7e9, 67e9, None, (2.0, "bytes")),
])
def test_chip_smoke_bounds_read_the_spec(nbytes, flops, rate, want):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    flops_per_s = hw.H100_SXM.peak_bf16_flops if rate else None
    ms, by = chip_smoke.bound_ms(nbytes, flops, flops_per_s)
    assert ms == pytest.approx(want[0]) and by == want[1]
    assert chip_smoke.chip_spec() is hw.H100_SXM
    assert "FLOPS_PER_S" not in (ROOT / "chip_smoke.py").read_text()


def test_the_tpu_constants_are_not_carried_over():
    for name in ("TPU_V5E", "MXU_DIM", "VPU_LANES", "VPU_SUBLANES"):
        assert hasattr(jhw, name) and not hasattr(hw, name)


def test_fingerprint_fields_and_hash(card):
    with use_device("cuda:0"):
        fp = hw.host_fingerprint()
    assert set(fp) == {"cpu_model", "cpus", "machine", "system", "python",
                       "numpy", "torch", "cuda", "device", "power_limit",
                       "fingerprint", "hostname"}
    assert fp["device"] == CARD and fp["power_limit"] == "700.00 W"
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == (torch.version.cuda or "none")
    assert len(fp["fingerprint"]) == 12
    int(fp["fingerprint"], 16)
    # the reference's hashing rule: every field but hostname, sorted
    import hashlib
    key = "|".join(f"{k}={fp[k]}" for k in sorted(fp)
                   if k not in ("fingerprint", "hostname"))
    assert hashlib.sha256(key.encode()).hexdigest()[:12] == \
        fp["fingerprint"]


def test_fingerprint_differs_between_the_cpu_and_a_selected_card(card):
    with use_device("cpu"):
        on_cpu = hw.host_fingerprint()
    with use_device("cuda:0"):
        on_card = hw.host_fingerprint()
    assert on_cpu["device"] == "cpu" and on_cpu["power_limit"] == "none"
    assert on_card["device"] == CARD
    assert on_cpu["fingerprint"] != on_card["fingerprint"]
    # per device, not once per process: the CPU's is still its own
    with use_device("cpu"):
        assert hw.host_fingerprint() == on_cpu


def test_fingerprint_does_not_raise_on_a_cpu_only_host(fresh):
    fresh.setattr(torch.cuda, "is_available", lambda: False)

    def no_card(*a, **k):
        raise AssertionError("asked a card that is not there")
    fresh.setattr(torch.cuda, "get_device_name", no_card)
    with use_device("cuda:0"):
        fp = hw.host_fingerprint()
    assert fp["device"] == "none" and fp["power_limit"] == "none"
    with use_device("cpu"):
        assert hw.host_fingerprint()["fingerprint"] != fp["fingerprint"]


def test_hostname_is_not_hashed(card):
    with use_device("cpu"):
        a = hw.host_fingerprint()
    hw._host_info.cache_clear()
    card.setattr(platform, "node", lambda: "another-host")
    with use_device("cpu"):
        b = hw.host_fingerprint()
    assert b["hostname"] == "another-host" != a["hostname"]
    assert a["fingerprint"] == b["fingerprint"]


def _smi(monkeypatch, stdout, calls):
    class Done:
        pass
    Done.stdout = stdout

    def run(argv, **kw):
        calls.append(argv)
        return Done()
    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index=0: f"card {index}")


def test_power_limit_is_read_once_per_process_and_never_raises(fresh):
    calls = []
    _smi(fresh, "GPU-aaaa, 700.00 W\nGPU-bbbb, 350.00 W\n", calls)
    fresh.setattr(torch.cuda, "device_count", lambda: 3)
    fresh.setattr(hw, "_card_uuid",
                  lambda index: {0: "aaaa", 1: "bbbb"}.get(index))
    with use_device("cuda:0"):
        assert hw.host_fingerprint()["power_limit"] == "700.00 W"
    with use_device("cuda:1"):
        assert hw.host_fingerprint()["power_limit"] == "350.00 W"
    with use_device("cuda:2"):
        assert hw.host_fingerprint()["power_limit"] == "unknown"
    assert len(calls) == 1
    assert "--query-gpu=uuid,power.limit" in calls[0]

    hw._power_limits.cache_clear()
    hw._host_info.cache_clear()

    def missing(argv, **kw):
        raise FileNotFoundError("nvidia-smi")
    fresh.setattr(subprocess, "run", missing)
    with use_device("cuda:0"):
        assert hw.host_fingerprint()["power_limit"] == "unknown"


def test_power_limit_follows_the_card_not_its_index(fresh):
    """Under CUDA_VISIBLE_DEVICES torch's card 0 may be the machine's
    second: nvidia-smi lists every card, so the UUID picks the line."""
    _smi(fresh, "GPU-aaaa, 700.00 W\nGPU-BBBB, 350.00 W\n", [])
    fresh.setattr(torch.cuda, "device_count", lambda: 1)
    fresh.setattr(torch.cuda, "get_device_properties",
                  lambda index: type("P", (), {"uuid": "bbbb"})())
    with use_device("cuda:0"):
        assert hw.host_fingerprint()["power_limit"] == "350.00 W"


@pytest.mark.parametrize("smi, count, want", [
    ("GPU-aaaa, 700.00 W\n", 1, "700.00 W"),       # one card, seen by both
    ("GPU-aaaa, 700.00 W\nGPU-bbbb, 350.00 W\n", 1, "unknown"),
    ("GPU-aaaa, 700.00 W\n", 2, "unknown"),
])
def test_power_limit_without_a_uuid(fresh, smi, count, want):
    """Where torch gives no UUID, the limit is taken only when exactly
    one card is visible to torch and to nvidia-smi."""
    _smi(fresh, smi, [])
    fresh.setattr(torch.cuda, "device_count", lambda: count)
    fresh.setattr(hw, "_card_uuid", lambda index: None)
    with use_device("cuda:0"):
        assert hw.host_fingerprint()["power_limit"] == want


@pytest.mark.parametrize("flops, nbytes, coll, dominant", [
    (989e12, 1.0, 1.0, "compute_s"),
    (1.0, 3.35e12, 1.0, "memory_s"),
    (1.0, 1.0, 25e9, "collective_s"),
])
def test_roofline_terms_on_the_h100(flops, nbytes, coll, dominant):
    terms = hw.roofline_terms(flops, nbytes, coll)
    assert terms["dominant"] == dominant
    assert terms["bound_s"] == pytest.approx(1.0)
    assert terms["roofline_fraction"] == pytest.approx(
        terms["compute_s"] / terms["bound_s"])
    # the same arithmetic as the reference's, on the reference's chip
    ref = jhw.roofline_terms(flops, nbytes, coll)
    spec = hw.ChipSpec(
        name="v5e", peak_bf16_flops=jhw.TPU_V5E.peak_bf16_flops,
        peak_fp32_flops=0.0, hbm_bandwidth=jhw.TPU_V5E.hbm_bandwidth,
        link_bandwidth=jhw.TPU_V5E.ici_link_bandwidth, links_per_chip=4,
        hbm_bytes=jhw.TPU_V5E.hbm_bytes, sm_count=0, smem_bytes_per_sm=0)
    assert hw.roofline_terms(flops, nbytes, coll, chip=spec) == ref


def test_roofline_terms_take_the_flop_rate():
    """FP32 work outside the tensor cores is bound at 67, not 989,
    TFLOP/s: the rate ``chip_smoke.bound_ms`` passes."""
    spec = hw.H100_SXM
    terms = hw.roofline_terms(67e12, 1.0, 0.0,
                              flops_per_s=spec.peak_fp32_flops)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["dominant"] == "compute_s"
    assert hw.roofline_terms(989e12, 1.0, 0.0)["compute_s"] == \
        pytest.approx(1.0)


def test_pytypes_is_a_copy():
    ref = (ROOT / "src" / "repro" / "common" / "pytypes.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "common" / "pytypes.py")
    assert port.read_text() == ref
    from repro_torch.common import Params, PyTree
    assert Params is not None and PyTree is not None


def test_host_metadata_carries_the_fingerprint_in_the_references_shape(
        card, tmp_path):
    with use_device("cpu"):
        meta = schema.host_metadata()
    ref = jschema.host_metadata()
    assert set(meta) == set(ref)
    assert meta["fingerprint"]["device"] == "cpu"
    assert set(ref["fingerprint"]) - set(meta["fingerprint"]) == {"jax"}
    with use_device("cuda:0"):
        on_card = schema.host_metadata()["fingerprint"]
    assert on_card["device"] == CARD
    assert on_card["fingerprint"] != meta["fingerprint"]["fingerprint"]
    # a record file written by the port carries it where the
    # reference's readers look for it
    path = str(tmp_path / "records.json")
    with use_device("cpu"):
        schema.save_records([], path)
    payload = jschema.load_payload(path)
    assert payload["host"]["fingerprint"]["fingerprint"] == \
        meta["fingerprint"]["fingerprint"]


def test_hw_imports_neither_jax_nor_repro():
    code = ("import json, sys\n"
            "import repro_torch.common.hw, repro_torch.core.schema\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    import json
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
