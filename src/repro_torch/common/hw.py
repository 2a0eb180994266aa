"""Target-hardware constants for roofline analysis + host fingerprinting.

The port's target is one NVIDIA H100 SXM. ``H100_SXM`` holds its
published rates and sizes, which feed the three-term roofline (compute /
memory / collective) and every ``bound_ms`` the smoke run computes.
Sources: NVIDIA H100 Tensor Core GPU datasheet (SXM5; dense rates
without sparsity, at the 700 W power limit) and the NVIDIA H100 Tensor
Core GPU Architecture whitepaper (132 SMs, 228 KiB shared memory per SM,
18 fourth-generation NVLink links, 900 GB/s in both directions together).

``host_fingerprint()`` is the bench harness's machine identity: every
emitted record set carries it so results are only ever compared across
commits on the same (or an explicitly acknowledged different) host and
device — the paper's core point is that the platform is part of the
claim. In the port the device is part of the host: a sweep on the card
and a sweep on the CPU of the same machine never share a fingerprint.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import platform as _platform
import subprocess
import sys
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import selected_device


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float      # FLOP/s per card, tensor cores, dense
    peak_fp32_flops: float      # FLOP/s per card, outside the tensor cores
    hbm_bandwidth: float        # bytes/s per card
    link_bandwidth: float       # bytes/s per NVLink link (one direction)
    links_per_chip: int         # NVLink links per card
    hbm_bytes: int              # device memory per card
    sm_count: int
    smem_bytes_per_sm: int      # shared memory per SM


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,
    peak_fp32_flops=67e12,
    hbm_bandwidth=3.35e12,
    link_bandwidth=25e9,        # 900 GB/s over 18 links, both directions
    links_per_chip=18,
    hbm_bytes=80 * 10**9,
    sm_count=132,
    smem_bytes_per_sm=228 * 1024,
)


def _cpu_model() -> str:
    """Best-effort CPU model name (``platform.processor()`` is often empty
    on Linux; /proc/cpuinfo has the marketing string)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return _platform.processor() or "unknown"


def _uuid_key(uuid: str) -> str:
    """A card's UUID as both torch and ``nvidia-smi`` can spell it
    (``nvidia-smi`` prefixes ``GPU-``; torch does not)."""
    uuid = uuid.strip().lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


@functools.lru_cache(maxsize=1)
def _power_limits() -> Dict[str, str]:
    """Each card's power limit as ``nvidia-smi`` prints it ("700.00 W"),
    keyed by its UUID, read once per process; {} when it cannot be read.
    ``nvidia-smi`` lists every card of the machine in its own order, not
    the ones ``CUDA_VISIBLE_DEVICES`` leaves torch, so only the UUID ties
    one of its lines to a torch device index."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    # the limit is metadata: a missing nvidia-smi must not fail a sweep
    except (OSError, subprocess.SubprocessError):
        return {}
    limits = {}
    for line in out.stdout.splitlines():
        uuid, sep, limit = line.partition(",")
        if sep:
            limits[_uuid_key(uuid)] = limit.strip()
    return limits


def _card_uuid(index: int) -> Optional[str]:
    """The UUID of torch's card ``index``; None where torch cannot say."""
    try:
        return _uuid_key(str(torch.cuda.get_device_properties(index).uuid))
    except (AttributeError, RuntimeError, AssertionError):
        return None


def _device_info(dev: torch.device) -> Tuple[str, str]:
    """(device name, power limit) of the device a context selected."""
    if dev.type != "cuda":
        return dev.type, "none"
    if not torch.cuda.is_available():
        return "none", "none"
    index = dev.index if dev.index is not None else 0
    limits = _power_limits()
    limit = limits.get(_card_uuid(index))
    if limit is None and len(limits) == 1 and \
            torch.cuda.device_count() == 1:
        limit = next(iter(limits.values()))     # one card, seen by both
    return torch.cuda.get_device_name(index), limit or "unknown"


@functools.lru_cache(maxsize=None)
def _host_info(dev: torch.device) -> tuple:
    import numpy as np
    name, limit = _device_info(dev)
    info = {
        "cpu_model": _cpu_model(),
        "cpus": os.cpu_count(),
        "machine": _platform.machine(),
        "system": _platform.system(),
        "python": sys.version.split()[0],
        "numpy": np.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": name,
        "power_limit": limit,
    }
    key = "|".join(f"{k}={info[k]}" for k in sorted(info))
    info["fingerprint"] = hashlib.sha256(key.encode()).hexdigest()[:12]
    info["hostname"] = _platform.node()
    return tuple(info.items())


def host_fingerprint() -> dict:
    """Stable identity of the machine and device a benchmark ran on.

    ``fingerprint`` hashes only the fields that change benchmark meaning
    (CPU model, core count, arch, python/numpy/torch/CUDA versions, the
    device the calling context selected and its power limit) — not
    hostname or time — so two runs on identical hosts compare cleanly.
    ``device`` is the card's name, ``"cpu"`` when the CPU was asked for,
    and ``"none"`` when a card is selected but none is visible: this
    never raises (it is metadata; the sweep itself raises through
    ``current_device()``). Computed once per device per process (a
    sweep saves ~140 record files, each stamped with it); callers get a
    fresh copy.
    """
    return dict(_host_info(selected_device()))


def roofline_terms(
    flops_per_chip: float,
    hbm_bytes_per_chip: float,
    collective_bytes_per_chip: float,
    chip: ChipSpec = H100_SXM,
    flops_per_s: Optional[float] = None,
) -> dict:
    """Three-term roofline in seconds-per-step, per card.

    All inputs are per-card quantities. The compute term is at
    ``flops_per_s``, by default the card's dense bf16 tensor-core rate
    (pass ``chip.peak_fp32_flops`` for work done outside the tensor
    cores); the collective term models each card pushing its collective
    payload through one NVLink link in one direction (the conservative
    single-link bound).
    """
    compute_s = flops_per_chip / (flops_per_s or chip.peak_bf16_flops)
    memory_s = hbm_bytes_per_chip / chip.hbm_bandwidth
    collective_s = collective_bytes_per_chip / chip.link_bandwidth
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=lambda k: terms[k])
    bound = max(terms.values())
    total = max(bound, 1e-30)
    terms["dominant"] = dominant
    terms["bound_s"] = bound
    # Roofline fraction: useful-compute time over the binding resource time.
    terms["roofline_fraction"] = compute_s / total
    return terms
