"""Shared plumbing of the paper-table views (the port of
``benchmarks/common.py``): timing, artifact output, and the one shared
sweep that every live view reads (one measurement pass per process
instead of nine ad-hoc loops)."""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.bench.harness import DEFAULT_OUT
from repro_torch.device import (DeviceLike, current_device, selected_device,
                                use_device)

ARTIFACTS = DEFAULT_OUT

_SWEEP_CACHE: Dict[Tuple[str, str], object] = {}


def sweep_records(quick: bool = True,
                  device: Optional[DeviceLike] = None):
    """Live RunRecords for the table views, measured once per process,
    profile and device by the bench harness (quick -> 'quick' profile,
    else 'full') and written to ``ARTIFACTS`` as a side effect. The sweep
    runs on ``device``, else on the device the calling context selected
    (the card by default)."""
    from repro_torch.bench import run_sweep
    profile = "quick" if quick else "full"
    with use_device(device or selected_device()):
        dev = current_device()
    key = (profile, str(dev))
    if key not in _SWEEP_CACHE:
        _SWEEP_CACHE[key] = run_sweep(profile, out_dir=ARTIFACTS,
                                      device=dev)
    return _SWEEP_CACHE[key].records


def live_platform(records) -> str:
    """The one platform a sweep's records carry: the card's name on the
    card, ``"live-host"`` on the CPU (``run_sweep``'s labels)."""
    platforms = sorted({r.platform for r in records})
    if len(platforms) != 1:
        raise RuntimeError(f"the live views read one sweep of one "
                           f"platform; the records carry {platforms}")
    return platforms[0]


def time_us(fn: Callable, *, repeats: int = 5, number: int = 1) -> float:
    """Best of ``repeats`` of ``number`` calls of ``fn``, in microseconds
    per call, after one warm-up call. On the card each repeat is a pair
    of CUDA events on the current stream around its ``number`` calls
    (what the card takes for them, host launch gaps included); on the CPU
    it is the host clock."""
    fn()
    if current_device().type != "cuda":
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(number):
                fn()
            best = min(best, (time.perf_counter() - t0) / number)
        return best * 1e6
    best_ms = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(number):
            fn()
        end.record()
        end.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end) / number)
    return best_ms * 1e3


def emit(rows: List[Tuple[str, float, str]]) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def save_json(name: str, obj) -> None:
    os.makedirs(ARTIFACTS, exist_ok=True)
    with open(os.path.join(ARTIFACTS, name), "w") as f:
        json.dump(obj, f, indent=1, default=str)
