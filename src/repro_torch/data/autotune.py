"""Online worker-count autotuner — the paper's worker sweep as a feature.

Paper finding (§4.3): the optimal worker count is decoder- AND
CPU-generation-specific (Zen 4 peaks at w=4, Zen 5 at w=8), so it cannot be
baked into a config. This runs a short measured sweep on the *deployment*
machine at startup and picks the measured peak — turning the paper's
evaluation protocol into an operational knob.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np


def measure_throughput(loader_factory: Callable[[int], "DataLoader"],
                       workers: int, *, max_items: int = 64,
                       repeats: int = 1) -> Tuple[float, float]:
    """items/s (mean, std) over `repeats` measured passes."""
    samples = []
    for _ in range(repeats):
        loader = loader_factory(workers)
        n = 0
        t0 = time.perf_counter()
        for batch in loader:
            n += batch["image"].shape[0]
            if n >= max_items:
                break
        dt = time.perf_counter() - t0
        samples.append(n / dt if dt > 0 else 0.0)
    return float(np.mean(samples)), float(np.std(samples))


def autotune_workers(loader_factory: Callable[[int], "DataLoader"],
                     candidates: Sequence[int] = (0, 2, 4, 8),
                     *, max_items: int = 64, repeats: int = 2,
                     practical_threshold: float = 0.05) -> Dict:
    """Sweep candidates, return {'best': w, 'sweep': {w: (mean, std)}}.

    Within the 5% practical-significance band (paper's loader threshold)
    the SMALLEST worker count wins — fewer workers, same throughput.
    """
    sweep = {}
    for w in candidates:
        sweep[w] = measure_throughput(loader_factory, w,
                                      max_items=max_items, repeats=repeats)
    peak = max(sweep.values(), key=lambda ms: ms[0])[0]
    eligible = [w for w in candidates
                if sweep[w][0] >= peak * (1.0 - practical_threshold)]
    return {"best": min(eligible), "peak_workers":
            max(sweep, key=lambda w: sweep[w][0]), "sweep": sweep}
