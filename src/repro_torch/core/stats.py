"""Statistical policy of the paper (§3): descriptive mean±std, Spearman rank
correlation over raw samples, and practical-significance thresholds (1%
single-thread, 5% DataLoader) before strict faster/slower language.

The same thresholds drive the bench compare gate: a cross-commit delta is
only a regression once it clears both the protocol's practical threshold
and the measured run-to-run noise (``noise_gate``)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

SINGLE_THREAD_THRESHOLD = 0.01
DATALOADER_THRESHOLD = 0.05


def protocol_threshold(protocol: str) -> float:
    """Practical-significance floor by evaluation protocol. Anything that
    goes through a pool/queue (dataloader, service) gets the looser 5%."""
    return (SINGLE_THREAD_THRESHOLD if protocol == "single_thread"
            else DATALOADER_THRESHOLD)


def coefficient_of_variation(samples: Sequence[float]) -> float:
    m, s = mean_std(samples)
    return s / m if m > 0 else 0.0


def noise_gate(samples_a: Sequence[float], samples_b: Sequence[float],
               *, z: float = 2.0) -> float:
    """Relative delta explainable by run-to-run noise alone: z times the
    combined coefficient of variation of the two sample sets. With < 2
    samples a side contributes zero — the practical threshold then carries
    the gate."""
    cv_a = coefficient_of_variation(samples_a)
    cv_b = coefficient_of_variation(samples_b)
    return z * float(np.sqrt(cv_a ** 2 + cv_b ** 2))


def percentile(samples: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over raw samples, ``p`` in [0, 1].

    The smallest sample with at least ``p`` of the mass at or below it:
    rank ``ceil(p * n)`` (1-based), so p50 of two samples is the
    *smaller* one — unlike the old ``int(p * n)`` indexing, which was
    biased one rank high on small windows. Empty input reads 0.0. The
    one percentile definition shared by ``DataLoader.stats()`` and the
    ``repro_torch.obs`` histogram quantiles."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")
    s = sorted(samples)
    if not s:
        return 0.0
    rank = max(1, int(np.ceil(p * len(s))))
    return float(s[rank - 1])


def mean_std(samples: Sequence[float]) -> Tuple[float, float]:
    a = np.asarray(samples, dtype=np.float64)
    if a.size == 0:                 # defined value, not NaN + RuntimeWarning
        return 0.0, 0.0
    return float(a.mean()), float(a.std(ddof=1)) if len(a) > 1 else 0.0


def rankdata(values: Sequence[float]) -> np.ndarray:
    """Average ranks (1 = largest value), ties averaged."""
    v = np.asarray(values, dtype=np.float64)
    order = np.argsort(-v, kind="stable")
    ranks = np.empty(len(v), dtype=np.float64)
    ranks[order] = np.arange(1, len(v) + 1)
    for val in np.unique(v):
        mask = v == val
        if mask.sum() > 1:
            ranks[mask] = ranks[mask].mean()
    return ranks


def spearman_rho(x: Sequence[float], y: Sequence[float]) -> float:
    if len(x) < 2:
        return 1.0
    rx, ry = rankdata(x), rankdata(y)
    rx = rx - rx.mean()
    ry = ry - ry.mean()
    denom = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    return float((rx * ry).sum() / denom) if denom else 0.0


def practically_faster(a_mean: float, b_mean: float,
                       threshold: float) -> bool:
    """a is 'faster' than b only beyond the practical threshold."""
    return a_mean > b_mean * (1.0 + threshold)


def comparison_language(a_mean: float, b_mean: float,
                        threshold: float) -> str:
    if practically_faster(a_mean, b_mean, threshold):
        return "faster"
    if practically_faster(b_mean, a_mean, threshold):
        return "slower"
    return "tied"


def rank_moves(single: Dict[str, float], loader: Dict[str, float]
               ) -> Dict[str, Tuple[int, int]]:
    """decoder -> (single-thread rank, loader rank); common keys only."""
    keys = [k for k in single if k in loader]
    if not keys:
        return {}
    sr = rankdata([single[k] for k in keys])
    lr = rankdata([loader[k] for k in keys])
    return {k: (int(round(sr[i])), int(round(lr[i])))
            for i, k in enumerate(keys)}


def largest_rank_move(single: Dict[str, float], loader: Dict[str, float]
                      ) -> Tuple[str, int, int]:
    moves = rank_moves(single, loader)
    if not moves:                   # empty key intersection: no move
        return ("", 0, 0)
    name = max(moves, key=lambda k: abs(moves[k][0] - moves[k][1]))
    return (name,) + moves[name]
