"""Online decoder selection: a bandit over the eligible decode paths.

The paper's core finding is that decoder rank is a *deployment-context*
property — single-thread rank does not predict DataLoader rank, and
neither predicts rank under live service load (batching, cache effects,
co-running workers). So instead of picking one decoder offline, the
router treats each eligible path as a bandit arm and learns from measured
service throughput (images/second of actual served batches):

* ``ucb`` (default) — UCB1 on normalized throughput: each pull scores
  ``mean/peak + c*sqrt(ln N / n)``; unexplored arms are pulled first.
* ``epsilon`` — epsilon-greedy: explore a uniform arm with prob. eps.

Robustness is a routing signal, not an afterthought: when a strict path
raises ``UnsupportedJpeg`` the engine records a skip against that arm and
retries on ``fallback()`` (the best non-strict arm). ``best()`` and
``tier()`` apply the paper's zero-skip filter and 90% practical floor by
feeding arm statistics through ``core.decision`` — the offline decision
protocol (Table 4) evaluated continuously on live measurements.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.codecs import (ExecContext, as_spec, eligible,
                               list_decoders)
from repro_torch.core import decision, stats
from repro_torch.core.schema import RunRecord


class ArmState:
    """Measured state of one decode path arm (a ``codecs.DecoderSpec``
    or any legacy path-like object with name/strict/engine)."""

    def __init__(self, path, window: int):
        self.path = path
        self.samples: deque = deque(maxlen=window)   # images/s per batch
        self.pulls = 0
        self.images = 0
        self.skips = 0

    @property
    def mean(self) -> float:
        return stats.mean_std(list(self.samples))[0] if self.samples else 0.0


class BanditRouter:
    def __init__(self, paths: Optional[Sequence] = None, *,
                 policy: str = "ucb", epsilon: float = 0.1,
                 ucb_c: float = 1.5, window: int = 128, seed: int = 0):
        if policy not in ("ucb", "epsilon"):
            raise ValueError(f"unknown bandit policy {policy!r}")
        # arm set scoped by the one eligibility authority: every decoder
        # the resolver admits for the SERVICE context is a bandit arm
        # (the port's arms may also be named: each becomes its spec)
        paths = ([as_spec(p) for p in paths] if paths is not None else
                 [s for s in list_decoders()
                  if eligible(s.caps, ExecContext.SERVICE)])
        if not paths:
            raise ValueError("router needs at least one decode path")
        self.policy = policy
        self.epsilon = float(epsilon)
        self.ucb_c = float(ucb_c)
        self._arms: Dict[str, ArmState] = {
            p.name: ArmState(p, window) for p in paths}
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._total_pulls = 0

    # ------------------------------------------------------------ choose
    def pick(self):
        with self._lock:
            cold = [a for a in self._arms.values() if a.pulls == 0]
            if cold:
                arm = cold[int(self._rng.randint(len(cold)))]
            elif self.policy == "epsilon" and \
                    self._rng.rand() < self.epsilon:
                names = list(self._arms)
                arm = self._arms[names[int(self._rng.randint(len(names)))]]
            elif self.policy == "epsilon":
                arm = max(self._arms.values(), key=lambda a: a.mean)
            else:
                arm = max(self._arms.values(), key=self._ucb_score)
            arm.pulls += 1
            self._total_pulls += 1
            return arm.path

    def _ucb_score(self, arm: ArmState) -> float:
        peak = max((a.mean for a in self._arms.values()), default=0.0)
        exploit = arm.mean / peak if peak > 0 else 0.0
        explore = self.ucb_c * math.sqrt(
            math.log(max(self._total_pulls, 2)) / arm.pulls)
        return exploit + explore

    # ------------------------------------------------------------ learn
    def update(self, name: str, n_images: int, seconds: float) -> None:
        """Feed one measured service: n_images decoded in `seconds`."""
        if n_images <= 0 or seconds <= 0:
            return
        with self._lock:
            arm = self._arms[name]
            arm.samples.append(n_images / seconds)
            arm.images += n_images

    def record_skip(self, name: str) -> None:
        """A strict arm refused an input — the ledger as routing signal."""
        with self._lock:
            self._arms[name].skips += 1

    def fallback(self, failed_name: str):
        """Best-measured non-strict arm to retry an UnsupportedJpeg on."""
        with self._lock:
            cands = [a for a in self._arms.values()
                     if not a.path.strict and a.path.name != failed_name]
            if not cands:
                return None
            return max(cands, key=lambda a: a.mean).path

    # ------------------------------------------------------------ decide
    def records(self) -> List[RunRecord]:
        """Arm statistics as RunRecords, so core.decision applies as-is."""
        out = []
        with self._lock:
            for arm in self._arms.values():
                samples = list(arm.samples)
                mean, std = stats.mean_std(samples) if samples else (0.0, 0.0)
                out.append(RunRecord(
                    platform="service", decoder=arm.path.name,
                    protocol="dataloader", workers=-1, mode="service",
                    throughput_mean=mean, throughput_std=std,
                    samples=samples, num_images=arm.images,
                    skip_indices=list(range(arm.skips)),
                    meta={"engine": arm.path.engine,
                          "strict": arm.path.strict, "eligible": True,
                          "pulls": arm.pulls}))
        return out

    def best(self) -> Optional[str]:
        """Highest measured-throughput *zero-skip* arm (paper §4.4: skips
        change eligibility before speed is compared)."""
        recs = {r.decoder: r for r in self.records() if r.samples}
        safe = decision.zero_skip(recs)
        pool = safe or recs            # all arms skipped: fall back to speed
        if not pool:
            return None
        return max(pool.values(), key=lambda r: r.throughput_mean).decoder

    def tier(self) -> List[decision.TierEntry]:
        """The paper's robust tier (zero-skip + practical floor), computed
        over live service measurements."""
        return decision.robust_tier([r for r in self.records() if r.samples])

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {"pulls": arm.pulls, "images": arm.images,
                           "skips": arm.skips, "mean_ips": arm.mean}
                    for name, arm in self._arms.items()}
