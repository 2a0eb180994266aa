"""Declarative SLOs over live metrics: objectives, burn rates, audit log.

The layer between ``obs.metrics`` (raw instruments) and the service's
admission decisions. An :class:`SLOObjective` declares what fraction of
events must be *good* — observations under a latency threshold, or
requests that didn't fail — and an :class:`SLOTracker` turns the
registry's cumulative instruments into multi-window **burn rates**:

    burn = (bad_delta / total_delta) / error_budget      over a window

where ``error_budget = 1 - objective``. Burn 1.0 means the service is
consuming its budget exactly as fast as the objective allows; burn 10
on a 99.9% objective means full budget exhaustion in 1/10 of the
period. Shedding gates on *every* configured window burning at once
(the classic multi-window rule): the short window proves the problem is
happening now, the long window proves it is not a blip, so admission
does not flap on a single slow batch.

:class:`DecisionLog` is the structured audit trail: every admission
verdict (admit or shed) is recorded with the live signal it was decided
against, so "why was this request shed?" has a machine-readable answer.

Evaluation is snapshot-based like a Prometheus ``rate()``: the tracker
samples ``(t, bad_total, good_total)`` points into a bounded ring and
differences them, so it never needs per-request hooks and costs nothing
on the hot path beyond a monotonic-clock read.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry

__all__ = ["SLOObjective", "SLOTracker", "DecisionLog",
           "DEFAULT_WINDOWS_S"]

#: fast / medium / slow trailing windows (seconds) for burn conjunction
DEFAULT_WINDOWS_S: Tuple[float, ...] = (60.0, 300.0, 1800.0)

_KINDS = ("latency", "error_ratio")


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One declarative objective: a target fraction of good events.

    kind ``latency``: good = observations of histogram ``metric`` at or
    under ``threshold_s``. The threshold is snapped down to the nearest
    histogram bucket boundary at evaluation (bucket counts are the only
    cumulative latency signal), so pick thresholds on boundaries — the
    default latency buckets include 0.1/0.25/0.5/1.0.

    kind ``error_ratio``: good = ``total`` counter minus ``bad``
    counter (e.g. requests minus failures).
    """

    name: str
    kind: str
    objective: float                 # target good fraction, e.g. 0.99
    metric: str = ""                 # latency: histogram name
    threshold_s: float = 0.0         # latency: good iff value <= this
    total: str = ""                  # error_ratio: total counter name
    bad: str = ""                    # error_ratio: bad counter name

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"objective {self.name!r}: kind must be one "
                             f"of {_KINDS}, got {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective {self.name!r}: objective must be "
                             f"in (0, 1), got {self.objective}")
        if self.kind == "latency" and (not self.metric
                                       or self.threshold_s <= 0):
            raise ValueError(f"objective {self.name!r}: latency kind needs "
                             "metric= and threshold_s>0")
        if self.kind == "error_ratio" and (not self.total or not self.bad):
            raise ValueError(f"objective {self.name!r}: error_ratio kind "
                             "needs total= and bad= counter names")

    @property
    def budget(self) -> float:
        """Error budget: the tolerated bad fraction."""
        return 1.0 - self.objective

    @staticmethod
    def latency(name: str, metric: str, threshold_s: float,
                objective: float = 0.99) -> "SLOObjective":
        return SLOObjective(name=name, kind="latency", objective=objective,
                            metric=metric, threshold_s=threshold_s)

    @staticmethod
    def error_ratio(name: str, total: str, bad: str,
                    objective: float = 0.999) -> "SLOObjective":
        return SLOObjective(name=name, kind="error_ratio",
                            objective=objective, total=total, bad=bad)


def _counter_total(c: Optional[Counter]) -> float:
    if c is None:
        return 0.0
    return sum(v for _, v in c.items())


class SLOTracker:
    """Samples objectives from a registry and computes windowed burn.

    ``sample()`` appends one ``(t, bad, total)`` point per objective to
    a bounded ring; ``burn_rates()`` differences the newest point
    against the oldest point inside each trailing window. The hot-path
    entry ``should_shed()`` re-samples at most once per
    ``min_sample_interval_s`` and otherwise returns the cached verdict,
    so admission can call it on every request.
    """

    def __init__(self, registry: MetricsRegistry,
                 objectives: Sequence[SLOObjective], *,
                 windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
                 shed_burn: Optional[float] = None,
                 min_sample_interval_s: float = 1.0,
                 maxlen: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        objectives = list(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        windows = tuple(float(w) for w in windows_s)
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(f"windows must be positive: {windows_s}")
        if shed_burn is not None and shed_burn <= 0:
            raise ValueError(f"shed_burn must be positive: {shed_burn}")
        self.registry = registry
        self.objectives = objectives
        self.windows_s = tuple(sorted(windows))
        self.shed_burn = shed_burn
        self.min_sample_interval_s = float(min_sample_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._points: Dict[str, Deque[Tuple[float, float, float]]] = {
            o.name: deque(maxlen=maxlen) for o in objectives}
        self._last_sample = float("-inf")
        self._verdict: Tuple[bool, Dict[str, object]] = (False, {})

    # ------------------------------------------------------------ reads
    def _read(self, o: SLOObjective) -> Tuple[float, float]:
        """Cumulative (bad, total) for one objective right now."""
        if o.kind == "latency":
            h = self.registry.get(o.metric)
            if not isinstance(h, Histogram):
                return 0.0, 0.0
            le = self._effective_threshold(o, h)
            bc = h.bucket_counts()
            total = float(bc["+Inf"])
            good = float(bc.get(f"{le:g}", 0.0)) if le is not None else 0.0
            return total - good, total
        total_c = self.registry.get(o.total)
        bad_c = self.registry.get(o.bad)
        return (_counter_total(bad_c if isinstance(bad_c, Counter)
                               else None),
                _counter_total(total_c if isinstance(total_c, Counter)
                               else None))

    @staticmethod
    def _effective_threshold(o: SLOObjective,
                             h: Histogram) -> Optional[float]:
        """Largest bucket boundary at or under the declared threshold
        (tiny epsilon so 0.25 matches the 0.25 boundary exactly)."""
        limit = o.threshold_s * (1.0 + 1e-9)
        eligible = [b for b in h.buckets if b <= limit]
        return eligible[-1] if eligible else None

    # --------------------------------------------------------- sampling
    def sample(self, t: Optional[float] = None) -> None:
        """Read every objective and append one point per ring."""
        now = self._clock() if t is None else float(t)
        readings = [(o.name, self._read(o)) for o in self.objectives]
        with self._lock:
            for name, (bad, total) in readings:
                self._points[name].append((now, bad, total))
            self._last_sample = now
            self._verdict = self._evaluate_locked(now)

    def maybe_sample(self, t: Optional[float] = None) -> bool:
        now = self._clock() if t is None else float(t)
        with self._lock:
            due = now - self._last_sample >= self.min_sample_interval_s
        if due:
            self.sample(now)
        return due

    # ------------------------------------------------------- burn rates
    def _burns_locked(self, name: str, now: float) -> Dict[str, float]:
        pts = self._points[name]
        out: Dict[str, float] = {}
        budget = next(o for o in self.objectives if o.name == name).budget
        for w in self.windows_s:
            key = f"{w:g}s"
            start = now - w
            newest = pts[-1] if pts else None
            oldest = None
            for pt in pts:                       # oldest-first scan
                if pt[0] >= start:
                    oldest = pt
                    break
            if newest is None or oldest is None or newest is oldest:
                out[key] = 0.0
                continue
            bad_d = newest[1] - oldest[1]
            total_d = newest[2] - oldest[2]
            if total_d <= 0:
                out[key] = 0.0                   # no traffic: not burning
                continue
            out[key] = max(0.0, bad_d / total_d) / budget
        return out

    def burn_rates(self, name: str,
                   t: Optional[float] = None) -> Dict[str, float]:
        """Burn per window for one objective, keyed like ``"60s"``."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            if name not in self._points:
                raise KeyError(f"unknown objective {name!r}")
            return self._burns_locked(name, now)

    def _evaluate_locked(self, now: float) -> Tuple[bool, Dict[str, object]]:
        """Shed verdict: some objective burning >= shed_burn on *every*
        window. Returns (shed, signal-for-the-audit-log)."""
        if self.shed_burn is None:
            return False, {}
        for o in self.objectives:
            burns = self._burns_locked(o.name, now)
            if burns and all(b >= self.shed_burn for b in burns.values()):
                return True, {"objective": o.name, "burn": burns,
                              "shed_burn": self.shed_burn}
        return False, {}

    def should_shed(self) -> Tuple[bool, Dict[str, object]]:
        """Hot-path gate: cached verdict, refreshed at sample cadence."""
        if self.shed_burn is None:
            return False, {}
        self.maybe_sample()
        with self._lock:
            shed, signal = self._verdict
            return shed, dict(signal)

    # ----------------------------------------------------------- status
    def status(self) -> Dict[str, object]:
        """Structured JSON-ready view (the ``/slo`` endpoint body)."""
        self.sample()
        now = self._clock()
        out: List[Dict[str, object]] = []
        with self._lock:
            shed, signal = self._verdict
            for o in self.objectives:
                pts = self._points[o.name]
                bad, total = (pts[-1][1], pts[-1][2]) if pts else (0.0, 0.0)
                good_ratio = 1.0 - (bad / total) if total > 0 else 1.0
                entry: Dict[str, object] = {
                    "name": o.name, "kind": o.kind,
                    "objective": o.objective, "budget": o.budget,
                    "good_ratio": good_ratio,
                    "budget_remaining":
                        1.0 - (1.0 - good_ratio) / o.budget,
                    "bad": bad, "total": total,
                    "burn": self._burns_locked(o.name, now),
                }
                if o.kind == "latency":
                    entry["metric"] = o.metric
                    entry["threshold_s"] = o.threshold_s
                    h = self.registry.get(o.metric)
                    if isinstance(h, Histogram):
                        entry["observed_quantile_s"] = h.quantile(
                            o.objective)
                else:
                    entry["total_metric"] = o.total
                    entry["bad_metric"] = o.bad
                out.append(entry)
        return {"t": time.time(), "windows_s": list(self.windows_s),
                "shed_burn": self.shed_burn, "should_shed": shed,
                "shed_signal": signal, "objectives": out}


class DecisionLog:
    """Bounded structured audit log of admission decisions.

    Each entry records the verdict, the stated reason, and the live
    signal (inflight counts, burn rates, …) it was decided against.
    """

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._entries: Deque[Dict[str, object]] = deque(maxlen=maxlen)
        self._counts: Dict[str, int] = {}

    def record(self, decision: str, *, client: str = "",
               reason: str = "",
               signal: Optional[Dict[str, object]] = None
               ) -> Dict[str, object]:
        entry: Dict[str, object] = {
            "t": time.time(), "decision": decision, "client": client,
            "reason": reason, "signal": dict(signal or {})}
        with self._lock:
            self._entries.append(entry)
            self._counts[decision] = self._counts.get(decision, 0) + 1
        return entry

    def entries(self, decision: Optional[str] = None,
                limit: Optional[int] = None) -> List[Dict[str, object]]:
        with self._lock:
            out = [dict(e) for e in self._entries
                   if decision is None or e["decision"] == decision]
        return out[-limit:] if limit else out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
