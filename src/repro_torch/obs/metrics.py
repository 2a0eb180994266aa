"""Pull-based metrics: counters, gauges, histograms in one registry.

The counterpart of ``obs.trace``: traces explain one run, metrics watch
a running system. ``ServiceMetrics`` (repro_torch.service.metrics) is built on
this registry instead of hand-rolled dict counters, and anything else
(loader, store, bench) can register instruments against the same
registry and show up in one ``snapshot()`` / Prometheus exposition.

Instruments are label-aware in the Prometheus style: ``inc``/``set``/
``observe`` take keyword labels, and each distinct label set is its own
series. Histograms have *fixed* bucket boundaries (exposition-friendly,
mergeable across processes) plus a bounded sample window so exact
nearest-rank quantiles (``core.stats.percentile`` — the same helper the
loader's stats use) stay available for SLO-style readouts.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS"]

# log-spaced 100us..60s: decode latencies span ~0.5ms (cache hit) to
# multi-second overload queueing
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically increasing count, one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def items(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def snapshot(self):
        items = self.items()
        if not items:
            return 0.0
        if len(items) == 1 and not items[0][0]:
            return items[0][1]                 # unlabeled: bare number
        return {",".join(f"{k}={v}" for k, v in sorted(lab.items())): val
                for lab, val in items}

    def expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(_label_key(lab))} {val:g}"
                for lab, val in self.items()] or [f"{self.name} 0"]


class Gauge(_Instrument):
    """Point-in-time value: set explicitly, or pulled from a callback at
    read time (e.g. queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help)
        self._fn = fn
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def snapshot(self):
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            items = sorted(self._values.items())
        if len(items) <= 1 and (not items or not items[0][0]):
            return items[0][1] if items else 0.0
        return {",".join(f"{k}={v}" for k, v in key): val
                for key, val in items}

    def expose(self) -> List[str]:
        if self._fn is not None:
            return [f"{self.name} {self.value():g}"]
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(key)} {val:g}"
                for key, val in items] or [f"{self.name} 0"]


class _HistSeries:
    """State of one histogram label set. The owning Histogram's lock
    guards every access; this is a plain record, not a lockable."""

    __slots__ = ("counts", "sum", "count", "window")

    def __init__(self, n_buckets: int, window: int):
        self.counts = [0] * (n_buckets + 1)            # +1: +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.window: deque = deque(maxlen=window)


class Histogram(_Instrument):
    """Fixed-boundary bucket histogram + bounded exact-sample window,
    one series per label set (same label model as Counter/Gauge).

    Buckets carry the Prometheus cumulative-``le`` exposition; the
    sample window (most recent ``window`` observations per series) backs
    exact nearest-rank ``quantile()`` readouts through the one shared
    ``core.stats.percentile`` helper. Reads without labels aggregate
    across every series, so unlabeled callers see the historical
    whole-instrument view; reads with labels select that series.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 window: int = 2048):
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._window_size = int(window)
        self._series: Dict[_LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        idx = bisect_left(self.buckets, v)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _HistSeries(len(self.buckets), self._window_size)
                self._series[key] = s
            s.counts[idx] += 1
            s.sum += v
            s.count += 1
            s.window.append(v)

    def _selected(self, labels: Dict[str, object]) -> List[_HistSeries]:
        """Series matching the read: all of them when unlabeled (the
        aggregate view), else exactly the named one. Caller holds lock."""
        if not labels:
            return list(self._series.values())
        s = self._series.get(_label_key(labels))
        return [s] if s is not None else []

    @property
    def count(self) -> int:
        with self._lock:
            return sum(s.count for s in self._series.values())

    @property
    def sum(self) -> float:
        with self._lock:
            return sum(s.sum for s in self._series.values())

    def quantile(self, p: float, **labels) -> float:
        """Exact nearest-rank quantile over the recent sample window
        (merged across series when unlabeled)."""
        # deferred, as in the reference: importing obs (which jpeg does
        # for its spans) loads nothing of core
        from repro_torch.core.stats import percentile
        with self._lock:
            samples = [v for s in self._selected(labels) for v in s.window]
        return percentile(samples, p)

    def bucket_counts(self, **labels) -> Dict[str, int]:
        """Cumulative counts keyed by upper bound (Prometheus ``le``)."""
        with self._lock:
            totals = [0] * (len(self.buckets) + 1)
            for s in self._selected(labels):
                for i, c in enumerate(s.counts):
                    totals[i] += c
        out, running = {}, 0
        for b, c in zip(self.buckets, totals):
            running += c
            out[f"{b:g}"] = running
        out["+Inf"] = running + totals[-1]
        return out

    def labelsets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in sorted(self._series)]

    def snapshot(self):
        with self._lock:
            count = sum(s.count for s in self._series.values())
            total = sum(s.sum for s in self._series.values())
        return {"count": count, "sum": total,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def expose(self) -> List[str]:
        with self._lock:
            series = [(key, list(s.counts), s.sum, s.count)
                      for key, s in sorted(self._series.items())]
        if not series:
            # an observation-free histogram still exposes its (empty)
            # unlabeled series, as before label support
            series = [((), [0] * (len(self.buckets) + 1), 0.0, 0)]
        lines: List[str] = []
        for key, counts, total, count in series:
            running = 0
            for b, c in zip(self.buckets, counts):
                running += c
                le = 'le="%g"' % b
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(key, le)} {running}")
            inf = 'le="+Inf"'
            lines.append(
                f"{self.name}_bucket{_fmt_labels(key, inf)} "
                f"{running + counts[-1]}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {total:g}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {count}")
        return lines


class MetricsRegistry:
    """Named instruments with get-or-create semantics and two read
    surfaces: structured ``snapshot()`` and Prometheus-style text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help=help, fn=fn)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  window: int = 2048) -> Histogram:
        return self._get_or_create(Histogram, name, help=help,
                                   buckets=buckets, window=window)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def render_prometheus(self) -> str:
        """Text exposition (one registry = one scrape page)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"
