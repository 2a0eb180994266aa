"""Service observability: rolling latency percentiles, throughput, queue
depth, and per-path hit/skip counters, exportable as JSON.

The paper's protocol argument (measure the deployment context, not the
component) applies to operations too: the service exposes the same
delivered-throughput lens the LoaderProtocol uses, but *continuously*,
over a sliding window, so the router and operators see the live context.

``ServiceMetrics`` is built on the ``repro_torch.obs`` metrics registry —
counters, a callback gauge for queue depth, and a latency histogram —
instead of hand-rolled dict counters, so service metrics share one
snapshot/Prometheus surface with everything else instrumented against
the same registry. ``snapshot()`` keeps its historical key set (the
shape ``engine.stats()`` consumers and tests rely on); the registry
adds the structured/exposition views on top.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from repro_torch.core.stats import percentile
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SLOObjective

PERCENTILES = (50.0, 95.0, 99.0)
RATE_HORIZON_S = 30.0


def default_slo_objectives(*, latency_target_s: float = 0.25,
                           latency_objective: float = 0.99,
                           availability_objective: float = 0.999):
    """The service's stock SLO pair against its own registry metrics:
    p<latency_objective> of completions under ``latency_target_s``
    (pick targets on histogram bucket boundaries — see
    ``DEFAULT_LATENCY_BUCKETS``), and ``availability_objective`` of
    submitted requests not failing."""
    return [
        SLOObjective.latency(
            "latency", metric="service_latency_seconds",
            threshold_s=latency_target_s, objective=latency_objective),
        SLOObjective.error_ratio(
            "availability", total="service_requests_total",
            bad="service_failed_total",
            objective=availability_objective),
    ]


class RollingWindow:
    """Bounded sample window of (timestamp, value) pairs."""

    def __init__(self, maxlen: int = 2048):
        self._samples: deque = deque(maxlen=maxlen)

    def add(self, value: float, t: Optional[float] = None) -> None:
        self._samples.append((time.monotonic() if t is None else t, value))

    def __len__(self) -> int:
        return len(self._samples)

    def values(self) -> list:
        return [v for _, v in self._samples]

    def percentiles(self) -> Dict[str, float]:
        vals = self.values()
        return {f"p{int(p)}": percentile(vals, p / 100.0)
                for p in PERCENTILES}

    def rate(self, horizon_s: float = RATE_HORIZON_S) -> float:
        """Events per second over the trailing horizon, estimated from
        inter-arrival spacing: (n-1) / (last - first). A lone event (or a
        burst shorter than the clock can resolve) reports 0.0 rather than
        the near-infinite n/epsilon a naive span division produces.

        Samples arrive in time order, so the scan walks the deque from
        the newest entry and stops at the first one outside the horizon
        — O(events in horizon), not a full-window pass per call."""
        cutoff = time.monotonic() - horizon_s
        n = 0
        first = last = 0.0
        for t, _ in reversed(self._samples):
            if t < cutoff:
                break
            if n == 0:
                last = t
            first = t
            n += 1
        if n < 2:
            return 0.0
        span = last - first
        return (n - 1) / span if span > 0 else 0.0


class ServiceMetrics:
    """Aggregated counters + rolling latency for the decode service,
    registered against a ``repro_torch.obs.MetricsRegistry``."""

    def __init__(self, *, window: int = 2048,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self.registry = registry or MetricsRegistry()
        reg = self.registry
        self._requests = reg.counter(
            "service_requests_total", help="requests offered at submit()")
        self._completed = reg.counter(
            "service_completed_total", help="futures resolved with pixels")
        self._failed = reg.counter(
            "service_failed_total", help="futures failed with an error")
        self._shed = reg.counter(
            "service_shed_total", help="requests shed at admission")
        self._cache_hits = reg.counter(
            "service_cache_hits_total", help="decode-cache hits at submit")
        self._path_hits = reg.counter(
            "service_path_hits_total", help="completions per decode path")
        self._path_skips = reg.counter(
            "service_path_skips_total",
            help="strict-path refusals per decode path")
        self._latency = reg.histogram(
            "service_latency_seconds",
            help="submit-to-result latency", window=window)
        self._queue_depth_fn = queue_depth_fn
        if queue_depth_fn is not None:
            reg.gauge("service_queue_depth",
                      help="requests queued between submit and decode",
                      fn=queue_depth_fn)
        self._completions = RollingWindow(maxlen=window)

    # ------------------------------------------------------------ record
    def record_request(self) -> None:
        self._requests.inc()

    def record_shed(self) -> None:
        self._shed.inc()

    def record_cache_hit(self) -> None:
        with self._lock:
            self._cache_hits.inc()
            self._completed.inc()
            self._completions.add(1.0)

    def record_completion(self, path_name: str, latency_s: float) -> None:
        with self._lock:
            self._completed.inc()
            # per-path latency series; unlabeled reads still aggregate
            self._latency.observe(latency_s, path=path_name)
            self._completions.add(1.0)
            self._path_hits.inc(path=path_name)

    def record_skip(self, path_name: str) -> None:
        """A strict path refused an input (the ledger-as-signal event)."""
        self._path_skips.inc(path=path_name)

    def record_failure(self) -> None:
        self._failed.inc()

    # ------------------------------------------------------------ export
    def _by_path(self, counter) -> Dict[str, int]:
        return {lab["path"]: int(v) for lab, v in counter.items() if lab}

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            snap: Dict[str, object] = {
                "requests": int(self._requests.value()),
                "completed": int(self._completed.value()),
                "failed": int(self._failed.value()),
                "shed": int(self._shed.value()),
                "cache_hits": int(self._cache_hits.value()),
                "latency_s": {
                    f"p{int(p)}": self._latency.quantile(p / 100.0)
                    for p in PERCENTILES},
                "throughput_rps": self._completions.rate(),
                "rate_horizon_s": RATE_HORIZON_S,
                "path_hits": self._by_path(self._path_hits),
                "path_skips": self._by_path(self._path_skips),
            }
            if self._queue_depth_fn is not None:
                # sampled under the same lock as the counters, so one
                # snapshot is one consistent point in time (it used to be
                # read outside the lock, against a later queue state)
                snap["queue_depth"] = int(self._queue_depth_fn())
        return snap

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 1)
        return json.dumps(self.snapshot(), **kw)
