"""Observability for the port: span tracing, metrics, SLOs and the
telemetry endpoints, copies of the reference's.

``repro_torch.obs.trace`` keeps the reference's span names
(``jpeg.parse``, ``jpeg.entropy``, ``jpeg.dequant_idct``,
``jpeg.assemble``, ``jpeg.transform``, ``service.batch_decode``), so
stage attribution reads the same in both packages;
``repro_torch.obs.metrics`` holds counters, gauges and histograms in a
pull-based registry with Prometheus-style text exposition;
``repro_torch.obs.slo`` tracks burn rates against declared objectives;
``repro_torch.obs.http`` serves ``/metrics``, ``/healthz`` and ``/slo``.
"""
from repro_torch.obs.http import TelemetryServer  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry)
from repro_torch.obs.slo import (DecisionLog, SLOObjective,  # noqa: F401
                                 SLOTracker)
from repro_torch.obs.trace import (NullTracer, SamplingTracer,  # noqa: F401
                                   Tracer, get_tracer, init_worker,
                                   merge_shards, set_tracer, span,
                                   stage_seconds, use_tracer,
                                   write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SLOObjective", "SLOTracker", "DecisionLog", "TelemetryServer",
    "NullTracer", "Tracer", "SamplingTracer", "get_tracer", "set_tracer",
    "use_tracer", "span", "init_worker", "merge_shards", "stage_seconds",
    "write_chrome_trace",
]
