"""Observability for the port: the span tracer, a copy of the reference's.

``repro_torch.obs.trace`` keeps the reference's span names
(``jpeg.parse``, ``jpeg.entropy``, ``jpeg.dequant_idct``,
``jpeg.assemble``, ``jpeg.transform``), so stage attribution reads the
same in both packages. Metrics, SLOs and the HTTP endpoints are not
ported yet.
"""
from repro_torch.obs.trace import (NullTracer, SamplingTracer,  # noqa: F401
                                   Tracer, get_tracer, init_worker,
                                   merge_shards, set_tracer, span,
                                   stage_seconds, use_tracer,
                                   write_chrome_trace)

__all__ = [
    "NullTracer", "Tracer", "SamplingTracer", "get_tracer", "set_tracer",
    "use_tracer", "span", "init_worker", "merge_shards", "stage_seconds",
    "write_chrome_trace",
]
