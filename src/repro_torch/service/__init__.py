"""Online JPEG decode service (see DESIGN.md §service).

The paper's protocol turned into a runtime: an async micro-batching
engine serving decode requests through the port's registered paths, with
a bandit router that learns per-path service throughput in situ and the
skip ledger promoted from accounting to a routing signal. On the card,
``cuda-batch`` serves each micro-batch with one ``decode_batch`` launch
per structure group.
"""
from repro_torch.service.admission import AdmissionController, ServiceOverloaded
from repro_torch.service.batcher import Batch, MicroBatcher, bucket_key
from repro_torch.service.cache import DecodeCache, content_key
from repro_torch.service.engine import DecodeService, ServiceConfig, ServiceShutdown
from repro_torch.service.metrics import (RollingWindow, ServiceMetrics,
                                   default_slo_objectives)
from repro_torch.service.router import BanditRouter

__all__ = [
    "AdmissionController", "ServiceOverloaded",
    "Batch", "MicroBatcher", "bucket_key",
    "DecodeCache", "content_key",
    "DecodeService", "ServiceConfig", "ServiceShutdown",
    "RollingWindow", "ServiceMetrics", "default_slo_objectives",
    "BanditRouter",
]
