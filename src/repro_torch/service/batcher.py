"""Shape-bucketed micro-batching with a bounded max-wait deadline.

Why shape bucketing: the jitted decode paths (``jnp-fused``/``jnp-batched``
and the Pallas kernels) compile per coefficient-grid shape. Random request
interleaving across a mixed-resolution corpus thrashes the compile cache;
grouping requests whose *padded MCU grid* matches means consecutive
decodes hit a warm cache entry (the paper's jnp-batched path is exactly
"fused + reused compilation cache (bucketed shapes)" — here the bucketing
moves from offline corpus order into the online request stream).

Why a deadline: batching trades latency for throughput. Every bucket
carries the enqueue time of its *oldest* member; once that exceeds
``max_wait_s`` the bucket is flushed regardless of fill, so tail latency
is bounded by ``max_wait_s`` + one service time.

The batcher is a passive, lock-protected structure — the engine's batcher
thread drives it with ``add`` / ``take_due`` / ``next_deadline`` — which
keeps it deterministic and directly unit-testable.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.codecs import BucketKey, probe_key

__all__ = ["Batch", "BucketKey", "MicroBatcher", "bucket_key"]


def bucket_key(data: bytes, granularity: int = 4) -> BucketKey:
    """Bucket identity of one JPEG: padded MCU grid + sampling structure.

    Delegates to ``repro_torch.codecs.probe_key`` — the headers-only probe the
    ``Capabilities.headers_only_probe`` flag declares (``headers_only=True``
    parsing stops at SOS): admission runs on the batcher thread, and the
    O(file-size) entropy-stream scan it would otherwise pay per request
    belongs to the decode workers. The MCU grid (not pixel dims) is what
    determines coefficient-array shapes and therefore compile-cache
    identity; grid dims round up to ``granularity`` MCUs so near-identical
    resolutions share a bucket.
    """
    return probe_key(data, granularity)


@dataclasses.dataclass
class Batch:
    key: Optional[BucketKey]
    items: List[object]
    oldest_t: float


class MicroBatcher:
    """Groups (key, item) pairs into per-bucket pending lists."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.01):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._pending: Dict[BucketKey, List] = {}
        self._oldest: Dict[BucketKey, float] = {}
        self.batches_emitted = 0
        self.deadline_flushes = 0

    def depth(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def add(self, key: BucketKey, item, now: float) -> Optional[Batch]:
        """Queue an item; returns a full batch if the bucket filled."""
        with self._lock:
            bucket = self._pending.setdefault(key, [])
            if not bucket:
                self._oldest[key] = now
            bucket.append(item)
            if len(bucket) >= self.max_batch:
                return self._pop_locked(key)
            return None

    def _pop_locked(self, key: BucketKey) -> Batch:
        items = self._pending.pop(key)
        oldest = self._oldest.pop(key)
        self.batches_emitted += 1
        return Batch(key=key, items=items, oldest_t=oldest)

    def take_due(self, now: float) -> List[Batch]:
        """Flush every bucket whose oldest member exceeded max_wait_s."""
        out = []
        with self._lock:
            for key in [k for k, t in self._oldest.items()
                        if now - t >= self.max_wait_s]:
                out.append(self._pop_locked(key))
                self.deadline_flushes += 1
        return out

    def flush_all(self) -> List[Batch]:
        with self._lock:
            return [self._pop_locked(k) for k in list(self._pending)]

    def next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the earliest bucket must flush (None if empty)."""
        with self._lock:
            if not self._oldest:
                return None
            t = min(self._oldest.values())
        return max(0.0, self.max_wait_s - (now - t))
