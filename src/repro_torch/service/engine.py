"""The online decode service: request queue, worker pool, bounded
in-flight budget, backpressure, and graceful shutdown.

Dataflow (all hand-offs through bounded queues, so overload surfaces as
explicit shedding at admission — never as unbounded memory or deadlock):

    client --submit()--> [admission] --> inbound q --> batcher thread
        --> shape-bucketed micro-batches --> batch q --> worker pool
        --> router-picked decode path --> future.set_result

* ``submit`` returns a ``concurrent.futures.Future`` immediately; the
  decode result cache is consulted first (hits resolve synchronously),
  then the admission controller either reserves an in-flight slot or
  raises ``ServiceOverloaded``.
* The batcher thread groups requests by padded-MCU-grid bucket (admission
  parses headers only — the entropy scan belongs to decode workers) and
  flushes on fill or deadline.
* Each worker serves a micro-batch with ONE ``decode_batch`` call on a
  ``repro_torch.codecs`` decoder *session* for the router-picked arm (opened in
  ``ExecContext.SERVICE``) — batched paths run the post-entropy transform
  as a real ``[B, ...]`` launch, others loop serially. The session returns
  typed ``DecodeOutcome``s: ``skip`` outcomes (strict-path refusals) are
  recorded against the arm and retried on the router's non-strict
  fallback — the skip ledger becomes a routing signal and clients still
  get pixels for rare JPEG modes — while ``error`` outcomes fail only
  their own future. Whole-batch throughput feeds back to the router.
* ``num_workers=0`` decodes inline in the caller thread (the service
  analogue of the loader's ``num_workers=0`` protocol arm).

Where the port differs from the reference:

* **The device crosses threads.** The service keeps the device that is
  selected where it is built (``repro_torch.device.selected_device``:
  ``cuda:0`` unless the caller asked for the CPU) and runs its batcher
  and workers, and inline and fallback decodes, under
  ``use_device(self.device)``. A ``use_device`` scope does not reach a
  new thread by itself, so without this a service built under
  ``use_device("cpu")`` would run its ``torch-*``/``cuda-*`` arms on the
  card from its worker threads.
* **The router's wall time covers the card's work.** Every arm returns
  host uint8 arrays, so its kernels have finished (a ``cuda-batch``
  group ends in a device-to-host copy) when ``decode_batch`` returns.
  Workers launch on the legacy default stream, so several workers'
  kernels run one after another on the card.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.codecs import (DecodeOutcome, Decoder, ExecContext,
                                open_decoder, probe_outcome)
from repro_torch.device import selected_device, use_device
from repro_torch.jpeg.parser import UnsupportedJpeg
from repro_torch.obs import trace
from repro_torch.obs.http import TelemetryServer
from repro_torch.obs.slo import DEFAULT_WINDOWS_S, DecisionLog, SLOTracker
from repro_torch.service.admission import AdmissionController, ServiceOverloaded
from repro_torch.service.batcher import Batch, MicroBatcher
from repro_torch.service.cache import DecodeCache, content_key
from repro_torch.service.metrics import ServiceMetrics, default_slo_objectives
from repro_torch.service.router import BanditRouter


class ServiceShutdown(RuntimeError):
    """Raised into futures that cannot be served because the service
    stopped (non-graceful) or to submitters after close."""


@dataclasses.dataclass
class ServiceConfig:
    num_workers: int = 2            # 0 = decode inline in the caller
    max_inflight: int = 64          # admission budget (backpressure bound)
    max_batch: int = 8              # micro-batch fill target
    max_wait_ms: float = 5.0        # micro-batch deadline
    bucket_granularity: int = 4     # MCU-grid rounding for bucket identity
    cache_bytes: int = 32 << 20     # decode result cache budget; 0 = off
    policy: str = "ucb"             # router policy: ucb | epsilon
    epsilon: float = 0.1
    seed: int = 0
    congestion: float = 0.75        # fairness kicks in past this fill
    entropy_workers: int = 0        # interval-parallel entropy decode per
                                    # arm session; 0 = ambient default
                                    # (resolved per caps, DESIGN.md §10)
    # --- telemetry (DESIGN.md §12) ---
    slo_objectives: Optional[Sequence] = None   # SLOObjective list; None
                                    # = stock latency+availability pair
    slo_latency_target_s: float = 0.25  # stock pair's latency threshold
    slo_windows_s: Sequence[float] = DEFAULT_WINDOWS_S
    slo_shed_burn: float = 0.0      # >0: shed while every window burns
                                    # at >= this rate; 0 = observe only
    slo_sample_interval_s: float = 1.0
    metrics_port: Optional[int] = None  # None = no HTTP endpoint;
                                    # 0 = bind an ephemeral port
    metrics_host: str = "127.0.0.1"
    trace_sample_rate: float = 0.0  # >0: install a head-sampled ambient
                                    # tracer for the service's lifetime
                                    # (1.0 = trace every request)


@dataclasses.dataclass
class _Request:
    data: bytes
    client: str
    future: Future
    t_submit: float
    cache_key: Optional[bytes] = None


_STOP = object()


class DecodeService:
    """Async batched JPEG decode service over the registered paths."""

    def __init__(self, cfg: Optional[ServiceConfig] = None, *,
                 paths: Optional[Sequence] = None,
                 router: Optional[BanditRouter] = None):
        self.cfg = cfg or ServiceConfig()
        self.device = selected_device()
        self.router = router or BanditRouter(
            paths, policy=self.cfg.policy, epsilon=self.cfg.epsilon,
            seed=self.cfg.seed)
        self.cache = (DecodeCache(self.cfg.cache_bytes)
                      if self.cfg.cache_bytes > 0 else None)
        self.metrics = ServiceMetrics(queue_depth_fn=self._queue_depth)
        objectives = (list(self.cfg.slo_objectives)
                      if self.cfg.slo_objectives is not None
                      else default_slo_objectives(
                          latency_target_s=self.cfg.slo_latency_target_s))
        self.slo = SLOTracker(
            self.metrics.registry, objectives,
            windows_s=self.cfg.slo_windows_s,
            shed_burn=self.cfg.slo_shed_burn or None,
            min_sample_interval_s=self.cfg.slo_sample_interval_s)
        self.audit = DecisionLog()
        self.admission = AdmissionController(
            self.cfg.max_inflight, congestion=self.cfg.congestion,
            slo=self.slo, log=self.audit)
        self.telemetry: Optional[TelemetryServer] = None
        self.batcher = MicroBatcher(self.cfg.max_batch,
                                    self.cfg.max_wait_ms / 1e3)
        self._inbound: "queue.Queue" = queue.Queue()
        self._batchq: "queue.Queue" = queue.Queue(
            maxsize=max(2, 2 * max(1, self.cfg.num_workers)))
        self._threads: List[threading.Thread] = []
        # decoder sessions, one per router arm, opened lazily in the
        # SERVICE context (the outcome-typed front door to each path)
        self._sessions: Dict[str, Decoder] = {}
        self._submit_lock = threading.Lock()
        self._sampling_tracer: Optional[trace.SamplingTracer] = None
        self._started = False
        self._closed = False
        self._abort = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecodeService":
        if self._started:
            return self
        self._started = True
        if (self.cfg.trace_sample_rate > 0
                and not trace.get_tracer().enabled):
            # always-on head-sampled tracing for the service's lifetime;
            # an explicitly installed tracer (bench --trace) wins
            self._sampling_tracer = trace.SamplingTracer(
                rate=self.cfg.trace_sample_rate)
            trace.set_tracer(self._sampling_tracer)
        if self.cfg.metrics_port is not None:
            self.telemetry = TelemetryServer(
                self.metrics.registry, slo=self.slo,
                health_fn=self._health, host=self.cfg.metrics_host,
                port=self.cfg.metrics_port,
                sample_interval_s=self.cfg.slo_sample_interval_s)
            self.telemetry.start()
        if self.cfg.num_workers > 0:
            t = threading.Thread(target=self._on_device,
                                 args=(self._batcher_loop,),
                                 name="svc-batcher", daemon=True)
            t.start()
            self._threads.append(t)
            for k in range(self.cfg.num_workers):
                t = threading.Thread(target=self._on_device,
                                     args=(self._worker_loop,),
                                     name=f"svc-worker-{k}", daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def stop(self, graceful: bool = True) -> None:
        with self._submit_lock:
            was_active = self._started and not self._closed
            self._closed = True
            if was_active:
                if not graceful:
                    self._abort = True
                if self.cfg.num_workers > 0:
                    self._inbound.put(_STOP)
        if not was_active:
            return
        if self.cfg.num_workers > 0:
            self._threads[0].join()               # batcher drains + flushes
            for _ in range(self.cfg.num_workers):
                self._batchq.put(_STOP)
            for t in self._threads[1:]:
                t.join()
            # close sessions only once the worker pool is quiesced. In
            # inline mode (num_workers=0) a submitter may legitimately be
            # mid-_serve_batch in its own thread when stop() runs, and
            # closing under it would fail an accepted request with a
            # session-lifecycle error — inline sessions just get GC'd.
            for sess in list(self._sessions.values()):
                sess.close()
        if self.telemetry is not None:
            self.telemetry.stop()
        if (self._sampling_tracer is not None
                and trace.get_tracer() is self._sampling_tracer):
            trace.set_tracer(None)

    def __enter__(self) -> "DecodeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(graceful=not any(exc))

    # ------------------------------------------------------------ submit
    def submit(self, data, client: str = "anon") -> Future:
        """Enqueue one decode; returns a Future of RGB uint8 [H, W, 3].

        ``data`` is any bytes-like buffer (``bytes`` or a zero-copy
        ``memoryview``): admission hashing, header probing, and decode
        all read the buffer in place.

        Raises ServiceOverloaded when shed at admission, ServiceShutdown
        after close. Never blocks the caller on service-side queues.
        """
        if self._closed or not self._started:
            raise ServiceShutdown("service is not accepting requests")
        self.metrics.record_request()
        fut: Future = Future()
        key = None
        if self.cache is not None:
            key = content_key(data)
            img = self.cache.get(key)
            if img is not None:
                self.metrics.record_cache_hit()
                trace.instant("service.cache_hit", client=client)
                fut.set_result(img)
                return fut
        with trace.span("service.admission", client=client) as sp:
            ok, reason = self.admission.try_admit(client)
            sp.set(admitted=ok)
        if not ok:
            self.metrics.record_shed()
            raise ServiceOverloaded(reason)
        req = _Request(data, client, fut, time.monotonic(), key)
        if self.cfg.num_workers == 0:
            self._on_device(self._serve_batch, Batch(
                key=None, items=[req], oldest_t=req.t_submit))
        else:
            # re-check closed under the same lock stop() uses to enqueue
            # _STOP, so no request can ever land behind the sentinel
            # (where the exited batcher would never see it)
            with self._submit_lock:
                if self._closed:
                    self.admission.release(client)
                    raise ServiceShutdown(
                        "service is not accepting requests")
                self._inbound.put(req)
        return fut

    def decode(self, data, client: str = "anon") -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        return self.submit(data, client).result()

    def submit_source(self, source, index: int,
                      client: str = "anon") -> Future:
        """Submit record ``index`` of a ``repro_torch.store.ByteSource``.

        For shard-backed sources the record travels as a ``memoryview``
        into the source's mmap — storage to decode worker without a
        single intermediate copy (the destuffing inside entropy decode
        is the first and only materialization).
        """
        return self.submit(source[index], client)

    def _on_device(self, fn, *args) -> None:
        """Run ``fn`` under the service's device (thread targets and the
        inline path: a caller's ``use_device`` scope ends at its thread)."""
        with use_device(self.device):
            fn(*args)

    # ------------------------------------------------------------ batcher
    def _batcher_loop(self) -> None:
        gran = self.cfg.bucket_granularity
        while True:
            timeout = self.batcher.next_deadline(time.monotonic())
            try:
                item = self._inbound.get(timeout=timeout)
            except queue.Empty:
                item = None
            if item is _STOP:
                for b in self.batcher.flush_all():
                    self._batchq.put(b)
                return
            if item is not None:
                try:
                    pr = probe_outcome(item.data, gran)
                except Exception as e:       # CorruptJpeg, truncated headers
                    self._fail(item, e)
                    continue
                if pr.skip:
                    # refusable input (unsupported frame family): hand it
                    # to a worker as a single-item keyless batch instead
                    # of failing here — _serve_batch's skip machinery
                    # records the refusal against the picked arm and
                    # retries the router's fallback, so probe refusals
                    # share one accounting path with decode-time refusals
                    self._batchq.put(Batch(key=None, items=[item],
                                           oldest_t=time.monotonic()))
                    continue
                full = self.batcher.add(pr.key, item, time.monotonic())
                if full is not None:
                    self._batchq.put(full)
            for b in self.batcher.take_due(time.monotonic()):
                self._batchq.put(b)

    # ------------------------------------------------------------ workers
    def _worker_loop(self) -> None:
        while True:
            batch = self._batchq.get()
            if batch is _STOP:
                return
            self._serve_batch(batch)

    def _session(self, arm) -> Decoder:
        """Session for a router arm, opened once in the SERVICE context.
        A benign create-race between workers just overwrites with an
        equivalent session."""
        sess = self._sessions.get(arm.name)
        if sess is None:
            sess = open_decoder(arm, context=ExecContext.SERVICE,
                                entropy_workers=self.cfg.entropy_workers)
            self._sessions[arm.name] = sess
        return sess

    def _serve_batch(self, batch: Batch) -> None:
        if self._abort:
            for req in batch.items:
                self._fail(req, ServiceShutdown("aborted"))
            return
        sess = self._session(self.router.pick())
        tracer = trace.get_tracer()
        if tracer.enabled:
            # batcher-queue depth over time: the Perfetto counter track
            # that shows queueing building up under overload
            tracer.counter("service.queue_depth", self._queue_depth())
        # ONE decode_batch call per micro-batch: same-bucket requests run
        # the post-entropy transform as a real [B, ...] batch on paths
        # that support it (serial-loop fallback otherwise). Per-item
        # skip/error outcomes come back in-place, so batch-mates are
        # unaffected and strict refusals still reroute individually.
        t0 = time.perf_counter()
        with trace.span("service.batch_decode", path=sess.name,
                        batch=len(batch.items),
                        queued_s=round(time.monotonic() - batch.oldest_t,
                                       6)):
            try:
                outcomes = sess.decode_batch(
                    [req.data for req in batch.items])
                if len(outcomes) != len(batch.items):
                    raise RuntimeError(
                        f"{sess.name}.decode_batch returned "
                        f"{len(outcomes)} results for "
                        f"{len(batch.items)} items")
            except Exception as e:
                # batch-level failures fail the futures, never the worker
                for req in batch.items:
                    self._fail(req, e)
                return
        served_s = time.perf_counter() - t0
        refused: List[_Request] = []
        n_ok = 0
        for req, out in zip(batch.items, outcomes):
            if out.kind == DecodeOutcome.SKIP:
                self.router.record_skip(sess.name)
                self.metrics.record_skip(sess.name)
                refused.append(req)
            elif out.kind == DecodeOutcome.ERROR:
                self._fail(req, out.error)
            else:
                n_ok += 1
                self._fulfil(req, out.image, sess.name)
        if n_ok and served_s > 0:
            # batch-level throughput accounting: the router learns from
            # whole-batch wall time, which is what batching improves
            self.router.update(sess.name, n_ok, served_s)
        for req in refused:
            self._serve_fallback(req, sess.name)

    def _serve_fallback(self, req: _Request, failed_name: str) -> None:
        fb = self.router.fallback(failed_name)
        if fb is None:
            self._fail(req, UnsupportedJpeg(
                f"{failed_name} refused input and no non-strict "
                "fallback path is registered"))
            return
        sess = self._session(fb)
        t0 = time.perf_counter()
        try:
            with trace.span("service.fallback_decode", path=sess.name):
                out = sess.decode(req.data)
        except Exception as e:
            self._fail(req, e)
            return
        if not out.ok:
            self._fail(req, out.error)
            return
        self.router.update(sess.name, 1, time.perf_counter() - t0)
        self._fulfil(req, out.image, sess.name)

    # ------------------------------------------------------------ plumbing
    def _fulfil(self, req: _Request, img: np.ndarray, path_name: str) -> None:
        if self.cache is not None and req.cache_key is not None:
            self.cache.put(req.cache_key, img)
        self.metrics.record_completion(path_name,
                                       time.monotonic() - req.t_submit)
        self.admission.release(req.client)
        try:
            req.future.set_result(img)
        except InvalidStateError:        # client cancelled concurrently
            pass

    def _fail(self, req: _Request, exc: BaseException) -> None:
        self.metrics.record_failure()
        self.admission.release(req.client)
        try:
            req.future.set_exception(exc)
        except InvalidStateError:        # client cancelled concurrently
            pass

    def _queue_depth(self) -> int:
        return (self._inbound.qsize() + self.batcher.depth()
                + self._batchq.qsize() * self.cfg.max_batch)

    def _health(self) -> Dict[str, object]:
        """Liveness payload for the telemetry ``/healthz`` endpoint."""
        return {
            "status": "ok" if self._started and not self._closed
            else "stopped",
            "inflight": self.admission.inflight,
            "queue_depth": self._queue_depth(),
            "workers": self.cfg.num_workers,
        }

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        return {
            "service": self.metrics.snapshot(),
            "admission": self.admission.stats(),
            "cache": self.cache.stats() if self.cache else None,
            "router": self.router.snapshot(),
            "router_best": self.router.best(),
            "batcher": {"emitted": self.batcher.batches_emitted,
                        "deadline_flushes": self.batcher.deadline_flushes},
            "slo": self.slo.status(),
            "audit": {"decisions": self.audit.counts(),
                      "recent_sheds": self.audit.entries("shed", limit=5)},
        }
