"""Multi-worker data loader: the system under evaluation.

PyTorch-DataLoader-shaped (num_workers semantics: 0 = decode inline in the
consumer; N = parallel workers) with two pool modes:

* ``thread``  — numpy and torch release the GIL around their kernels, so
  thread workers run without fork hazards. All decode paths are
  thread-eligible.
* ``process`` — the paper's fork-based harness semantics. Only decoders
  the ``repro_torch.codecs.eligible`` resolver admits for
  ``ExecContext.PROCESS_POOL`` (fork-safe, i.e. the numpy family) run
  here; torch- and CUDA-backed paths are excluded, the analogue of
  "PyVips is not loader-eligible under this forked harness".

Production features exercised by tests:
  * bounded prefetch (backpressure), ordered delivery
  * skip ledger (strict-decoder robustness accounting — paper §4.4)
  * straggler mitigation: backup dispatch after an adaptive latency budget
  * checkpointable iterator state (epoch, cursor, skips, rng) — resumes
    exactly alongside model checkpoints
  * per-host sharding hook for multi-host data parallelism

Where the port differs from the reference:

* **The device crosses threads.** A loader keeps the device that is
  selected where it is built (``repro_torch.device.selected_device``:
  ``cuda:0`` unless the caller asked for the CPU) and runs every decode
  under ``use_device(self.device)``: inline, in its worker and backup
  threads, and per chunk. A ``use_device`` scope does not reach a new
  thread by itself, so without this a loader built under
  ``use_device("cpu")`` would run its ``torch-*``/``cuda-*`` decode on
  the card from its worker threads.
* **Process mode forks a parent that may hold a CUDA context.** The
  capabilities rule admits only ``fork_safe`` (numpy-engine) decoders to
  the pool, so the children run numpy code and never touch CUDA.
* **``prefetch_to_device`` puts torch tensors on the device** where the
  reference calls ``jax.device_put``: on the card, a copy from pinned
  host memory on a side stream that the consumer's stream waits for.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import current_device, selected_device, use_device
from repro_torch.jpeg.parser import CorruptJpeg, UnsupportedJpeg
from repro_torch.obs import trace
from repro_torch.store.sampler import window_shuffle_order
from repro_torch.store.source import as_byte_source


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 16
    num_workers: int = 0
    mode: str = "thread"              # thread | process
    prefetch: int = 4                 # in-flight item budget (per worker)
    target_hw: Tuple[int, int] = (64, 64)
    drop_remainder: bool = False
    shuffle: bool = False
    seed: int = 0
    straggler_backup: bool = False    # backup-dispatch work stealing
    straggler_factor: float = 4.0     # budget = factor * running median
    shard_index: int = 0              # per-host sharding
    shard_count: int = 1
    decode_batch: int = 0             # thread mode: decode chunks of this
                                      # many files via the path's
                                      # decode_batch (0 = per-item)
    shuffle_window: int = 0           # 0 = full-permutation shuffle; >0 =
                                      # streaming window shuffle (storage-
                                      # friendly; see repro_torch.store.sampler)
    entropy_workers: int = 0          # interval-parallel entropy decode
                                      # inside each decode call; 0 =
                                      # ambient default. Resolved against
                                      # the path's capabilities and this
                                      # loader's exec context (demotions
                                      # recorded in stats(); DESIGN.md §10)


class SkipLedger:
    """Robustness accounting: which items were skipped and why."""

    def __init__(self):
        self.skips: List[Tuple[int, str]] = []
        self._lock = threading.Lock()

    def record(self, index: int, reason: str) -> None:
        with self._lock:
            self.skips.append((index, reason))

    @property
    def count(self) -> int:
        with self._lock:
            return len(self.skips)

    def indices(self) -> List[int]:
        with self._lock:
            return sorted(i for i, _ in self.skips)

    def state(self) -> list:
        with self._lock:
            return list(self.skips)

    def restore(self, state) -> None:
        with self._lock:
            self.skips = [tuple(s) for s in state]


def center_fit(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Center-crop/pad to (th, tw) — the collate transform."""
    h, w = img.shape[:2]
    y0 = max((h - th) // 2, 0)
    x0 = max((w - tw) // 2, 0)
    img = img[y0:y0 + th, x0:x0 + tw]
    ph, pw = th - img.shape[0], tw - img.shape[1]
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    return img


# process-pool plumbing: globals installed by the initializer (fork/spawn).
# Workers receive a ByteSource *handle*, not the corpus: a shard-backed
# source ships only its directory path and each worker mmaps the shards
# itself, so no corpus bytes ever cross the pool boundary.
_PROC_SOURCE = None
_PROC_DECODE: Optional[Callable] = None


def _proc_init(handle, path_name, trace_cfg=None):
    global _PROC_SOURCE, _PROC_DECODE
    from repro_torch.codecs import get_decoder
    # a tracing parent hands each worker a shard config: worker spans
    # land in per-pid trace shards the parent's export merges
    trace.init_worker(trace_cfg)
    _PROC_SOURCE = handle.open()
    _PROC_DECODE = get_decoder(path_name).fn


def _proc_work(i):
    try:
        with trace.span("loader.fetch"):
            data = _PROC_SOURCE[i]
        with trace.span("loader.decode"):
            out = i, _PROC_DECODE(data), None
    except (UnsupportedJpeg, CorruptJpeg) as e:
        out = i, None, f"{type(e).__name__}: {e}"
    # per-item flush: pool workers die by terminate(), never by a clean
    # shutdown hook, so buffered spans must not outlive the item
    trace.flush()
    return out


class DataLoader:
    """Iterable over batches: dict(image [B,H,W,3] u8, label [B] i32).

    ``files`` is either the paper's in-memory ``Sequence[bytes]`` or any
    ``repro_torch.store.ByteSource`` (e.g. a mmap-backed ``ShardSource``); a
    ByteSource carries its own labels, so pass ``labels=None`` then.
    """

    def __init__(self, files, labels: Optional[Sequence[int]] = None,
                 decode_fn: Optional[Callable[[bytes], np.ndarray]] = None,
                 cfg: Optional[LoaderConfig] = None, *,
                 path_name: Optional[str] = None,
                 batch_decode_fn: Optional[Callable] = None):
        if labels is None and not hasattr(files, "open_in_worker"):
            # a plain sequence has no labels of its own: silently
            # training on the MemorySource zero-fill would be a footgun
            raise ValueError(
                "labels are required with a plain bytes sequence; only a "
                "ByteSource (which carries its own) may omit them")
        self.source = as_byte_source(files, labels)
        self.files = self.source
        self.labels = np.asarray(self.source.labels, np.int32)
        self.cfg = cfg or LoaderConfig()
        self.device = selected_device()
        self.path_name = path_name
        self.decode_fn = decode_fn
        self.batch_decode_fn = batch_decode_fn
        if (decode_fn is None or batch_decode_fn is None) \
                and path_name is not None:
            from repro_torch.codecs import get_decoder
            spec = get_decoder(path_name)
            if self.decode_fn is None:
                self.decode_fn = spec.fn
            if self.batch_decode_fn is None:
                self.batch_decode_fn = spec.decode_batch
        if self.decode_fn is None:
            raise ValueError("DataLoader needs decode_fn or a registered "
                             "path_name")
        self._resolve_entropy()
        self.ledger = SkipLedger()
        self.epoch = 0
        self.cursor = 0
        self._latencies: List[float] = []
        self._pool = None                # process mode: reused across epochs
        self._pool_finalizer = None

    def _resolve_entropy(self) -> None:
        """Resolve the interval-parallel entropy_workers request for this
        loader's (path capabilities, exec context) pairing and pin the
        effective count around every decode call. Worker threads run in
        their own contextvars context, so the pin wraps the decode fns
        themselves rather than the submitting thread."""
        cfg = self.cfg
        requested = int(cfg.entropy_workers)
        if requested <= 0:
            self.entropy_workers, self.entropy_demotion = 0, ""
            return
        from repro_torch.codecs import (ExecContext, get_decoder,
                                        resolve_entropy_workers)
        context = (ExecContext.INLINE if cfg.num_workers == 0 else
                   ExecContext.PROCESS_POOL if cfg.mode == "process" else
                   ExecContext.THREAD_POOL)
        if self.path_name is not None:
            caps = get_decoder(self.path_name).caps
            eff, reason = resolve_entropy_workers(caps, context, requested)
        else:
            eff, reason = 1, ("unregistered decode_fn does not advertise "
                              "parallel_entropy; demoted to serial")
        self.entropy_workers, self.entropy_demotion = eff, reason
        if eff > 0:
            from repro_torch.jpeg import huffman

            def _pin(fn):
                def wrapped(*a, **kw):
                    with huffman.entropy_workers(eff):
                        return fn(*a, **kw)
                return wrapped
            self.decode_fn = _pin(self.decode_fn)
            if self.batch_decode_fn is not None:
                self.batch_decode_fn = _pin(self.batch_decode_fn)

    # ------------------------------------------------------------ state
    def stats(self) -> Dict[str, Any]:
        """Operational snapshot for bench records: per-item decode latency
        percentiles (whatever the worker saw, including queueing inside a
        chunk) plus skip accounting."""
        # deferred import: core.protocols imports this module, so a
        # module-level repro_torch.core import would be circular
        from repro_torch.core.stats import percentile
        lat = list(self._latencies)
        out = {"latency_p50_s": percentile(lat, 0.50),
               "latency_p99_s": percentile(lat, 0.99),
               "measured_items": len(lat), "skips": self.ledger.count}
        if self.cfg.entropy_workers > 0:
            out["entropy_workers"] = self.entropy_workers
            if self.entropy_demotion:
                out["entropy_demotion"] = self.entropy_demotion
        return out

    def state(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "cursor": self.cursor,
                "skips": self.ledger.state(),
                "seed": self.cfg.seed}

    def restore(self, state: Dict[str, Any]) -> None:
        self.epoch = state["epoch"]
        self.cursor = state["cursor"]
        self.ledger.restore(state["skips"])

    # ------------------------------------------------------------ order
    def _epoch_order(self) -> np.ndarray:
        # the permutation is a pure function of (seed, epoch): a restored
        # loader regenerates the interrupted epoch's exact order and
        # resumes at the cursor, instead of re-drawing from a mutable RNG
        # (which replayed/dropped items when resuming a shuffled epoch).
        # shuffle_window > 0 swaps the full permutation for the streaming
        # window shuffle (same purity contract, storage-friendly locality)
        idx = np.arange(len(self.files))
        idx = idx[self.cfg.shard_index::self.cfg.shard_count]
        if self.cfg.shuffle:
            if self.cfg.shuffle_window > 0:
                idx = idx[window_shuffle_order(
                    len(idx), self.cfg.seed, self.epoch,
                    self.cfg.shuffle_window)]
            else:
                np.random.RandomState(
                    [self.cfg.seed, self.epoch]).shuffle(idx)
        return idx

    # ------------------------------------------------------------ decode
    def _decode_one(self, i: int):
        try:
            with trace.span("loader.fetch"):
                data = self.files[i]
            with trace.span("loader.decode"), use_device(self.device):
                return self.decode_fn(data)
        except (UnsupportedJpeg, CorruptJpeg) as e:
            self.ledger.record(i, f"{type(e).__name__}: {e}")
            return None

    def _decode_quiet(self, i: int):
        """Decode without touching the ledger: (img, err). The thread
        iterator records skips at emission time, so a straggler primary
        racing its backup dispatch cannot double-record one index."""
        try:
            with trace.span("loader.fetch"):
                data = self.files[i]
            with trace.span("loader.decode"), use_device(self.device):
                return self.decode_fn(data), None
        except (UnsupportedJpeg, CorruptJpeg) as e:
            return None, f"{type(e).__name__}: {e}"

    def _iter_decoded_sync(self, order):
        # yields (index, img-or-None): skips surface as None so the
        # consumer can advance the checkpoint cursor past them
        for i in order:
            yield int(i), self._decode_one(int(i))

    def _iter_decoded_threads(self, order):
        cfg = self.cfg
        ex = ThreadPoolExecutor(max_workers=cfg.num_workers)
        backup_ex = (ThreadPoolExecutor(max_workers=max(2, cfg.num_workers))
                     if cfg.straggler_backup else None)
        inflight = cfg.num_workers * cfg.prefetch
        try:
            pending: Dict[int, Any] = {}
            submit_t: Dict[int, float] = {}
            order = [int(i) for i in order]
            pos = 0
            emit = 0
            while emit < len(order):
                while pos < len(order) and len(pending) < inflight:
                    i = order[pos]
                    pending[pos] = ex.submit(self._decode_quiet, i)
                    submit_t[pos] = time.monotonic()
                    pos += 1
                fut = pending[emit]
                if cfg.straggler_backup and not fut.done():
                    med = (np.median(self._latencies)
                           if len(self._latencies) >= 8 else None)
                    budget = (cfg.straggler_factor * med) if med else None
                    if budget is not None:
                        waited = time.monotonic() - submit_t[emit]
                        try:
                            with trace.span("loader.queue_wait"):
                                img, err = fut.result(
                                    timeout=max(budget - waited, 1e-3))
                        except FutureTimeout:
                            # backup dispatch: race a second attempt
                            trace.instant("loader.backup_dispatch",
                                          index=order[emit])
                            with trace.span("loader.backup_wait"):
                                b = backup_ex.submit(
                                    self._decode_quiet, order[emit])
                                img, err = b.result()
                            fut.cancel()
                        yield from self._emit_one(order[emit], img, err,
                                                  submit_t.pop(emit))
                        del pending[emit]
                        emit += 1
                        continue
                with trace.span("loader.queue_wait"):
                    img, err = fut.result()
                yield from self._emit_one(order[emit], img, err,
                                          submit_t.pop(emit))
                del pending[emit]
                emit += 1
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
            if backup_ex:
                backup_ex.shutdown(wait=False, cancel_futures=True)

    def _emit_one(self, i: int, img, err, t0: float):
        self._note(t0)
        if err is not None:
            self.ledger.record(i, err)
            yield i, None
        else:
            yield i, img

    def _note(self, t0: float) -> None:
        self._latencies.append(time.monotonic() - t0)
        if len(self._latencies) > 512:
            del self._latencies[:256]

    def _iter_decoded_thread_batches(self, order):
        """Chunked thread decode: each worker takes a whole chunk through
        ``decode_batch`` — on batched paths (jnp-batch/pallas-batch and
        the fused jnp/pallas arms) the post-entropy transform runs as ONE
        launch per same-structure group instead of per image. Emission
        stays ordered and per-item; skips surface exactly as in the
        per-item iterator."""
        cfg = self.cfg
        fn = self.batch_decode_fn
        if fn is None:                  # no path: serial loop per chunk
            def fn(datas):
                out = []
                for d in datas:
                    try:
                        out.append(self.decode_fn(d))
                    except Exception as e:
                        out.append(e)
                return out
        order = [int(i) for i in order]
        size = cfg.decode_batch
        chunks = [order[k:k + size] for k in range(0, len(order), size)]
        ex = ThreadPoolExecutor(max_workers=cfg.num_workers)
        inflight = max(1, cfg.num_workers) * max(1, cfg.prefetch)

        def work(idxs):
            t0 = time.monotonic()
            with trace.span("loader.fetch"):
                datas = [self.files[i] for i in idxs]
            with trace.span("loader.decode", chunk=len(idxs)), \
                    use_device(self.device):
                return fn(datas), t0

        try:
            pending: Dict[int, Any] = {}
            pos = 0
            emit = 0
            while emit < len(chunks):
                while pos < len(chunks) and len(pending) < inflight:
                    pending[pos] = ex.submit(work, chunks[pos])
                    pos += 1
                with trace.span("loader.queue_wait"):
                    results, t0 = pending.pop(emit).result()
                self._note(t0)
                for i, res in zip(chunks[emit], results):
                    if isinstance(res, (UnsupportedJpeg, CorruptJpeg)):
                        self.ledger.record(i, f"{type(res).__name__}: {res}")
                        yield i, None
                    elif isinstance(res, BaseException):
                        raise res
                    else:
                        yield i, res
                emit += 1
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _proc_initargs(self) -> tuple:
        """What crosses the pool boundary: a ByteSource worker handle and
        the decode-path name — never the corpus. A shard-backed handle is
        a directory path (picklable in ~100 bytes however large the
        corpus); workers reopen the shards with their own mmaps."""
        return (self.source.open_in_worker(), self.path_name,
                trace.get_tracer().worker_config())

    def _ensure_pool(self):
        """The fork pool, created once and reused across epochs (it used
        to be rebuilt — and the whole corpus re-materialized into
        initargs via ``list(self.files)`` — per epoch)."""
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.cfg.num_workers,
                                  initializer=_proc_init,
                                  initargs=self._proc_initargs())
            # reclaim worker processes when the loader is dropped without
            # an explicit close() (runs at GC or interpreter exit)
            self._pool_finalizer = weakref.finalize(
                self, self._pool.terminate)
        return self._pool

    def close(self) -> None:
        """Release the process pool (no-op for thread/inline modes)."""
        if self._pool is not None:
            self._pool_finalizer.detach()
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _iter_decoded_procs(self, order):
        assert self.path_name is not None, \
            "process mode needs a registered path name"
        from repro_torch.codecs import ExecContext, eligible, get_decoder
        verdict = eligible(get_decoder(self.path_name).caps,
                           ExecContext.PROCESS_POOL)
        if not verdict:
            raise RuntimeError(
                f"decode path {self.path_name!r} is "
                f"{verdict.reason}")
        pool = self._ensure_pool()
        results = iter(pool.imap(
            _proc_work, [int(i) for i in order],
            chunksize=max(1, self.cfg.prefetch)))
        while True:
            # the consumer-side stall on the pool is the queue-wait the
            # single-thread protocol never sees
            with trace.span("loader.queue_wait"):
                item = next(results, None)
            if item is None:
                return
            i, img, err = item
            if err is not None:
                self.ledger.record(i, err)
                yield i, None
            else:
                yield i, img

    # ------------------------------------------------------------ iterate
    def __iter__(self):
        cfg = self.cfg
        order = self._epoch_order()[self.cursor:]
        if cfg.num_workers == 0:
            decoded = self._iter_decoded_sync(order)
        elif cfg.mode == "thread":
            if cfg.decode_batch > 0:
                if cfg.straggler_backup:
                    raise ValueError(
                        "decode_batch chunking and straggler_backup are "
                        "mutually exclusive: chunked mode has no per-item "
                        "backup dispatch")
                decoded = self._iter_decoded_thread_batches(order)
            else:
                decoded = self._iter_decoded_threads(order)
        elif cfg.mode == "process":
            decoded = self._iter_decoded_procs(order)
        else:
            raise ValueError(cfg.mode)

        th, tw = cfg.target_hw
        imgs, labs = [], []
        for i, img in decoded:
            # the cursor counts consumed epoch positions, including skips —
            # otherwise restoring after a skip replays/shifts the epoch order
            self.cursor += 1
            if img is None:
                continue
            imgs.append(center_fit(img, th, tw))
            labs.append(self.labels[i])
            if len(imgs) == cfg.batch_size:
                with trace.span("loader.collate", batch=len(imgs)):
                    batch = {"image": np.stack(imgs),
                             "label": np.asarray(labs, np.int32)}
                yield batch
                imgs, labs = [], []
        if imgs and not cfg.drop_remainder:
            with trace.span("loader.collate", batch=len(imgs)):
                batch = {"image": np.stack(imgs),
                         "label": np.asarray(labs, np.int32)}
            yield batch
        self.epoch += 1
        self.cursor = 0


def prefetch_to_device(iterator, size: int = 2):
    """Host->device double buffering (overlaps H2D copy with compute).

    Each item is a dict of host arrays (a loader batch); it arrives as a
    dict of torch tensors on ``current_device()``, read here in the
    caller's thread (raises without a card unless the CPU was asked for)
    and re-entered in the producer thread, so the iterator's own torch
    calls run there too. On the card the producer copies from pinned
    host memory with ``non_blocking=True`` on a side stream and records
    an event; the consumer's stream waits for that event before the
    item is handed over, and each tensor is recorded on the consumer's
    stream so that the caching allocator cannot reuse its memory while
    work queued there still reads it. The pinned sources live until
    their copy's event has completed. On the CPU, ``torch.from_numpy``.

    Producer failures propagate: the sentinel is enqueued in a ``finally``
    (so the consumer can never block forever on a dead producer) and any
    producer exception is re-raised in the consumer thread. Abandoning the
    generator early (break / close) stops the producer too, instead of
    leaving it blocked forever on a full queue pinning device buffers.
    """
    return _prefetch(iterator, size, current_device())


def _host_tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(value))


def _prefetch(iterator, size: int, dev: torch.device):
    buf = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    error: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # (event, pinned sources) of copies that may still be running
        inflight: List[Tuple[Any, List[torch.Tensor]]] = []
        try:
            with use_device(dev):
                side = (torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None)
                for item in iterator:
                    if side is None:
                        moved = ({k: _host_tensor(v)
                                  for k, v in item.items()}, None)
                    else:
                        inflight = [(e, p) for e, p in inflight
                                    if not e.query()]
                        pinned = {k: _host_tensor(v).pin_memory()
                                  for k, v in item.items()}
                        with torch.cuda.stream(side):
                            out = {k: t.to(dev, non_blocking=True)
                                   for k, t in pinned.items()}
                            event = torch.cuda.Event()
                            event.record(side)
                        inflight.append((event, list(pinned.values())))
                        moved = (out, event)
                    if not _put(moved):
                        return           # consumer abandoned the generator
        except BaseException as e:
            error.append(e)
        finally:
            for event, _ in inflight:
                # the exit drain: pinned sources must outlive their
                # copies; once a pass, over at most the prefetch depth
                # repro: ignore[torch-host-sync-in-loop] -- exit drain
                event.synchronize()
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True,
                         name="prefetch-producer")
    t.start()
    try:
        while True:
            item = buf.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            out, event = item
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for tensor in out.values():
                    tensor.record_stream(stream)
            yield out
    finally:
        stop.set()                       # unblocks a producer mid-put
