"""Low-overhead span tracing with Chrome trace-event export.

The paper's headline effect — deployment context reordering decoder
rankings — is only *explainable* when wall time is attributed to stages:
parse vs entropy vs transform vs queue-wait vs collate. This module is
the attribution substrate: a ``Tracer`` records complete-spans into a
thread-safe ring buffer with monotonic timestamps and (pid, tid)
identity, and exports Chrome trace-event JSON that Perfetto / chrome
about:tracing load directly.

Design rules:

* **Off by default, ~free when off.** The ambient tracer is a
  ``NullTracer`` whose ``span()`` returns one shared no-op context
  manager — no allocation, no clock read. Instrumentation stays in the
  hot paths permanently; only an explicitly installed ``Tracer`` pays.
* **Cross-process by shard files.** Pool workers cannot share a ring
  buffer. A ``Tracer`` built with ``shard_dir`` appends its events as
  JSON-lines to a per-pid shard file; the parent's ``export()`` merges
  its own buffer with every shard, so loader-worker timelines line up
  against the main process. ``time.monotonic`` (CLOCK_MONOTONIC) is
  system-wide on Linux, so timestamps from different pids share one
  axis.
* **Ambient, not threaded-through.** ``use_tracer()`` installs a tracer
  process-globally; every instrumented seam (jpeg, loader, service,
  store) reads the ambient tracer via module functions. Worker threads
  inherit it naturally; worker *processes* receive a
  ``worker_config()`` through pool initargs and rebuild a shard-writing
  tracer on their side.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = [
    "NullTracer", "Tracer", "SamplingTracer", "get_tracer", "set_tracer",
    "use_tracer", "span", "instant", "counter", "complete", "flush",
    "init_worker", "merge_shards", "write_chrome_trace", "stage_seconds",
]


# ------------------------------------------------------------------ null
class _NullSpan:
    """Shared no-op span: the entire cost of tracing while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default ambient tracer. All record calls are
    constant-time no-ops; ``span()`` returns one shared object."""

    enabled = False

    def span(self, name: str, cat: str = "",
             args: Optional[dict] = None) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    def complete(self, name: str, t0: float, dur: float, cat: str = "",
                 args: Optional[dict] = None) -> None:
        pass

    def events(self) -> List[dict]:
        return []

    def flush(self) -> None:
        pass

    def collect(self) -> List[dict]:
        return []

    def worker_config(self) -> Optional[dict]:
        return None


NULL = NullTracer()


# ------------------------------------------------------------------ spans
class _Span:
    """One live complete-span ('X' phase): clock read on enter, event
    emission on exit. ``set(**args)`` attaches arguments before close."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def set(self, **args) -> "_Span":
        if self._args is None:
            self._args = args
        else:
            self._args.update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tracer._emit(self._name, self._cat, "X", t0,
                           time.monotonic() - t0, self._args)
        return False


class Tracer:
    """Span recorder over a bounded thread-safe ring buffer.

    ``maxlen`` bounds memory (oldest events drop first). ``shard_dir``
    enables cross-process collection: ``flush()`` appends buffered
    events to ``<shard_dir>/trace-<pid>.jsonl`` and clears the buffer;
    with ``autoflush=N`` a flush triggers automatically once N events
    are pending (how pool workers survive ``Pool.terminate``).
    """

    enabled = True

    def __init__(self, *, maxlen: int = 1 << 16,
                 shard_dir: Optional[str] = None, autoflush: int = 0):
        self._buf: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._named_tids: set = set()
        self.shard_dir = shard_dir
        self.autoflush = int(autoflush)
        if shard_dir:
            os.makedirs(shard_dir, exist_ok=True)

    # -------------------------------------------------------------- record
    def span(self, name: str, cat: str = "",
             args: Optional[dict] = None) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        self._emit(name, cat, "i", time.monotonic(), None, args)

    def counter(self, name: str, value: float) -> None:
        """Chrome 'C' counter sample (e.g. queue depth over time)."""
        self._emit(name, "", "C", time.monotonic(), None,
                   {"value": float(value)})

    def complete(self, name: str, t0: float, dur: float, cat: str = "",
                 args: Optional[dict] = None) -> None:
        """Complete-span with explicit monotonic start + duration — for
        attributing work measured elsewhere onto this process's timeline
        (e.g. entropy-segment timings returned by executor workers).
        CLOCK_MONOTONIC is system-wide on Linux, so the timestamps line
        up with locally-recorded spans."""
        self._emit(name, cat, "X", t0, dur, args)

    def _emit(self, name: str, cat: str, ph: str, t0: float,
              dur: Optional[float], args: Optional[dict]) -> None:
        tid = threading.get_native_id()
        ev = {"name": name, "ph": ph, "pid": self._pid, "tid": tid,
              "ts": round(t0 * 1e6, 3)}
        if cat:
            ev["cat"] = cat
        if dur is not None:
            ev["dur"] = round(dur * 1e6, 3)
        if ph == "i":
            ev["s"] = "t"                      # instant scope: thread
        if args:
            ev["args"] = dict(args)
        with self._lock:
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._buf.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
            self._buf.append(ev)
            pending = len(self._buf)
        if self.autoflush and pending >= self.autoflush:
            self.flush()

    # -------------------------------------------------------------- export
    def events(self) -> List[dict]:
        """The in-memory buffer (shards not included)."""
        with self._lock:
            return list(self._buf)

    def _shard_path(self) -> str:
        return os.path.join(self.shard_dir, f"trace-{self._pid}.jsonl")

    def flush(self) -> None:
        """Move buffered events into this process's shard file."""
        if not self.shard_dir:
            return
        with self._lock:
            if not self._buf:
                return
            batch, self._buf = list(self._buf), deque(
                maxlen=self._buf.maxlen)
            lines = "".join(json.dumps(ev) + "\n" for ev in batch)
            # single buffered write under the lock: concurrent flushes
            # (worker threads hitting autoflush) cannot interleave lines
            with open(self._shard_path(), "a") as f:
                f.write(lines)

    def collect(self) -> List[dict]:
        """All events: in-memory buffer merged with every process shard
        under ``shard_dir``, sorted on the shared monotonic axis."""
        evs = self.events()
        if self.shard_dir:
            evs = evs + merge_shards(self.shard_dir)
        evs.sort(key=lambda e: (e.get("ts", 0.0), e["pid"], e["tid"]))
        return evs

    def export(self, path: str) -> str:
        """Write the merged Chrome trace-event JSON artifact."""
        write_chrome_trace(path, self.collect())
        return path

    def worker_config(self) -> Optional[dict]:
        """Pool-initargs payload a worker process rebuilds a tracer
        from; None without a shard_dir (nowhere for workers to write)."""
        if not self.shard_dir:
            return None
        return {"shard_dir": self.shard_dir,
                "autoflush": self.autoflush or 64}


# --------------------------------------------------------- head sampling
class _SampledSpan:
    """Span guard for :class:`SamplingTracer`: tracks per-thread trace
    depth and materialises a real ``_Span`` only when this trace's head
    decision was *keep*. In a dropped trace the whole span costs two
    thread-local touches and no clock read."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_inner")

    def __init__(self, tracer: "SamplingTracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._inner: Optional[_Span] = None

    def set(self, **args) -> "_SampledSpan":
        if self._inner is not None:
            self._inner.set(**args)
        elif self._args is None:
            self._args = args
        else:
            self._args.update(args)
        return self

    def __enter__(self) -> "_SampledSpan":
        tl = self._tracer._tl
        depth = getattr(tl, "depth", 0)
        if depth == 0:
            tl.keep = self._tracer._decide()
        tl.depth = depth + 1
        if tl.keep:
            self._inner = _Span(self._tracer, self._name, self._cat,
                                self._args)
            self._inner.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        tl = self._tracer._tl
        tl.depth = max(0, getattr(tl, "depth", 1) - 1)
        if self._inner is not None:
            inner, self._inner = self._inner, None
            return inner.__exit__(*exc)
        return False


class SamplingTracer(Tracer):
    """Head-sampled always-on tracer for a live service.

    The keep/drop decision is made once per *root* span — the first
    span a thread opens with no span already active — with a
    deterministic 1-in-N counter where ``N = round(1/rate)``; no RNG,
    so tests and replays see the same traces. Child spans, instants,
    and counters inside a kept trace record fully; inside a dropped
    trace they are no-ops beyond a thread-local read. Events emitted
    *outside* any span go through the same counter, so free-standing
    instants/counters are sampled rather than always dropped.
    ``rate=1.0`` keeps everything (plain ``Tracer`` parity).
    """

    def __init__(self, rate: float = 0.01, *, maxlen: int = 1 << 16,
                 shard_dir: Optional[str] = None, autoflush: int = 0):
        super().__init__(maxlen=maxlen, shard_dir=shard_dir,
                         autoflush=autoflush)
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"sample rate must be in (0, 1]: {rate}")
        self.rate = float(rate)
        self.period = max(1, round(1.0 / self.rate))
        self._tl = threading.local()
        self._heads = 0

    def _decide(self) -> bool:
        if self.period == 1:
            return True
        with self._lock:
            n = self._heads
            self._heads += 1
        return n % self.period == 0

    def _keep_now(self) -> bool:
        """Sampling verdict for a non-span event: inherit the ambient
        trace's head decision, or make one for a free-standing event."""
        tl = self._tl
        if getattr(tl, "depth", 0) > 0:
            return getattr(tl, "keep", False)
        return self._decide()

    def span(self, name: str, cat: str = "",
             args: Optional[dict] = None) -> "_SampledSpan":
        return _SampledSpan(self, name, cat, args)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        if self._keep_now():
            super().instant(name, cat, args)

    def counter(self, name: str, value: float) -> None:
        if self._keep_now():
            super().counter(name, value)

    def complete(self, name: str, t0: float, dur: float, cat: str = "",
                 args: Optional[dict] = None) -> None:
        if self._keep_now():
            super().complete(name, t0, dur, cat, args)


# ------------------------------------------------------- ambient tracer
_current: "NullTracer | Tracer" = NULL


def get_tracer():
    return _current


def set_tracer(tracer) -> None:
    global _current
    _current = NULL if tracer is None else tracer


@contextlib.contextmanager
def use_tracer(tracer):
    """Install ``tracer`` as the ambient tracer for the dynamic extent."""
    prev = _current
    set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def span(name: str, cat: str = "", **args):
    """Ambient-tracer span; the one-liner every instrumented seam uses."""
    return _current.span(name, cat, args or None)


def instant(name: str, cat: str = "", **args) -> None:
    _current.instant(name, cat, args or None)


def counter(name: str, value: float) -> None:
    _current.counter(name, value)


def complete(name: str, t0: float, dur: float, cat: str = "",
             **args) -> None:
    _current.complete(name, t0, dur, cat, args or None)


def flush() -> None:
    _current.flush()


def init_worker(config: Optional[dict]) -> None:
    """Pool-worker side of ``worker_config()``: install a shard-writing
    tracer in this process (no-op when the parent wasn't tracing)."""
    if config:
        set_tracer(Tracer(**config))


# ------------------------------------------------------------- artifacts
def merge_shards(shard_dir: str) -> List[dict]:
    """Read every per-process ``trace-<pid>.jsonl`` shard. Lines are
    self-contained events already carrying pid/tid; a torn final line
    (worker killed mid-write) is dropped, not fatal."""
    out: List[dict] = []
    if not os.path.isdir(shard_dir):
        return out
    for fname in sorted(os.listdir(shard_dir)):
        if not (fname.startswith("trace-") and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(shard_dir, fname)) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def write_chrome_trace(path: str, events: Iterable[dict]) -> str:
    """Chrome trace-event JSON object format (Perfetto-loadable)."""
    payload = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def stage_seconds(events: Iterable[dict],
                  ndigits: int = 6) -> Dict[str, float]:
    """Aggregate complete-span wall time by span name, in seconds —
    the ``meta.stage_s`` breakdown bench records carry. Nested spans
    each count their own duration (parse/entropy/transform don't nest),
    so stage shares are read per name, not summed across names."""
    agg: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        agg[ev["name"]] = agg.get(ev["name"], 0.0) + ev.get("dur", 0.0)
    return {k: round(v / 1e6, ndigits) for k, v in sorted(agg.items())}
