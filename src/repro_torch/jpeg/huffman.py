"""Entropy (Huffman) decode: scan bytes -> per-component DCT coefficients.

This stage is bit-serial *within* a restart segment (each symbol's
position depends on the previous), so it runs on the host CPU —
mirroring the paper's CPU-decode scope; the parallel transform stages
(dequant/IDCT/color) are JAX/Pallas. Decode uses 16-bit-window LUTs
(libjpeg-style) rather than per-bit walks.

Restart intervals (DRI/RSTn) break that serial chain: each segment is
byte-aligned and starts with DC predictors at 0 (F.2.2.4), so per-segment
decode is a **pure function** of (segment bytes, Huffman tables,
component layout, MCU count) — the self-synchronization property
Weißenberger & Schmidt exploit for GPU entropy decode. ``decode_segment``
is that pure function; serial and parallel decode both compose it, so
parallel output is byte-identical to serial by construction.

Parallel decode fans segments out to a shared fork-based
``ProcessPoolExecutor`` (the inner decode loop is pure Python and
GIL-bound — threads cannot speed it up). The worker count is an ambient
knob: ``REPRO_ENTROPY_WORKERS`` sets the process default, and the
``entropy_workers(n)`` context manager overrides it per call site (it is
a ContextVar — wrap at the decode call, pool worker threads do not
inherit a parent thread's override). Images without restart intervals
fall back to serial decode, recorded via the ``jpeg.entropy`` span args,
a ``jpeg.entropy.fallback`` instant, and the ``entropy_stats()``
counters — never silently. See DESIGN.md §10.
"""
from __future__ import annotations

import contextlib
import contextvars
import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.jpeg import tables as T
from repro_torch.jpeg.parser import CorruptJpeg, DecodeSpec
from repro_torch.obs import trace


class BitReader:
    __slots__ = ("data", "pos", "acc", "nbits", "n")

    def __init__(self, data: bytes):
        # destuff 0xFF00 -> 0xFF; restart markers are split out *before*
        # the reader sees the bytes (see _restart_segments), so the only
        # 0xFF sequences left inside a segment are stuffed data bytes.
        # mmap-backed sources hand us memoryviews; destuffing copies
        # regardless, so materializing here costs nothing extra.
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        self.data = data.replace(b"\xff\x00", b"\xff")
        self.n = len(self.data)
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def peek16(self) -> int:
        while self.nbits < 16:
            b = self.data[self.pos] if self.pos < self.n else 0
            self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFF
            self.nbits += 8
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def drop(self, k: int) -> None:
        self.nbits -= k

    def get(self, k: int) -> int:
        if k == 0:
            return 0
        while self.nbits < k:
            b = self.data[self.pos] if self.pos < self.n else 0
            self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFF
            self.nbits += 8
        v = (self.acc >> (self.nbits - k)) & ((1 << k) - 1)
        self.nbits -= k
        return v

    def bits_consumed(self) -> int:
        """Bits actually decoded so far. ``peek16`` fabricates zero bytes
        past the segment end for lookahead; those stay buffered in
        ``acc``/``nbits`` until a symbol consumes them, so consumed >
        available is the signature of a truncated segment — the old
        silent-misdecode mode where garbage zero bits decoded as data."""
        return 8 * self.pos - self.nbits


def _extend(bits: int, size: int) -> int:
    if size == 0:
        return 0
    if bits < (1 << (size - 1)):
        return bits - (1 << size) + 1
    return bits


def _restart_segments(scan: bytes) -> list:
    """Split entropy-coded data at RSTn (0xFFD0..D7) marker boundaries.

    The markers themselves are byte-aligned and carry no entropy bits, so
    each returned segment is an independent bit stream: the decoder resets
    DC predictors and bit alignment at every boundary (F.2.2.4). Stuffed
    0xFF00 pairs are data, not markers, and are stepped over whole."""
    segs = []
    start = 0
    i = 0
    n = len(scan)
    while i < n - 1:
        if scan[i] == 0xFF:
            nxt = scan[i + 1]
            if 0xD0 <= nxt <= 0xD7:
                segs.append(scan[start:i])
                start = i + 2
            i += 2               # marker or stuffed pair: step over both
        else:
            i += 1
    segs.append(scan[start:])
    return segs


# ------------------------------------------------------------ ambient knob
def _env_default() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_ENTROPY_WORKERS", "1")))
    except ValueError:
        return 1


_DEFAULT_WORKERS = _env_default()
_WORKERS_VAR: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_entropy_workers", default=0)   # 0 = inherit the process default


def current_entropy_workers() -> int:
    """The effective ambient worker count: an ``entropy_workers(n)``
    override if one is active on this thread, else the
    ``REPRO_ENTROPY_WORKERS`` process default (1 = serial)."""
    v = _WORKERS_VAR.get()
    return v if v > 0 else _DEFAULT_WORKERS


@contextlib.contextmanager
def entropy_workers(n: int):
    """Ambient override for the segment-decode worker count. ``n=1``
    forces serial even when ``REPRO_ENTROPY_WORKERS`` requests more —
    that is how the eligibility resolver demotes a decode site. ContextVar
    scope: wrap at the decode call site; pool worker threads do not
    inherit a parent thread's override."""
    token = _WORKERS_VAR.set(max(1, int(n)))
    try:
        yield
    finally:
        _WORKERS_VAR.reset(token)


# ------------------------------------------------------------ mode stats
class EntropyStats:
    """Thread-safe counters for serial/parallel mode decisions — the
    "recorded as such, not silently" half of the fallback contract.
    Consumers snapshot before/after a measured region and report the
    delta (see SingleThreadProtocol.run_path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def bump(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._counts[k] = self._counts.get(k, 0) + v

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


STATS = EntropyStats()


def entropy_stats() -> Dict[str, int]:
    """Process-wide counter snapshot: ``parallel_images``,
    ``serial_images``, ``segments_parallel``, and ``fallback_*`` reasons."""
    return STATS.snapshot()


# ------------------------------------------------------- shared executor
class _ExecutorCell:
    """Owns the process-wide segment-decode executor: one fork-context
    ``ProcessPoolExecutor`` shared by every decode site, created lazily
    and grown (never shrunk) to the largest requested worker count. No
    initializer/initargs: tasks are self-contained (segment bytes +
    hashable tables), so nothing corpus-sized crosses the fork boundary
    and workers rebuild LUTs via a per-process cache."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: Optional[ProcessPoolExecutor] = None
        self._size = 0

    def get(self, workers: int) -> ProcessPoolExecutor:
        with self._lock:
            if self._pool is None or self._size < workers:
                if self._pool is not None:
                    self._pool.shutdown(wait=False, cancel_futures=True)
                self._pool = ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("fork"))
                self._size = workers
            return self._pool


_EXECUTOR = _ExecutorCell()


def _reset_executor_after_fork() -> None:
    # a forked child (loader process workers) inherits the cell but not
    # the executor's queue-management threads — its copy is dead pipes.
    # Replace the whole cell so a child can never submit into it; the
    # resolver demotes child decode to serial anyway (daemonic guard).
    global _EXECUTOR
    _EXECUTOR = _ExecutorCell()


os.register_at_fork(after_in_child=_reset_executor_after_fork)


# ------------------------------------------------------ per-segment decode
def hashable_tables(htables) -> tuple:
    """``DecodeSpec.htables`` ({(tc, th): (bits, vals)}) as a hashable,
    picklable key — what ``decode_segment`` takes, so LUTs can be cached
    per process (parent and executor workers alike) instead of rebuilt
    per image (4 x 65536-entry LUT builds per decode before this)."""
    return tuple(sorted(
        (key, (tuple(bits), tuple(vals)))
        for key, (bits, vals) in htables.items()))


@lru_cache(maxsize=16)
def _luts_for(tables_key: tuple) -> dict:
    return {key: T.decode_lut(bits, vals) for key, (bits, vals)
            in tables_key}


def component_layout(spec: DecodeSpec) -> tuple:
    """The picklable component spec ``decode_segment`` takes:
    ((cid, h, v, td, ta), ...) in scan order."""
    return tuple((c.cid, c.h, c.v, c.td, c.ta) for c in spec.components)


def decode_segment(seg: bytes, tables_key: tuple, components: tuple,
                   n_mcus: int) -> Dict[int, np.ndarray]:
    """Decode ONE restart segment: a pure function of (segment bytes,
    Huffman tables, component layout, MCU count).

    The restart invariant (F.2.2.4) makes this self-contained: the
    segment is byte-aligned and DC predictors start at 0, so no state
    crosses segment boundaries. Returns ``{cid: int32 [n_mcus, v, h, 64]}``
    natural-order coefficient blocks indexed by segment-relative MCU;
    the caller scatters them into the image's block grid by absolute MCU
    index. Raises ``CorruptJpeg`` on invalid codes, run overflow, or a
    segment too short for its MCU count (truncation)."""
    luts = _luts_for(tables_key)
    br = BitReader(seg)
    out = {cid: np.zeros((n_mcus, v, h, 64), dtype=np.int32)
           for cid, h, v, _, _ in components}
    preds = {cid: 0 for cid, _, _, _, _ in components}
    inv_zz = T.ZIGZAG  # zigzag index i -> natural position

    for m in range(n_mcus):
        for cid, h, v, td, ta in components:
            dc_sym, dc_len = luts[(0, td)]
            ac_sym, ac_len = luts[(1, ta)]
            grid = out[cid]
            for dy in range(v):
                for dx in range(h):
                    blk = np.zeros(64, dtype=np.int32)
                    w = br.peek16()
                    s = int(dc_sym[w])
                    if s < 0:
                        raise CorruptJpeg("bad DC code")
                    br.drop(int(dc_len[w]))
                    diff = _extend(br.get(s), s)
                    preds[cid] += diff
                    blk[0] = preds[cid]
                    k = 1
                    while k < 64:
                        w = br.peek16()
                        rs = int(ac_sym[w])
                        if rs < 0:
                            raise CorruptJpeg("bad AC code")
                        br.drop(int(ac_len[w]))
                        if rs == 0:          # EOB
                            break
                        if rs == 0xF0:       # ZRL
                            k += 16
                            continue
                        k += rs >> 4
                        size = rs & 0xF
                        if k > 63:
                            raise CorruptJpeg("AC run overflow")
                        blk[inv_zz[k]] = _extend(br.get(size), size)
                        k += 1
                    grid[m, dy, dx] = blk
    if br.bits_consumed() > 8 * br.n:
        raise CorruptJpeg(
            f"truncated entropy segment: decoded {n_mcus} MCUs consumed "
            f"{br.bits_consumed()} bits of {8 * br.n} available")
    return out


def _decode_chunk(segs: List[bytes], counts: List[int], tables_key: tuple,
                  components: tuple) -> list:
    """Executor task: decode a contiguous run of segments. Returns
    [(coefficients, t0, dur), ...] with CLOCK_MONOTONIC timestamps
    (system-wide on Linux), so the parent emits ``jpeg.entropy.segment``
    spans for work that happened in a worker process."""
    out = []
    for seg, n_mcus in zip(segs, counts):
        t0 = time.monotonic()
        coef = decode_segment(seg, tables_key, components, n_mcus)
        out.append((coef, t0, time.monotonic() - t0))
    return out


# ------------------------------------------------------------ whole image
def _segment_plan(spec: DecodeSpec) -> Tuple[list, List[int], int, int]:
    """-> (segments, per-segment MCU counts, mcu_rows, mcu_cols).

    Validates the segment count against the declared restart interval
    up front: a DRI that promises more segments than the scan carries
    (missing RSTn, or no markers at all) is corrupt — both serial and
    parallel decode must refuse it rather than hang or misdecode.
    Trailing extra segments (stray RSTn) are ignored, matching the
    pre-refactor serial decoder."""
    hmax = max(c.h for c in spec.components)
    vmax = max(c.v for c in spec.components)
    mcu_cols = (spec.width + 8 * hmax - 1) // (8 * hmax)
    mcu_rows = (spec.height + 8 * vmax - 1) // (8 * vmax)
    total = mcu_rows * mcu_cols
    ri = spec.restart_interval
    if not ri:
        return [spec.scan_data], [total], mcu_rows, mcu_cols
    expected = (total + ri - 1) // ri
    segs = _restart_segments(spec.scan_data)
    if len(segs) < expected:
        raise CorruptJpeg(
            f"missing RST marker for interval: DRI={ri} over {total} "
            f"MCUs expects {expected} segments, scan has {len(segs)}")
    counts = [ri] * (expected - 1) + [total - ri * (expected - 1)]
    return segs[:expected], counts, mcu_rows, mcu_cols


def _scatter(out: Dict[int, np.ndarray], coef: Dict[int, np.ndarray],
             m0: int, n_mcus: int, mcu_cols: int,
             components: tuple) -> None:
    """Place one segment's MCU-relative blocks into the global block
    grids by absolute MCU index (row-major my*mcu_cols + mx)."""
    ms = np.arange(m0, m0 + n_mcus)
    my, mx = ms // mcu_cols, ms % mcu_cols
    for cid, h, v, _, _ in components:
        blocks = coef[cid]
        tgt = out[cid]
        for dy in range(v):
            for dx in range(h):
                tgt[my * v + dy, mx * h + dx] = blocks[:, dy, dx]


def _chunk_bounds(n: int, k: int) -> List[Tuple[int, int]]:
    """Split n items into k contiguous near-equal chunks (one executor
    task each: bounds dispatch + pickling to k round trips per image)."""
    base, rem = divmod(n, k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _resolve_mode(requested: int, n_segments: int) -> Tuple[str, str]:
    """(mode, fallback-reason). Parallel needs >1 requested workers, >1
    restart segments (no-DRI and whole-image-interval scans are a single
    serial bit stream), and a non-daemonic process (multiprocessing.Pool
    workers may not fork children — the loader's process mode decodes
    serially in-worker, which the eligibility resolver also enforces)."""
    if requested <= 1:
        return "serial", ""
    if n_segments <= 1:
        return "serial", "fallback_no_dri"
    if multiprocessing.current_process().daemon:
        return "serial", "fallback_daemonic_worker"
    return "parallel", ""


def _decode_serial(out, segs, counts, tables_key, components,
                   mcu_cols) -> None:
    m0 = 0
    multi = len(segs) > 1
    for seg, n_mcus in zip(segs, counts):
        if multi:
            with trace.span("jpeg.entropy.segment", mcus=n_mcus):
                coef = decode_segment(seg, tables_key, components, n_mcus)
        else:
            coef = decode_segment(seg, tables_key, components, n_mcus)
        _scatter(out, coef, m0, n_mcus, mcu_cols, components)
        m0 += n_mcus


def _decode_parallel(out, segs, counts, tables_key, components, workers,
                     mcu_cols) -> None:
    pool = _EXECUTOR.get(workers)
    bounds = _chunk_bounds(len(segs), min(workers, len(segs)))
    futs = []
    for lo, hi in bounds:
        chunk = [s if isinstance(s, bytes) else bytes(s)
                 for s in segs[lo:hi]]
        futs.append((lo, pool.submit(_decode_chunk, chunk, counts[lo:hi],
                                     tables_key, components)))
    offsets = [0]
    for n in counts:
        offsets.append(offsets[-1] + n)
    for lo, fut in futs:
        for k, (coef, t0, dur) in enumerate(fut.result()):
            trace.complete("jpeg.entropy.segment", t0, dur,
                           mcus=counts[lo + k], parallel=True)
            _scatter(out, coef, offsets[lo + k], counts[lo + k],
                     mcu_cols, components)


def decode_coefficients(spec: DecodeSpec,
                        workers: Optional[int] = None
                        ) -> Dict[int, np.ndarray]:
    """-> {cid: int32 [by, bx, 8, 8] natural-order coefficient blocks}
    (by/bx = MCU-padded component block grid).

    ``workers`` > 1 requests interval-parallel decode (None = the ambient
    ``current_entropy_workers()``); the actual mode is resolved per image
    (see ``_resolve_mode``) and recorded on the ``jpeg.entropy`` span,
    with serial fallbacks also counted in ``entropy_stats()`` and marked
    by a ``jpeg.entropy.fallback`` instant. Serial and parallel decode
    run the same ``decode_segment`` pure function, so their coefficient
    output is byte-identical by construction.

    SOF2 streams dispatch to the progressive decoder (multi-scan
    coefficient accumulation, same output layout) — every decode path
    inherits progressive support through this single entry point."""
    if spec.progressive:
        from repro_torch.jpeg import progressive as _progressive
        return _progressive.decode_coefficients_progressive(spec, workers)
    requested = int(workers) if workers else current_entropy_workers()
    components = component_layout(spec)
    tables_key = hashable_tables(spec.htables)
    segs, counts, mcu_rows, mcu_cols = _segment_plan(spec)
    out: Dict[int, np.ndarray] = {}
    for c in spec.components:
        out[c.cid] = np.zeros((mcu_rows * c.v, mcu_cols * c.h, 64),
                              dtype=np.int32)
    mode, fallback = _resolve_mode(requested, len(segs))
    with trace.span("jpeg.entropy") as sp:
        sp.set(mode=mode, segments=len(segs),
               workers=requested if mode == "parallel" else 1)
        if mode == "parallel":
            STATS.bump(parallel_images=1, segments_parallel=len(segs))
            _decode_parallel(out, segs, counts, tables_key, components,
                             requested, mcu_cols)
        else:
            bumps = {"serial_images": 1}
            if fallback:
                # a parallel request demoted to serial is never silent:
                # span arg + instant event + process-wide counter
                sp.set(fallback=fallback)
                trace.instant("jpeg.entropy.fallback", reason=fallback,
                              workers=requested)
                bumps[fallback] = 1
            STATS.bump(**bumps)
            _decode_serial(out, segs, counts, tables_key, components,
                           mcu_cols)
    for c in spec.components:
        by, bx, _ = out[c.cid].shape
        out[c.cid] = out[c.cid].reshape(by, bx, 8, 8)
    return out
