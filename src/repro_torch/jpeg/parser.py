"""JPEG segment parser: headers -> DecodeSpec (+ strictness signals)."""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.jpeg import tables as T


class CorruptJpeg(Exception):
    pass


class UnsupportedJpeg(CorruptJpeg):
    """Raised on JPEG modes the decode surface does not implement —
    strict-policy refusals (the paper's skip-accounting case) and frame
    types outside the baseline/progressive DCT families. A subclass of
    ``CorruptJpeg`` so a catch-all on the decode-domain error type also
    covers refusals; consumers that distinguish the two (skip vs error)
    catch ``UnsupportedJpeg`` first."""


# Frame-type classification (T.81 table B.1). SOF0/1/2 decode here; every
# other SOFn — lossless, differential, arithmetic-coded — is recognized by
# name and refused with a typed UnsupportedJpeg instead of the old silent
# misparse (the generic segment-skip path dropped the frame header and
# decode failed later with an unrelated "no frame/scan" error).
SUPPORTED_SOF = (0xC0, 0xC1, 0xC2)
UNSUPPORTED_SOF = {
    0xC3: "SOF3 (lossless sequential)",
    0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (differential arithmetic sequential)",
    0xCE: "SOF14 (differential arithmetic progressive)",
    0xCF: "SOF15 (differential arithmetic lossless)",
    0xCC: "DAC (arithmetic coding conditioning)",
}


@dataclasses.dataclass
class Component:
    cid: int
    h: int               # horizontal sampling factor
    v: int
    tq: int              # quant table id
    td: int = 0          # DC huffman table id
    ta: int = 0          # AC huffman table id


@dataclasses.dataclass
class Scan:
    """One SOS header plus its entropy-coded data.

    Progressive decode needs per-scan state the frame header cannot carry:
    spectral band (Ss/Se), successive-approximation bit positions (Ah/Al),
    the Huffman tables *as defined at scan time* (optimized progressive
    encoders redefine DHT between scans), and the restart interval in
    force when the scan started (DRI may appear between scans).
    """
    comps: List[Tuple[int, int, int]]   # (cid, td, ta) in scan order
    ss: int                              # spectral selection start
    se: int                              # spectral selection end
    ah: int                              # successive approximation high
    al: int                              # successive approximation low
    data: bytes                          # entropy-coded bytes (stuffed)
    htables: Dict[Tuple[int, int], Tuple[list, list]]
    restart_interval: int = 0


@dataclasses.dataclass
class DecodeSpec:
    height: int
    width: int
    components: List[Component]
    qtables: Dict[int, np.ndarray]              # natural order [8,8]
    htables: Dict[Tuple[int, int], Tuple[list, list]]  # (tc,th)->(bits,vals)
    scan_data: bytes
    progressive: bool = False
    adobe_transform: Optional[int] = None
    precision: int = 8
    restart_interval: int = 0                   # DRI: MCUs per restart (0=off)
    scans: List[Scan] = dataclasses.field(default_factory=list)

    @property
    def mcu_h(self) -> int:
        return 8 * max(c.v for c in self.components)

    @property
    def mcu_w(self) -> int:
        return 8 * max(c.h for c in self.components)


def parse(data: bytes, headers_only: bool = False) -> DecodeSpec:
    """Parse a JFIF stream into a DecodeSpec.

    ``data`` is any bytes-like buffer — ``bytes`` or a zero-copy
    ``memoryview`` served by ``repro.store`` shard readers; header
    parsing never copies the payload (``scan_data`` stays a view into
    the caller's buffer until entropy decode destuffs it).

    ``headers_only=True`` stops at SOS without scanning the entropy-coded
    data (``scan_data`` is left empty). The O(file-size) entropy scan is
    the bulk of parse time on large files; admission-time callers that
    only need frame structure (``service.batcher.bucket_key``) use this.
    """
    if data[:2] != b"\xff\xd8":
        raise CorruptJpeg("missing SOI")
    i = 2
    qtables: Dict[int, np.ndarray] = {}
    htables: Dict[Tuple[int, int], Tuple[list, list]] = {}
    comps: List[Component] = []
    H = W = 0
    progressive = False
    adobe = None
    precision = 8
    restart_interval = 0
    scan = b""
    scans: List[Scan] = []
    n = len(data)
    while i < n:
        if data[i] != 0xFF:
            raise CorruptJpeg(f"marker expected at {i}")
        # tolerate 0xFF fill-byte padding before the marker code (B.1.1.2)
        while i + 1 < n and data[i + 1] == 0xFF:
            i += 1
        if i + 1 >= n:
            raise CorruptJpeg("truncated marker")
        marker = data[i + 1]
        i += 2
        if marker == 0xD9:       # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        if i + 2 > n:
            raise CorruptJpeg("truncated segment length")
        (length,) = struct.unpack(">H", data[i:i + 2])
        if length < 2 or i + length > n:
            raise CorruptJpeg("segment length overruns file")
        payload = data[i + 2:i + length]
        i += length
        if marker == 0xDB:       # DQT
            j = 0
            while j < len(payload):
                pq, tq = payload[j] >> 4, payload[j] & 0xF
                j += 1
                if pq:
                    raise UnsupportedJpeg("16-bit quant tables")
                if j + 64 > len(payload):
                    raise CorruptJpeg("truncated DQT table")
                zz = np.frombuffer(payload[j:j + 64], dtype=np.uint8)
                j += 64
                nat = np.zeros(64, np.int32)
                nat[T.ZIGZAG] = zz
                qtables[tq] = nat.reshape(8, 8)
        elif marker in SUPPORTED_SOF:          # SOF0/1/2
            progressive = marker == 0xC2
            try:
                precision = payload[0]
                H, W = struct.unpack(">HH", payload[1:5])
                nc = payload[5]
                comps = []
                for k in range(nc):
                    cid, hv, tq = payload[6 + 3 * k:9 + 3 * k]
                    comps.append(Component(cid, hv >> 4, hv & 0xF, tq))
            except (struct.error, IndexError, ValueError) as e:
                raise CorruptJpeg(f"truncated SOF payload: {e}") from None
        elif marker in UNSUPPORTED_SOF:
            raise UnsupportedJpeg(
                f"unsupported frame type {UNSUPPORTED_SOF[marker]}")
        elif marker == 0xC4:     # DHT
            j = 0
            while j < len(payload):
                tc, th = payload[j] >> 4, payload[j] & 0xF
                if j + 17 > len(payload):
                    raise CorruptJpeg("truncated DHT bit counts")
                bits = [0] + list(payload[j + 1:j + 17])
                nv = sum(bits)
                if j + 17 + nv > len(payload):
                    raise CorruptJpeg("truncated DHT values")
                vals = list(payload[j + 17:j + 17 + nv])
                htables[(tc, th)] = (bits, vals)
                j += 17 + nv
        elif marker == 0xDD:     # DRI
            if len(payload) < 2:
                raise CorruptJpeg("truncated DRI payload")
            (restart_interval,) = struct.unpack(">H", payload[:2])
        elif marker == 0xEE and payload[:5] == b"Adobe":
            if len(payload) < 12:
                raise CorruptJpeg("truncated Adobe APP14 payload")
            adobe = payload[11]
        elif marker == 0xDA:     # SOS
            try:
                ns = payload[0]
                scan_comps: List[Tuple[int, int, int]] = []
                for k in range(ns):
                    cid, tt = payload[1 + 2 * k:3 + 2 * k]
                    scan_comps.append((cid, tt >> 4, tt & 0xF))
                    for c in comps:
                        if c.cid == cid:
                            c.td, c.ta = tt >> 4, tt & 0xF
                ss, se, ahal = payload[1 + 2 * ns:4 + 2 * ns]
            except (IndexError, ValueError) as e:
                raise CorruptJpeg(f"truncated SOS payload: {e}") from None
            if headers_only:
                # record the scan header (empty data) so headers-only
                # callers still see the first scan's band/approximation
                scans.append(Scan(scan_comps, ss, se, ahal >> 4, ahal & 0xF,
                                  b"", dict(htables), restart_interval))
                break
            # entropy data runs until next non-RST marker
            j = i
            while j < n - 1:
                if data[j] == 0xFF and data[j + 1] not in (0x00,) \
                        and not (0xD0 <= data[j + 1] <= 0xD7):
                    break
                j += 1
            scan = data[i:j]
            # snapshot the Huffman-table environment: progressive encoders
            # may redefine DHT between scans, so each scan keeps the tables
            # (and DRI) in force when it started
            scans.append(Scan(scan_comps, ss, se, ahal >> 4, ahal & 0xF,
                              scan, dict(htables), restart_interval))
            i = j
    if not comps or (not scan and not headers_only):
        raise CorruptJpeg("no frame/scan")
    return DecodeSpec(H, W, comps, qtables, htables, scan,
                      progressive=progressive, adobe_transform=adobe,
                      precision=precision, restart_interval=restart_interval,
                      scans=scans)


def check_strict(spec: DecodeSpec) -> None:
    """The strict-decoder policy: reject the rare modes (paper section 4.4:
    'uncommon color-transform/four-channel JPEG case')."""
    if spec.progressive:
        raise UnsupportedJpeg("progressive scan")
    if len(spec.components) == 4 or (spec.adobe_transform or 0) == 2:
        raise UnsupportedJpeg("4-component / Adobe YCCK color transform")
    if spec.precision != 8:
        raise UnsupportedJpeg("non-8-bit precision")
