"""Headers-only probe: the bucket identity of a JPEG without the scan.

``probe_key`` parses *headers only* (``parser.parse(headers_only=True)``
stops at SOS), so deriving a bucket key costs O(header bytes), never the
O(file-size) entropy-stream scan — the property the ``Capabilities``
flag ``headers_only_probe`` declares. The key is the padded MCU grid
plus sampling structure: exactly the coefficient-array shapes, i.e. the
jit compile-cache identity of the jnp/Pallas decode paths. Grid dims
round up to ``granularity`` MCUs so near-identical resolutions share a
bucket.

``probe_outcome`` is the admission-time wrapper the service batcher
uses: instead of throwing on inputs the decode surface will refuse
anyway (unknown SOF families, or SOF2 when the session's capabilities
are baseline-only), it returns a skip-shaped ``ProbeResult`` and emits a
``jpeg.probe.skip`` trace instant — the router then records a skip
rather than failing the request on a probe exception. Truly corrupt
headers still raise ``CorruptJpeg``.

The service micro-batcher's ``bucket_key`` delegates here; decoder
sessions expose both as ``Decoder.probe`` / ``Decoder.probe_outcome``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.codecs.capabilities import Capabilities
from repro_torch.jpeg import parser as P
from repro_torch.obs import trace

BucketKey = Tuple[int, int, int, Tuple[Tuple[int, int], ...]]


def _ceil_to(x: int, g: int) -> int:
    return ((x + g - 1) // g) * g


def _key_of(spec: P.DecodeSpec, granularity: int) -> BucketKey:
    mcu_rows = -(-spec.height // spec.mcu_h)
    mcu_cols = -(-spec.width // spec.mcu_w)
    sampling = tuple((c.h, c.v) for c in spec.components)
    return (_ceil_to(mcu_rows, granularity), _ceil_to(mcu_cols, granularity),
            len(spec.components), sampling)


def probe_key(data: bytes, granularity: int = 4) -> BucketKey:
    return _key_of(P.parse(data, headers_only=True), granularity)


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """Admission verdict for one input: a bucket key, or a skip reason.

    ``key is None`` means the input should be routed as a skip (typed
    refusal), not batched for decode; ``progressive`` reports the frame
    type when headers parsed at all.
    """

    key: Optional[BucketKey] = None
    skip_reason: str = ""
    progressive: bool = False

    @property
    def skip(self) -> bool:
        return self.key is None


def probe_outcome(data: bytes, granularity: int = 4,
                  caps: Optional[Capabilities] = None) -> ProbeResult:
    """Probe that never throws on *refusable* inputs.

    Unsupported frame families (``UnsupportedJpeg`` from the parser) and
    — when ``caps`` is given — progressive streams against a
    baseline-only capability set come back as skip results, each marked
    by a ``jpeg.probe.skip`` instant. Corrupt headers (bad markers,
    truncated segments) still raise ``CorruptJpeg``: refusing known-rare
    modes is admission policy, garbled bytes are errors.
    """
    try:
        spec = P.parse(data, headers_only=True)
    except P.UnsupportedJpeg as e:
        reason = str(e)
        trace.instant("jpeg.probe.skip", reason=reason)
        return ProbeResult(key=None, skip_reason=reason)
    if spec.progressive and caps is not None and not caps.progressive:
        reason = ("progressive (SOF2) input: decoder does not advertise "
                  "Capabilities.progressive")
        trace.instant("jpeg.probe.skip", reason=reason, progressive=True)
        return ProbeResult(key=None, skip_reason=reason, progressive=True)
    return ProbeResult(key=_key_of(spec, granularity),
                       progressive=spec.progressive)
