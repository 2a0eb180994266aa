"""Decoder sessions: a context-checked lifecycle over registered decoders.

``open_decoder(name, context=...)`` is the front door of the decode
surface. It resolves the decoder, asks the ``eligible`` resolver whether
it may run in the given ``ExecContext`` (raising ``IneligibleDecoder``
with the canonical reason if not), and returns a ``Decoder`` session:

    with open_decoder("cuda-batch", context=ExecContext.INLINE) as dec:
        key = dec.probe(data)            # headers-only bucket identity
        out = dec.decode(data)           # -> DecodeOutcome
        outs = dec.decode_batch(datas)   # -> list[DecodeOutcome]

Sessions translate the registration-level exception conventions into
typed ``DecodeOutcome``s at the boundary, so consumers stop doing
isinstance surgery on result lists. ``warmup`` pre-touches jit/compile
caches; ``close`` (or leaving the ``with`` block) invalidates the
session so lifecycle bugs surface as errors, not silent reuse.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

from repro_torch.codecs.capabilities import (Capabilities, ExecContext,
                                             eligible,
                                             resolve_entropy_workers)
from repro_torch.codecs.outcome import DecodeOutcome, outcome_of
from repro_torch.codecs.probe import (BucketKey, ProbeResult, probe_key,
                                      probe_outcome)
from repro_torch.codecs.registry import DecoderSpec, as_spec
from repro_torch.jpeg import huffman
from repro_torch.jpeg.parser import CorruptJpeg, UnsupportedJpeg


class IneligibleDecoder(RuntimeError):
    """open_decoder refused: the decoder may not run in this context."""


class Decoder:
    """One open decode session: a decoder bound to an ExecContext."""

    def __init__(self, spec: DecoderSpec, context: ExecContext,
                 entropy_workers: int = 0):
        self.spec = spec
        self.context = context
        self._closed = False
        # interval-parallel entropy decode: 0 = leave the ambient/env
        # default in force; >=1 = resolve the request against this
        # (caps, context) pairing and pin it for every decode in the
        # session. A demotion is recorded, never silent (DESIGN.md §10).
        requested = int(entropy_workers)
        if requested > 0:
            eff, reason = resolve_entropy_workers(
                spec.caps, context, requested)
        else:
            eff, reason = 0, ""
        self.entropy_workers = eff
        self.entropy_demotion = reason

    # ------------------------------------------------------------ identity
    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def caps(self) -> Capabilities:
        return self.spec.caps

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (f"<Decoder {self.spec.name!r} context={self.context} "
                f"{state}>")

    # ------------------------------------------------------------ lifecycle
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"decoder session {self.spec.name!r} is closed")

    def warmup(self, samples: Sequence[bytes]) -> int:
        """Pre-touch jit/compile caches with representative inputs (both
        the single and, when batchable, the batched entry point). Returns
        the number of samples that decoded to an image."""
        self._check_open()
        n = sum(self.decode(s).ok for s in samples)
        if self.caps.batchable and samples:
            self.decode_batch(list(samples))
        return n

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "Decoder":
        self._check_open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _entropy_scope(self):
        """Context pinning the session's resolved entropy_workers around
        a decode call (workers=0: no-op, ambient default stays)."""
        if self.entropy_workers > 0:
            return huffman.entropy_workers(self.entropy_workers)
        return contextlib.nullcontext()

    # ------------------------------------------------------------ decoding
    def decode(self, data: bytes) -> DecodeOutcome:
        """Decode one JPEG to a typed outcome. Decode-domain failures
        (policy refusal, corrupt input) become skip/error outcomes;
        anything else is a programming error and propagates."""
        self._check_open()
        try:
            with self._entropy_scope():
                img = self.spec.fn(data)
        except UnsupportedJpeg as e:
            return DecodeOutcome.of_skip(e)
        except CorruptJpeg as e:
            return DecodeOutcome.of_error(e)
        return DecodeOutcome.of_image(img)

    def decode_batch(self, datas: Sequence[bytes]) -> List[DecodeOutcome]:
        """Decode a micro-batch; index-aligned outcomes. Per-item refusals
        and failures come back in place (batch-mates are unaffected); a
        batch-wide explosion in a registered batch_fn propagates."""
        self._check_open()
        with self._entropy_scope():
            raw = self.spec.decode_batch(list(datas))
        return [outcome_of(r) for r in raw]

    def probe(self, data: bytes, granularity: int = 4) -> BucketKey:
        """Headers-only bucket identity (micro-batching / admission key)."""
        self._check_open()
        if not self.caps.headers_only_probe:
            raise NotImplementedError(
                f"decoder {self.spec.name!r} does not support "
                "headers-only probing")
        return probe_key(data, granularity)

    def probe_outcome(self, data: bytes,
                      granularity: int = 4) -> ProbeResult:
        """Admission probe against this session's capabilities: refusable
        inputs (unsupported frame families, progressive streams on a
        baseline-only decoder) come back as skip results instead of
        exceptions (see ``codecs.probe.probe_outcome``)."""
        self._check_open()
        if not self.caps.headers_only_probe:
            raise NotImplementedError(
                f"decoder {self.spec.name!r} does not support "
                "headers-only probing")
        return probe_outcome(data, granularity, caps=self.caps)


def open_decoder(path, context: ExecContext = ExecContext.INLINE,
                 entropy_workers: int = 0) -> Decoder:
    """Open a decode session for ``path`` (a registered name, a
    DecoderSpec, or a legacy path-like object) in ``context``.

    Raises ``IneligibleDecoder`` — with the resolver's canonical reason —
    when the capability/context pairing is vetoed, so an ineligible
    deployment fails at open time instead of deep inside a worker pool.

    ``entropy_workers > 0`` requests interval-parallel entropy decode for
    the session; the request is resolved (and possibly demoted, with the
    reason on ``Decoder.entropy_demotion``) by
    ``resolve_entropy_workers`` — demotion is recorded, not an error,
    because a no-DRI corpus or 1-CPU host is a deployment fact, not a
    misconfiguration. ``0`` leaves the ambient/env default in force.
    """
    spec = as_spec(path)
    verdict = eligible(spec.caps, context)
    if not verdict:
        raise IneligibleDecoder(
            f"decode path {spec.name!r} in context {context}: "
            f"{verdict.reason}")
    return Decoder(spec, context, entropy_workers=entropy_workers)
