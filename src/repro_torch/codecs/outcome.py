"""The typed decode result: image | skip(reason) | error(exc).

Before this type, the decoder surface spoke two ad-hoc conventions —
single decode raised (``UnsupportedJpeg`` meaning "refused by policy",
``CorruptJpeg`` meaning "bad input") and batched decode returned a list
of arrays-or-exceptions — and every consumer re-implemented the
classification with isinstance checks. ``DecodeOutcome`` names the three
cases once:

* ``image``  — decoded pixels, in ``outcome.image``.
* ``skip``   — the decoder *refused* the input by policy (a strict path
  on a rare JPEG mode). Recoverable: another decoder can serve it — the
  service retries skips on a non-strict fallback arm, the loader writes
  them to the skip ledger.
* ``error``  — the input (or the decode itself) failed: corrupt stream,
  exploded transform. ``outcome.error`` holds the exception.

``unwrap()`` recovers the legacy raise-or-return convention when a
caller genuinely wants an exception.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.jpeg.parser import UnsupportedJpeg


@dataclasses.dataclass(frozen=True)
class DecodeOutcome:
    IMAGE = "image"
    SKIP = "skip"
    ERROR = "error"

    kind: str
    image: Optional[np.ndarray] = None
    reason: str = ""
    error: Optional[BaseException] = None

    @staticmethod
    def of_image(image: np.ndarray) -> "DecodeOutcome":
        return DecodeOutcome(DecodeOutcome.IMAGE, image=image)

    @staticmethod
    def of_skip(exc: BaseException) -> "DecodeOutcome":
        return DecodeOutcome(DecodeOutcome.SKIP, error=exc,
                             reason=f"{type(exc).__name__}: {exc}")

    @staticmethod
    def of_error(exc: BaseException) -> "DecodeOutcome":
        return DecodeOutcome(DecodeOutcome.ERROR, error=exc,
                             reason=f"{type(exc).__name__}: {exc}")

    @property
    def ok(self) -> bool:
        return self.kind == DecodeOutcome.IMAGE

    def unwrap(self) -> np.ndarray:
        """The image, or re-raise the skip/error exception."""
        if self.kind == DecodeOutcome.IMAGE:
            return self.image
        raise self.error


def outcome_of(result) -> DecodeOutcome:
    """Classify one entry of a registered batch_fn's arrays-or-exceptions
    list into the typed outcome (the registration-level convention stays
    exception-based; sessions translate at the boundary)."""
    if isinstance(result, UnsupportedJpeg):
        return DecodeOutcome.of_skip(result)
    if isinstance(result, BaseException):
        return DecodeOutcome.of_error(result)
    return DecodeOutcome.of_image(result)
