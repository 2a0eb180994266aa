"""Real decoder backends as out-of-tree-style plugins (ROADMAP item).

Pillow (libjpeg/libjpeg-turbo via PIL) and OpenCV (cv2.imdecode) join
the registry through the same ``register_decoder`` door a third-party
package would use — nothing in the bench/loader/service stack names
them. With the *full* bench profile left open (``None`` = every
registered decoder), their single-thread and loader cells appear with no
other file changing; smoke/quick profiles select by the built-in engine
families and therefore skip them explicitly.

Both are plain C extensions holding no CUDA context, hence
``fork_safe=True``: they are process-pool eligible, the very context the
forked harness denies to the ``torch``/``cuda`` paths. The two libraries
are the same as the reference package's plugins wrap, and so are the
names: each package's registry holds its own registration of them.
Missing dependencies
degrade gracefully — the module imports fine, registers nothing, and
``available()`` reports what made it in.

Exception policy at the registration boundary: decode failures surface
as ``CorruptJpeg`` (bad input) or ``UnsupportedJpeg`` (backend refused a
mode, e.g. cv2 returning None for exotic color transforms), so skip
accounting and the service's strict-refusal rerouting treat these
backends exactly like the built-ins.
"""
from __future__ import annotations

import io
from typing import Tuple

import numpy as np

from repro_torch.codecs.capabilities import Capabilities
from repro_torch.codecs.registry import register_decoder
from repro_torch.jpeg.parser import CorruptJpeg, UnsupportedJpeg

_REGISTERED = []


def _register_pillow() -> bool:
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        return False

    def decode(data) -> np.ndarray:
        try:
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"), np.uint8)
        except UnidentifiedImageError as e:
            raise CorruptJpeg(f"pillow: {e}") from e
        except OSError as e:
            raise CorruptJpeg(f"pillow: {e}") from e

    register_decoder(
        "pillow", decode,
        caps=Capabilities(engine="pillow", strict=False, fork_safe=True,
                          progressive=True),
        description="Pillow (libjpeg) — real-backend contrib plugin")
    _REGISTERED.append("pillow")
    return True


def _register_opencv() -> bool:
    try:
        import cv2
    except ImportError:
        return False

    def decode(data) -> np.ndarray:
        buf = np.frombuffer(data, np.uint8)
        if buf.size == 0:
            raise CorruptJpeg("opencv: empty input")
        try:
            bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        except cv2.error as e:
            raise CorruptJpeg(f"opencv: {e}") from e
        if bgr is None:
            # cv2 signals both corrupt input and refused JPEG modes by
            # returning None; treat it as a refusal so the item lands in
            # skip accounting instead of killing a worker
            raise UnsupportedJpeg("opencv: imdecode returned no image")
        if bgr.ndim == 2:
            bgr = np.repeat(bgr[:, :, None], 3, axis=2)
        return np.ascontiguousarray(bgr[:, :, ::-1], dtype=np.uint8)

    register_decoder(
        "opencv", decode,
        caps=Capabilities(engine="opencv", strict=False, fork_safe=True,
                          progressive=True),
        description="OpenCV imdecode — real-backend contrib plugin")
    _REGISTERED.append("opencv")
    return True


def available() -> Tuple[str, ...]:
    """Names of the contrib backends that actually registered."""
    return tuple(_REGISTERED)


_register_pillow()
_register_opencv()
