"""JPEG codec substrate of the port: parser, entropy decode, encoder,
synthetic corpus, transform pipeline and the decode-path registrations
(``repro_torch.jpeg.paths``, imported lazily by the codecs registry).
``UnsupportedJpeg`` re-exports eagerly; the legacy ``DECODE_PATHS``/
``get_path`` shims resolve lazily (PEP 562) so importing this package
never drags in the decode-path registrations, which would cycle with
``repro_torch.codecs``, the registry they live in."""
from repro_torch.jpeg.parser import UnsupportedJpeg

__all__ = ["DECODE_PATHS", "get_path", "UnsupportedJpeg"]


def __getattr__(name):
    if name in ("DECODE_PATHS", "get_path"):
        from repro_torch.jpeg import paths
        return getattr(paths, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
