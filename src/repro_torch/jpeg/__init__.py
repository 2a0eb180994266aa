"""JPEG codec substrate of the port: parser, entropy decode, encoder,
synthetic corpus, transform pipeline and the decode-path registrations
(``repro_torch.jpeg.paths``, imported lazily by the codecs registry)."""
from repro_torch.jpeg.parser import UnsupportedJpeg

__all__ = ["UnsupportedJpeg"]
