"""Capability-typed decoder API (see DESIGN.md §6).

The decode surface in three layers:

* **capabilities** — ``Capabilities`` (what a decoder is), ``ExecContext``
  (where it runs), and ``eligible(caps, context)``: the single resolver
  that owns every eligibility rule.
* **registry** — ``@register_decoder`` / ``register_decoder(...)`` plug
  new decoders into the full protocol matrix (bench cells, loader,
  service router arms) with no other file changing; ``get_decoder`` /
  ``list_decoders`` / ``decoder_names`` query it.
* **sessions** — ``open_decoder(name, context=...)`` returns a
  ``Decoder`` with ``decode``/``decode_batch`` (typed ``DecodeOutcome``s:
  image | skip | error), ``probe`` (headers-only bucket key), ``warmup``,
  ``close``, and context-manager support.

``repro_torch.jpeg.paths`` registers the port's built-in decode paths
here: the numpy family, the ``torch-*`` paths and the ``cuda-*`` paths.
"""
from repro_torch.codecs.capabilities import (Capabilities, Eligibility,
                                             ExecContext, eligible,
                                             resolve_entropy_workers)
from repro_torch.codecs.outcome import DecodeOutcome, outcome_of
from repro_torch.codecs.probe import (BucketKey, ProbeResult, probe_key,
                                      probe_outcome)
from repro_torch.codecs.registry import (DecoderSpec, as_spec,
                                         decoder_names, get_decoder,
                                         list_decoders, register_decoder,
                                         unregister_decoder)
from repro_torch.codecs.session import Decoder, IneligibleDecoder, open_decoder

__all__ = [
    "Capabilities", "Eligibility", "ExecContext", "eligible",
    "resolve_entropy_workers",
    "DecodeOutcome", "outcome_of",
    "BucketKey", "ProbeResult", "probe_key", "probe_outcome",
    "DecoderSpec", "as_spec", "decoder_names", "get_decoder",
    "list_decoders", "register_decoder", "unregister_decoder",
    "Decoder", "IneligibleDecoder", "open_decoder",
]
