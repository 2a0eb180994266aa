"""The decoder plugin registry: the full protocol matrix as a plug point.

A decoder registered here — via the ``@register_decoder`` decorator or a
programmatic call — automatically joins every consumer of the matrix:
the bench scenario registry emits cells for it, the loader and both
evaluation protocols can run it, and the service router takes it as a
bandit arm. No other file changes; that is the acceptance criterion this
module exists for (the paper evaluates a thirteen-decoder surface, and
new backends must compose the same way).

Registration-level contract (deliberately minimal so out-of-tree
decoders stay easy to write):

* ``fn(data: bytes) -> np.ndarray`` — raise-or-return. ``UnsupportedJpeg``
  means "refused by policy" (skip), ``CorruptJpeg`` means "bad input".
* optional ``batch_fn(datas: list[bytes]) -> list`` — index-aligned
  arrays-or-exceptions (per-item failures never poison batch-mates).

Consumers never touch that convention directly:
``repro_torch.codecs.session`` wraps a registered decoder in a ``Decoder`` session that speaks typed
``DecodeOutcome``s.

The built-in paths register from ``repro_torch.jpeg.paths`` on first
registry access (lazy, so importing ``repro_torch.codecs`` stays cheap and
cycle-free). This registry is the port's own: the reference package's
registry never sees a port decoder, and this one never sees a reference
decoder.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.codecs.capabilities import Capabilities, ExecContext, eligible


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    """One registered decoder: name + capabilities + entry points."""

    name: str
    fn: Callable[[bytes], np.ndarray]
    caps: Capabilities
    batch_fn: Optional[Callable[[List[bytes]], List]] = None
    description: str = ""

    # convenience views (router/report code reads these constantly)
    @property
    def engine(self) -> str:
        return self.caps.engine

    @property
    def strict(self) -> bool:
        return self.caps.strict

    def decode(self, data: bytes) -> np.ndarray:
        """Raw registration-level decode (raise-or-return)."""
        return self.fn(data)

    def decode_batch(self, datas: List[bytes]) -> List:
        """Raw batched decode: index-aligned arrays-or-exceptions.
        Decoders without a ``batch_fn`` fall back to a serial loop, so
        every decoder answers the batch protocol uniformly."""
        if self.batch_fn is not None:
            return self.batch_fn(list(datas))
        out: List = []
        for d in datas:
            try:
                out.append(self.fn(d))
            except Exception as e:
                out.append(e)
        return out


_REGISTRY: Dict[str, DecoderSpec] = {}
# the built-in decode paths live in repro_torch.jpeg.paths and the
# optional real-backend plugins (Pillow/OpenCV) in
# repro_torch.codecs.contrib; both register at import, in that order.
# Importing lazily here breaks the would-be cycle
# (paths -> codecs at import time, codecs -> paths at first use); a
# module already mid-import sits in sys.modules, so no recursion.
_BUILTIN_MODULES = ("repro_torch.jpeg.paths", "repro_torch.codecs.contrib")
# per thread: a first registry read from a second thread (a loader's or
# the service's worker) must not take another thread's import in flight
# for a finished one
_LOADING = threading.local()


def _ensure_builtins() -> None:
    # reentrancy guard: the builtin modules call register_decoder at
    # import, which lands back here — without the guard the first such
    # call would import contrib mid-way through paths' registrations and
    # scramble registration (= bench emission) order across entry points.
    # import_module waits for a module another thread is importing (and
    # returns at once when it is loaded, or mid-import in this thread),
    # so no thread reads a half-filled registry
    if getattr(_LOADING, "active", False):
        return
    _LOADING.active = True
    try:
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)
    finally:
        _LOADING.active = False


def register_decoder(name: str, fn: Optional[Callable] = None, *,
                     caps: Optional[Capabilities] = None,
                     engine: str = "numpy", strict: bool = False,
                     fork_safe: Optional[bool] = None,
                     headers_only_probe: bool = True,
                     parallel_entropy: bool = False,
                     progressive: bool = False,
                     batch_fn: Optional[Callable] = None,
                     description: str = "", replace: bool = False):
    """Register a decoder; usable as a decorator or a direct call.

    Decorator form::

        @register_decoder("my-decoder", engine="numpy")
        def decode(data: bytes) -> np.ndarray: ...

    Direct form::

        register_decoder("my-decoder", decode_fn, engine="torch",
                         batch_fn=batched_fn)

    Pass a full ``caps=Capabilities(...)`` to control every flag, or use
    the keyword shorthands. ``fork_safe`` defaults to the DESIGN.md rule
    (an ``engine == "numpy"`` decoder touches no CUDA context);
    ``batchable`` is inferred from ``batch_fn``. Duplicate names are a
    hard error unless ``replace=True``. Returns the ``DecoderSpec`` (or,
    as a decorator, the undecorated fn, so the symbol stays callable).
    """
    if fn is None:
        def _decorate(f):
            register_decoder(name, f, caps=caps, engine=engine,
                             strict=strict, fork_safe=fork_safe,
                             headers_only_probe=headers_only_probe,
                             parallel_entropy=parallel_entropy,
                             progressive=progressive,
                             batch_fn=batch_fn, description=description,
                             replace=replace)
            return f
        return _decorate
    # load the built-ins BEFORE the duplicate check: otherwise a plugin
    # colliding with a builtin name registers "successfully" and the
    # builtin import then explodes at first registry read, wedging the
    # registry. (No recursion: during the repro_torch.jpeg.paths import
    # itself the module is already in sys.modules.)
    _ensure_builtins()
    if caps is None:
        caps = Capabilities(engine=engine, strict=strict,
                            fork_safe=(engine == "numpy"
                                       if fork_safe is None else fork_safe),
                            batchable=batch_fn is not None,
                            headers_only_probe=headers_only_probe,
                            parallel_entropy=parallel_entropy,
                            progressive=progressive)
    elif caps.batchable != (batch_fn is not None):
        # batchable's ground truth IS the batch entry point: an explicit
        # caps= must not advertise batching it doesn't have (or hide the
        # batch_fn from the bench matrix and warmup) — derive it
        caps = dataclasses.replace(caps, batchable=batch_fn is not None)
    if name in _REGISTRY and not replace:
        raise ValueError(
            f"decoder {name!r} is already registered; pass replace=True "
            "to override it")
    spec = DecoderSpec(name=name, fn=fn, caps=caps, batch_fn=batch_fn,
                       description=description)
    _REGISTRY[name] = spec
    return spec


def unregister_decoder(name: str) -> None:
    """Remove a registered decoder (plugin teardown / test cleanup)."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"decoder {name!r} is not registered")
    del _REGISTRY[name]


def get_decoder(name: str) -> DecoderSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"decoder {name!r} is not registered; known decoders: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def decoder_names() -> List[str]:
    """Registered decoder names, in registration order (the stable
    emission order of the bench scenario matrix)."""
    _ensure_builtins()
    return list(_REGISTRY)


def list_decoders(*, context: Optional[ExecContext] = None,
                  strict: Optional[bool] = None,
                  batchable: Optional[bool] = None,
                  engine: Optional[str] = None) -> List[DecoderSpec]:
    """Query registered decoders (None = any). ``context`` filters through
    the ``eligible`` resolver — the only eligibility authority — e.g.
    ``list_decoders(context=ExecContext.PROCESS_POOL)`` yields the
    decoders a forked deployment may run."""
    _ensure_builtins()
    out = []
    for spec in _REGISTRY.values():
        if context is not None and not eligible(spec.caps, context):
            continue
        if strict is not None and spec.caps.strict != strict:
            continue
        if batchable is not None and spec.caps.batchable != batchable:
            continue
        if engine is not None and spec.caps.engine != engine:
            continue
        out.append(spec)
    return out


def as_spec(path) -> DecoderSpec:
    """Normalize a decoder reference — a registered name, a DecoderSpec,
    or a legacy path-like object (anything with ``.name``/``.fn``) — to a
    DecoderSpec. The escape hatch that lets ad-hoc test decoders flow
    through sessions without registration."""
    if isinstance(path, DecoderSpec):
        return path
    if isinstance(path, str):
        return get_decoder(path)
    if hasattr(path, "name") and hasattr(path, "fn"):
        caps = getattr(path, "caps", None)
        if caps is None:
            caps = Capabilities(
                engine=getattr(path, "engine", "numpy"),
                strict=getattr(path, "strict", False),
                fork_safe=getattr(path, "process_eligible", True),
                batchable=getattr(path, "batch_fn", None) is not None,
                progressive=getattr(path, "progressive", False))
        return DecoderSpec(name=path.name, fn=path.fn, caps=caps,
                           batch_fn=getattr(path, "batch_fn", None),
                           description=getattr(path, "description", ""))
    raise TypeError(f"cannot interpret {path!r} as a decoder")
