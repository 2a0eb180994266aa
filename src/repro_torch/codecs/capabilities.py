"""Capability typing and the single eligibility resolver.

The paper's core claim is that decoder *eligibility and rank are
properties of the deployment context*, not of the decoder alone. This
module gives that claim a type system:

* ``Capabilities`` — what a decoder **is** (transform engine, strictness
  policy, fork-safety, batch support, headers-only probing). Declared
  once at registration, immutable afterwards.
* ``ExecContext`` — where a decoder **runs** (inline tight loop, thread
  pool, forked process pool, online service).
* ``eligible(caps, context)`` — the one function that owns every
  eligibility rule. Before this existed the fork-safety rule was
  re-checked by hand in four modules (``data/loader.py``,
  ``core/protocols.py``, ``service/router.py``, ``bench/registry.py``);
  now a rule change is one edit and every harness inherits it.

The current rule set (see DESIGN.md §6):

* ``PROCESS_POOL`` requires ``fork_safe``. A CUDA context does not
  survive ``fork()`` — the child inherits a driver handle it may not
  use, and its first CUDA call fails — so only pure numpy/CPython
  decoders may run under forked workers. This is the repo's analogue of
  the paper's "PyVips is not loader-eligible under this forked harness".
* ``INLINE``, ``THREAD_POOL``, and ``SERVICE`` admit every decoder:
  numpy and torch release the GIL around their kernels, so in-process
  contexts carry no fork hazard.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple


class ExecContext(enum.Enum):
    """Where a decoder session executes — the paper's deployment axis."""

    INLINE = "inline"            # tight loop in the caller (single-thread
                                 # protocol, w=0 loader, w=0 service)
    THREAD_POOL = "thread_pool"  # in-process worker threads (GIL-releasing)
    PROCESS_POOL = "process_pool"  # forked/spawned worker processes
    SERVICE = "service"          # the online micro-batching engine

    def __str__(self) -> str:  # readable in skip reasons and error messages
        return self.value


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a decoder declares about itself at registration time.

    ``fork_safe`` left unset derives from the engine (DESIGN.md §6 rule:
    only pure-numpy decoders touch no CUDA context) — so an explicit
    ``Capabilities(engine="cuda")`` is fork-UNsafe by default rather than
    silently process-pool eligible; pass ``fork_safe=True`` to override.
    """

    engine: str = "numpy"            # transform engine: numpy | torch | cuda
    strict: bool = False             # refuses rare JPEG modes (skip policy)
    fork_safe: Optional[bool] = None  # survives fork/spawn pool workers
                                      # (None: derived from engine)
    batchable: bool = False          # has a true batched decode (one fused
                                     # launch per same-structure group)
    headers_only_probe: bool = True  # bucket key derivable without the
                                     # O(file-size) entropy scan
    parallel_entropy: bool = False   # honors the interval-parallel
                                     # entropy_workers knob (decodes DRI
                                     # segments concurrently; see
                                     # DESIGN.md §10)
    progressive: bool = False        # decodes SOF2 multi-scan streams
                                     # (baseline-only surfaces skip them;
                                     # see DESIGN.md §11)

    def __post_init__(self):
        if self.fork_safe is None:
            object.__setattr__(self, "fork_safe", self.engine == "numpy")


@dataclasses.dataclass(frozen=True)
class Eligibility:
    """Resolver verdict: truthy iff eligible; ``reason`` explains a veto
    in the words that end up in skip records and error messages."""

    eligible: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.eligible


def eligible(caps: Capabilities, context: ExecContext, *,
             requires_progressive: bool = False) -> Eligibility:
    """THE eligibility rule — every harness asks here, nobody re-derives.

    Returns a truthy ``Eligibility`` or a falsy one whose ``reason`` is
    the canonical explanation (it is stored verbatim in skipped bench
    records and raised in loader errors).

    ``requires_progressive=True`` adds the workload axis: the caller is
    about to feed SOF2 streams wholesale (a progressive-corpus bench
    cell), so a baseline-only decode surface is vetoed up front instead
    of skipping every image one by one.
    """
    if not isinstance(context, ExecContext):
        raise TypeError(f"context must be an ExecContext, got {context!r}")
    if context is ExecContext.PROCESS_POOL and not caps.fork_safe:
        return Eligibility(
            False,
            f"not process-loader eligible: engine {caps.engine!r} is not "
            "fork-safe (a CUDA context does not survive forked workers; "
            "see DESIGN.md §6)")
    if requires_progressive and not caps.progressive:
        return Eligibility(
            False,
            "not progressive-corpus eligible: decoder does not advertise "
            "Capabilities.progressive (baseline-only decode surface; "
            "see DESIGN.md §11)")
    return Eligibility(True)


def resolve_entropy_workers(caps: Capabilities, context: ExecContext,
                            requested: int) -> Tuple[int, str]:
    """Resolve a requested interval-parallel ``entropy_workers`` count
    for a (capabilities, context) pairing — the entropy analogue of
    ``eligible``, and like it the ONLY place these rules live.

    Returns ``(effective_workers, reason)``; ``reason`` is non-empty iff
    the request was demoted (it lands verbatim in session/loader stats
    and bench record meta, so a demotion is visible, never silent).

    Rules (DESIGN.md §10): the decoder must advertise
    ``parallel_entropy``; decode running inside forked pool workers
    (``PROCESS_POOL``) may not fork a nested segment executor; and a
    single-CPU host is capped to serial — segment decode is CPU-bound,
    so oversubscribing one core only adds dispatch overhead. Requests
    above the host CPU count are clamped to it.
    """
    if not isinstance(context, ExecContext):
        raise TypeError(f"context must be an ExecContext, got {context!r}")
    requested = int(requested)
    if requested <= 1:
        return max(requested, 1), ""
    if not caps.parallel_entropy:
        return 1, ("decoder does not advertise parallel_entropy; "
                   "segment-parallel decode demoted to serial")
    if context is ExecContext.PROCESS_POOL:
        return 1, ("process-pool workers may not fork a nested entropy "
                   "executor; demoted to serial in-worker decode")
    cpus = os.cpu_count() or 1
    if cpus <= 1:
        return 1, "single-CPU host: segment-parallel decode has no cores to use"
    if requested > cpus:
        return cpus, (f"entropy_workers={requested} clamped to "
                      f"{cpus} host CPUs")
    return requested, ""
