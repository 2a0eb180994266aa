"""The scenario registry: the paper's protocol matrix as enumerable data.

Every decoder in the ``repro_torch.codecs`` registry crosses every
evaluation protocol the paper names — single-thread, DataLoader-shaped
worker sweep {0,2,4,8} x {thread, process} pool modes x {memory, shard}
data sources, batched decode, and the online service's closed/open-loop
load models. The matrix is rebuilt from the live registry on every
call, so a decoder plugged in via ``@register_decoder`` gets its cells
with no edit here. A *profile*
(smoke / quick / full) selects which cells actually execute; cells a
profile leaves out are still emitted as explicitly-skipped records, so
every record set answers "was this scenario measured, skipped, or
broken?" for the full matrix — the accounting discipline the paper
argues ad-hoc benchmarks lack.

The port's matrix is the reference's, cell for cell, over the port's
registry (engines ``numpy | torch | cuda``). Where a cell runs is the
sweep's business (``harness.run_sweep(device=...)``: the card unless the
caller asks for the CPU), not the registry's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.codecs import decoder_names, list_decoders

WORKER_SWEEP = (0, 2, 4, 8)
POOL_MODES = ("thread", "process")
# The data-source axis of loader cells: "memory" is the paper's
# decode-from-RAM protocol (and the suffixless scenario name, so compare
# keys stay stable across the axis's introduction); "shard" reads the
# same corpus through the mmap-backed repro_torch.store shard store — the
# deployment-matched source where IO, page cache, and worker reopen
# costs participate. Single-thread cells stay memory-only: that protocol
# is *defined* as from-memory decode.
SOURCES = ("memory", "shard")

KIND_SINGLE = "single_thread"
KIND_LOADER = "dataloader"
KIND_BATCHED = "batched"
KIND_SERVICE_CLOSED = "service_closed"
KIND_SERVICE_OPEN = "service_open"

# Worker count for the parallel leg of the entropy axis: the acceptance
# target is entropy-stage speedup at 4 workers on a DRI-dense corpus
# (the resolver clamps to the host CPU count, so a smaller runner
# measures what it can and records the clamp).
ENTROPY_PARALLEL_WORKERS = 4


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the protocol matrix. ``name`` is the stable compare
    key carried in every emitted record's ``meta.scenario``."""
    name: str
    kind: str
    path: str = ""                 # decode path; "" for service scenarios
    workers: int = 0
    mode: str = ""                 # thread | process for loader cells
    source: str = "memory"         # memory | shard for loader cells
    entropy: str = "serial"        # serial | parallel: the single-thread
                                   # interval-parallel entropy axis
                                   # (suffixless = serial, so existing
                                   # compare keys stay stable)
    corpus: str = "baseline"       # baseline | mixed | progressive: the
                                   # corpus-distribution axis (suffixless
                                   # = baseline, so existing compare keys
                                   # stay stable). Paths that lack
                                   # Capabilities.progressive resolve
                                   # non-baseline cells to schema-valid
                                   # skip records, never errors.


def build_registry() -> List[Scenario]:
    """The full matrix over the live decoder registry, in deterministic
    emission order (decoder registration order)."""
    names = decoder_names()
    batchable = {s.name for s in list_decoders(batchable=True)}
    parallel_entropy = {s.name for s in list_decoders()
                        if s.caps.parallel_entropy}
    out: List[Scenario] = []
    for p in names:
        out.append(Scenario(f"single/{p}", KIND_SINGLE, path=p))
        if p in parallel_entropy:
            # the entropy axis twin: same decode path, entropy decode
            # requested interval-parallel at ENTROPY_PARALLEL_WORKERS
            out.append(Scenario(f"single/{p}/entropy-par", KIND_SINGLE,
                                path=p, entropy="parallel"))
        # the corpus-distribution axis: the same single-thread protocol
        # over a half-progressive ("mixed") and an all-progressive
        # corpus. Emitted for EVERY path — baseline-only paths resolve
        # these cells to capability-skip records, which is the point:
        # the skip ledger, not cell absence, says who measured what.
        for c in ("mixed", "progressive"):
            out.append(Scenario(f"single/{p}/corpus-{c}", KIND_SINGLE,
                                path=p, corpus=c))
    for p in names:
        for w in WORKER_SWEEP:
            # w=0 decodes inline in the consumer; pool mode is moot, so
            # the matrix has one w0 cell per path (thread label).
            modes = ("thread",) if w == 0 else POOL_MODES
            for m in modes:
                for src in SOURCES:
                    suffix = "" if src == "memory" else f"/{src}"
                    out.append(Scenario(
                        f"loader/{p}/w{w}/{m}{suffix}", KIND_LOADER,
                        path=p, workers=w, mode=m, source=src))
    for p in names:
        if p in batchable:
            out.append(Scenario(f"batched/{p}", KIND_BATCHED, path=p))
    for w in WORKER_SWEEP:
        out.append(Scenario(f"service/closed/w{w}", KIND_SERVICE_CLOSED,
                            workers=w, mode="thread"))
    for w in WORKER_SWEEP[1:]:
        out.append(Scenario(f"service/open/w{w}", KIND_SERVICE_OPEN,
                            workers=w, mode="thread"))
    return out


def scenario_names() -> List[str]:
    return [s.name for s in build_registry()]


# ------------------------------------------------------------------ profiles
@dataclasses.dataclass(frozen=True)
class Profile:
    """Execution budget for a sweep: corpus size, repeat counts, and the
    subset of matrix cells that actually run (the rest are emitted as
    explicit skips). A selection set of ``None`` means *every* cell of
    that kind — the full profile stays open so plugin decoders registered
    after import are swept too."""
    name: str
    corpus_n: int
    corpus_seed: int
    st_repeats: int
    loader_repeats: int
    service_requests: int
    batched_requests: int
    single_paths: Optional[FrozenSet[str]]
    loader_cells: Optional[FrozenSet[Tuple[str, int, str, str]]]
    batched_paths: Optional[FrozenSet[str]]
    service_closed: FrozenSet[int]
    service_open: FrozenSet[int]
    budget_s: float                # advisory wall-clock target
    # entropy-axis budget: which paths run the parallel entropy twin
    # (None = all that emit one), and the restart-interval pool the
    # profile's corpus draws from (() = no DRI, so the smoke corpus —
    # and its committed fingerprint — is bit-identical to before)
    single_entropy: Optional[FrozenSet[str]] = frozenset()
    corpus_dri: Tuple[int, ...] = ()
    # corpus-axis budget: which (path, corpus-kind) single-thread cells
    # run over the non-baseline corpora (None = all emitted cells)
    single_corpus: Optional[FrozenSet[Tuple[str, str]]] = frozenset()

    def wants(self, s: Scenario) -> Tuple[bool, str]:
        """(run?, reason-if-skipped) for one scenario under this profile."""
        if s.kind == KIND_SINGLE:
            if s.corpus != "baseline":
                if self.single_corpus is None \
                        or (s.path, s.corpus) in self.single_corpus:
                    return True, ""
            elif s.entropy == "parallel":
                if self.single_entropy is None \
                        or s.path in self.single_entropy:
                    return True, ""
            elif self.single_paths is None or s.path in self.single_paths:
                return True, ""
        elif s.kind == KIND_LOADER:
            if self.loader_cells is None or \
                    (s.path, s.workers, s.mode, s.source) \
                    in self.loader_cells:
                return True, ""
        elif s.kind == KIND_BATCHED:
            if self.batched_paths is None or s.path in self.batched_paths:
                return True, ""
        elif s.kind == KIND_SERVICE_CLOSED:
            if s.workers in self.service_closed:
                return True, ""
        elif s.kind == KIND_SERVICE_OPEN:
            if s.workers in self.service_open:
                return True, ""
        return False, f"not in profile {self.name!r}"


def _paths(*, engines: Optional[Tuple[str, ...]] = None,
           exclude: Tuple[str, ...] = ()) -> FrozenSet[str]:
    return frozenset(
        s.name for s in list_decoders()
        if (engines is None or s.caps.engine in engines)
        and s.name not in exclude)


def _cells(paths, workers, modes,
           sources=("memory",)) -> FrozenSet[Tuple[str, int, str, str]]:
    return frozenset(
        (p, w, m, src) for p in paths for w in workers
        for m in (("thread",) if w == 0 else modes)
        for src in sources)


# The reference's smoke profile leaves its Pallas paths out only because
# interpret mode is slow on a CPU; on the card the cuda-* paths are the
# point, so the port's smoke profile runs every path single-threaded and
# puts cuda-batch wherever the reference puts its jnp representative.
# The quick profile is the reference's with jnp-* read as torch-*.
_SMOKE_SINGLE = _paths(engines=("numpy", "torch", "cuda"))
_QUICK_SINGLE = _paths(engines=("numpy", "torch"),
                       exclude=("torch-basic",))

PROFILES: Dict[str, Profile] = {
    # loader_repeats=2: with the compare step a HARD gate, one-sample
    # loader cells would make the committed baseline a single-draw
    # lottery on shared runners; two samples feed the 2-sigma noise gate.
    "smoke": Profile(
        name="smoke", corpus_n=8, corpus_seed=42,
        st_repeats=2, loader_repeats=2,
        service_requests=16, batched_requests=24,
        single_paths=_SMOKE_SINGLE,
        # the storage-backed cell and its in-memory twin: the pair the
        # acceptance gate compares for byte-identity + measured status
        loader_cells=_cells(("numpy-fast", "cuda-batch"), (0, 2),
                            ("thread",))
        | frozenset({("numpy-fast", 2, "process", "memory"),
                     ("numpy-fast", 2, "process", "shard"),
                     # a CUDA path under the fork harness: the resolver's
                     # skip record, never a fork
                     ("cuda-batch", 2, "process", "memory")}),
        batched_paths=frozenset({"cuda-batch"}),
        service_closed=frozenset({2}),
        service_open=frozenset(),
        budget_s=240.0,
        # smoke keeps its no-DRI corpus (committed fingerprint stays
        # valid); the entropy-par cells therefore exercise and record
        # the serial fallback discipline, not a speedup
        single_entropy=frozenset({"numpy-fast", "cuda-batch"}),
        corpus_dri=(),
        # one ok cell and two capability-skip cells: the artifact set
        # CI validates (mixed corpus decodes on a progressive-capable
        # path; an all-progressive corpus on a strict/baseline-only
        # path must yield schema-valid skip records)
        single_corpus=frozenset({("cuda-fused", "mixed"),
                                 ("strict-fast", "progressive"),
                                 ("strict-cuda", "progressive")})),
    "quick": Profile(
        name="quick", corpus_n=48, corpus_seed=42,
        st_repeats=2, loader_repeats=1,
        service_requests=96, batched_requests=48,
        single_paths=_QUICK_SINGLE,
        loader_cells=_cells(sorted(_QUICK_SINGLE), (0, 2), ("thread",))
        | frozenset({("numpy-fast", 2, "process", "memory"),
                     ("numpy-fast", 2, "process", "shard"),
                     ("numpy-int", 2, "process", "memory")}),
        batched_paths=frozenset({"torch-batch"}),
        service_closed=frozenset({0, 2}),
        service_open=frozenset({2}),
        budget_s=900.0,
        # the DRI-dense corpus the interval-parallel acceptance target
        # is measured on: ~5/6 of images carry restart markers at 2-8
        # MCUs per segment (0 keeps a no-DRI minority so the recorded
        # serial fallback stays exercised too)
        single_entropy=frozenset({"numpy-fast", "torch-fused",
                                  "numpy-sparse"}),
        corpus_dri=(0, 2, 2, 4, 4, 8),
        # the corpus-axis measurement surface: numpy/torch representatives
        # on both corpora plus both strict paths (whose cells are the
        # recorded capability skips the ledger analysis reads)
        single_corpus=frozenset({("numpy-fast", "mixed"),
                                 ("numpy-fast", "progressive"),
                                 ("torch-fused", "mixed"),
                                 ("torch-fused", "progressive"),
                                 ("strict-fast", "mixed"),
                                 ("strict-fast", "progressive"),
                                 ("strict-torch", "mixed")})),
    "full": Profile(
        name="full", corpus_n=200, corpus_seed=42,
        st_repeats=3, loader_repeats=2,
        service_requests=512, batched_requests=192,
        single_paths=None,             # every registered decoder
        loader_cells=None,
        batched_paths=None,
        service_closed=frozenset(WORKER_SWEEP),
        service_open=frozenset(WORKER_SWEEP[1:]),
        budget_s=7200.0,
        single_entropy=None,           # every parallel-entropy decoder
        corpus_dri=(0, 0, 2, 4, 8, 16),
        single_corpus=None),           # every (path, corpus-kind) cell
}


class BenchSelectionError(ValueError):
    """--only named a scenario that does not exist; lists valid names."""


def select_scenarios(only: Optional[List[str]] = None) -> List[Scenario]:
    """Resolve --only tokens to scenarios. A token matches a scenario by
    exact name or as a '/'-boundary prefix (``loader/numpy-fast`` selects
    that path's whole worker sweep). Unknown tokens are a hard error that
    names the valid vocabulary — never a silent no-op.
    """
    registry = build_registry()
    if not only:
        return registry
    selected: List[Scenario] = []
    seen = set()
    for token in only:
        token = token.strip().rstrip("/")
        hits = [s for s in registry
                if s.name == token or s.name.startswith(token + "/")]
        if not hits:
            families = sorted({s.name.split("/")[0] for s in registry})
            raise BenchSelectionError(
                f"unknown scenario {token!r}. Valid families: "
                f"{', '.join(families)}. Valid names include: "
                f"{', '.join(s.name for s in registry[:6])}, ... "
                f"(run `python -m repro_torch.bench list` for all "
                f"{len(registry)} scenarios)")
        for s in hits:
            if s.name not in seen:
                seen.add(s.name)
                selected.append(s)
    return selected
