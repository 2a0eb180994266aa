"""The two evaluation protocols + the worker sweep (paper §3).

``SingleThreadProtocol`` — the common shortcut: tight-loop decode of the
in-memory corpus, one process, one thread.

``LoaderProtocol`` — the deployment-matched protocol: the same corpus
through the multi-worker DataLoader, measuring delivered batch throughput
and skip accounting.

``WorkerSweep`` — LoaderProtocol over worker counts {0,2,4,8}.

Decoders come from the ``repro_torch.codecs`` registry (``run_path`` accepts a
registered name, a ``DecoderSpec``, or a legacy path object); eligibility
of a (decoder, context) pairing is decided exclusively by the
``codecs.eligible`` resolver — an ineligible cell emits a schema-v2
``status="skipped"`` record, never a fake 0.0-img/s sample.

All protocols emit schema.RunRecord JSON; analysis (rank moves, Spearman,
tiers) runs downstream on records only — identical for live and recorded
(paper) data.

In the port, every decode runs on the device selected where a protocol
runs (``repro_torch.device``: the card unless the caller asked for the
CPU; the loader carries it into its worker threads). Every path returns
host uint8 arrays, so a timed pass ends after the card's work for it.
``platform`` labels the records: the card's name where the card is
measured (``torch.cuda.get_device_name(0)``).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set

import numpy as np

from repro_torch.codecs import (ExecContext, as_spec, decoder_names,
                                eligible, open_decoder)
from repro_torch.core.schema import RunRecord
from repro_torch.data.loader import DataLoader, LoaderConfig
from repro_torch.jpeg.corpus import Corpus


def _thr_samples(fn, n_items: int, repeats: int) -> List[float]:
    """Timed passes with a fixed per-pass item count (loader protocol:
    every pass offers the whole corpus). The single-thread protocol
    deliberately does NOT use this — it counts per-pass delivery."""
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        out.append(n_items / dt if dt > 0 else 0.0)
    return out


def _loader_context(mode: str, workers: int) -> ExecContext:
    if workers == 0:
        return ExecContext.INLINE
    return (ExecContext.PROCESS_POOL if mode == "process"
            else ExecContext.THREAD_POOL)


class SingleThreadProtocol:
    def __init__(self, corpus: Corpus, *, repeats: int = 3,
                 warmup: bool = True, platform: str = "live-host",
                 corpus_kind: str = "baseline"):
        self.corpus = corpus
        self.repeats = repeats
        self.warmup = warmup
        self.platform = platform
        # corpus-distribution axis label (baseline | mixed | progressive).
        # "progressive" — every non-rare image is SOF2 — additionally
        # gates run_path on Capabilities.progressive: a baseline-only
        # decoder would deliver nothing, so the cell resolves to one
        # schema-v2 skip record instead of a 0-throughput measurement.
        # A "mixed" corpus still runs everywhere: baseline-only paths
        # deliver the baseline majority and record per-image skips.
        self.corpus_kind = corpus_kind

    def run_path(self, path, entropy_workers: int = 0) -> RunRecord:
        spec = as_spec(path)
        verdict = eligible(spec.caps, ExecContext.INLINE,
                           requires_progressive=(
                               self.corpus_kind == "progressive"))
        if not verdict:
            # the schema-v2 skip envelope (same shape as LoaderProtocol's)
            return RunRecord(
                platform=self.platform, decoder=spec.name,
                protocol="single_thread", workers=0, mode="",
                throughput_mean=0.0, throughput_std=0.0, samples=[],
                num_images=len(self.corpus.files),
                meta={"status": "skipped", "eligible": False,
                      "reason": verdict.reason,
                      "engine": spec.caps.engine,
                      "strict": spec.caps.strict,
                      "corpus": self.corpus_kind})
        files = self.corpus.files
        skips: Set[int] = set()

        stats0 = {}
        if entropy_workers > 0:
            from repro_torch.jpeg import huffman
            stats0 = huffman.entropy_stats()
        with open_decoder(spec, context=ExecContext.INLINE,
                          entropy_workers=entropy_workers) as dec:
            def one_pass() -> int:
                delivered = 0
                for i, f in enumerate(files):
                    if dec.decode(f).ok:
                        delivered += 1
                    else:
                        skips.add(i)
                return delivered

            if self.warmup:
                one_pass()      # jit-cache warm (paper: steady-state decode)
            samples: List[float] = []
            delivered = 0
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                # throughput counts what THIS pass delivered: without a
                # warmup pass the old len(files) - len(skips) was computed
                # before any skip was discovered, overstating strict paths
                # on the first timed pass
                delivered = one_pass()
                dt = time.perf_counter() - t0
                samples.append(delivered / dt if dt > 0 else 0.0)
        meta = {"engine": spec.caps.engine, "strict": spec.caps.strict,
                "delivered": delivered}
        if entropy_workers > 0:
            # the entropy axis is never silent: record what was requested,
            # what the resolver granted, and what decode actually did
            # (parallel vs recorded serial fallbacks) over this cell
            from repro_torch.jpeg import huffman
            delta = {k: v - stats0.get(k, 0)
                     for k, v in huffman.entropy_stats().items()
                     if v - stats0.get(k, 0)}
            meta["entropy"] = {"requested": entropy_workers,
                               "workers": dec.entropy_workers,
                               "demotion": dec.entropy_demotion,
                               "decodes": delta}
        return RunRecord(
            platform=self.platform, decoder=spec.name,
            protocol="single_thread", workers=0, mode="",
            throughput_mean=float(np.mean(samples)),
            throughput_std=float(np.std(samples, ddof=1))
            if len(samples) > 1 else 0.0,
            samples=samples, num_images=len(files),
            skip_indices=sorted(skips),
            meta=meta)

    def run(self, paths: Optional[Sequence[str]] = None) -> List[RunRecord]:
        names = paths or decoder_names()
        return [self.run_path(n) for n in names]


class LoaderProtocol:
    """The deployment-matched protocol, over either data source.

    By default the corpus is consumed from memory (the paper's setup).
    Passing ``source=`` (any ``repro_torch.store.ByteSource``, e.g. a
    mmap-backed ``ShardSource``) measures the same decoder matrix
    storage-backed; ``source_name`` labels the axis in emitted records.
    """

    def __init__(self, corpus: Corpus, *, repeats: int = 2,
                 batch_size: int = 16, mode: str = "thread",
                 platform: str = "live-host", warmup: bool = True,
                 source=None, source_name: str = "memory"):
        self.corpus = corpus
        self.repeats = repeats
        self.batch_size = batch_size
        self.mode = mode
        self.platform = platform
        self.warmup = warmup
        self.source = source
        self.source_name = source_name if source is not None else "memory"

    def _loader(self, spec, workers: int) -> DataLoader:
        cfg = LoaderConfig(batch_size=self.batch_size, num_workers=workers,
                           mode=self.mode)
        if self.source is not None:
            return DataLoader(self.source, None, spec.fn, cfg,
                              path_name=spec.name,
                              batch_decode_fn=spec.decode_batch)
        return DataLoader(self.corpus.files, self.corpus.labels,
                          spec.fn, cfg, path_name=spec.name,
                          batch_decode_fn=spec.decode_batch)

    def run_path(self, path, workers: int) -> RunRecord:
        spec = as_spec(path)
        verdict = eligible(spec.caps, _loader_context(self.mode, workers))
        if not verdict:
            # the schema-v2 skip envelope: aggregators filter on status
            # and never see a fake 0.0-img/s sample for this cell
            return RunRecord(
                platform=self.platform, decoder=spec.name,
                protocol="dataloader", workers=workers, mode=self.mode,
                throughput_mean=0.0, throughput_std=0.0, samples=[],
                num_images=self._num_images(),
                meta={"status": "skipped", "eligible": False,
                      "reason": verdict.reason,
                      "engine": spec.caps.engine,
                      "strict": spec.caps.strict,
                      "source": self.source_name})
        if self.warmup:
            for _ in self._loader(spec, 0):
                pass

        def one_pass():
            loader = self._loader(spec, workers)
            n = 0
            for batch in loader:
                n += batch["image"].shape[0]
            one_pass.skips = loader.ledger.indices()
            one_pass.n = n
            one_pass.loader_stats = loader.stats()
            loader.close()

        one_pass()
        samples = _thr_samples(one_pass, self._num_images(),
                               self.repeats)
        return RunRecord(
            platform=self.platform, decoder=spec.name,
            protocol="dataloader", workers=workers, mode=self.mode,
            throughput_mean=float(np.mean(samples)),
            throughput_std=float(np.std(samples, ddof=1))
            if len(samples) > 1 else 0.0,
            samples=samples, num_images=self._num_images(),
            skip_indices=one_pass.skips,
            meta={"engine": spec.caps.engine, "strict": spec.caps.strict,
                  "eligible": True, "delivered": one_pass.n,
                  "source": self.source_name,
                  "loader": one_pass.loader_stats})

    def _num_images(self) -> int:
        return (len(self.source) if self.source is not None
                else len(self.corpus.files))


class WorkerSweep:
    WORKERS = (0, 2, 4, 8)

    def __init__(self, corpus: Corpus, **kw):
        self.loader = LoaderProtocol(corpus, **kw)

    def run(self, paths: Optional[Sequence[str]] = None,
            workers: Sequence[int] = WORKERS) -> List[RunRecord]:
        names = paths or decoder_names()
        out = []
        for n in names:
            for w in workers:
                out.append(self.loader.run_path(n, w))
        return out
