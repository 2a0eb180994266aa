"""The paper's own workload configuration (not an LM arch): the benchmark
matrix of 'Single-Thread JPEG Decoder Benchmarks Mis-Evaluate ML Data
Loaders' — corpus shape, protocols, worker counts, thresholds.

Scaled to this host by default; `imagenet_val()` is the paper-exact setting
for a machine that has the real split available.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PaperWorkloadConfig:
    corpus_size: int = 200                  # paper: 50_000 (ImageNet-val)
    rare_index_source: int = 19876          # scaled into corpus_size
    worker_counts: Tuple[int, ...] = (0, 2, 4, 8)
    single_thread_repeats: int = 3
    loader_repeats: int = 2
    batch_size: int = 16
    loader_mode: str = "thread"             # thread | process (paper: fork)
    single_thread_threshold: float = 0.01   # practical significance
    dataloader_threshold: float = 0.05
    practical_floor: float = 0.90
    memory_mode: bool = True                # decode from RAM (paper default)


DEFAULT = PaperWorkloadConfig()


def imagenet_val() -> PaperWorkloadConfig:
    return dataclasses.replace(DEFAULT, corpus_size=50000)
