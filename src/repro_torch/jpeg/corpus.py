"""Synthetic ImageNet-val-like JPEG corpus (in-memory benchmark workload).

The paper's workload is the 50k-image ImageNet validation split decoded from
memory. Offline here, we synthesize a deterministic corpus with matched
*structure*: mixed resolutions, quality spread, 4:2:0/4:4:4 subsampling, and
exactly one rare Adobe-YCCK 4-component JPEG at the scaled analogue of
ImageNet-val index 19876 — the image every strict decoder skips (paper
section 4.4). Images are natural-ish (band-limited fields + texture noise)
so entropy-coded sizes and coefficient sparsity resemble photographic JPEGs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.jpeg import encoder

RARE_INDEX_IMAGENET = 19876
IMAGENET_VAL_SIZE = 50000


@dataclasses.dataclass
class Corpus:
    files: List[bytes]
    labels: np.ndarray
    rare_index: int
    sizes: List[Tuple[int, int]]
    # indices encoded as progressive (SOF2) streams; empty for the
    # default baseline-only corpus
    progressive_indices: List[int] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.files)


def natural_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for _ in range(4):
        fy, fx = rng.uniform(0.01, 0.2, size=2)
        ph, amp = rng.uniform(0, 6.28), rng.uniform(20, 70)
        base = np.sin(yy * fy + xx * fx + ph)
        img += amp * base[..., None] * rng.uniform(0.3, 1.0, size=3)
    img += 128.0
    img += rng.randn(h, w, 3) * rng.uniform(2, 10)
    return np.clip(img, 0, 255).astype(np.uint8)


def scaled_rare_index(n: int) -> int:
    """Scale ImageNet index 19876/50000 into an n-image corpus."""
    return int(RARE_INDEX_IMAGENET / IMAGENET_VAL_SIZE * n)


def zipf_indices(n_items: int, n_requests: int,
                 seed: int = 0) -> np.ndarray:
    """Zipf-ish request mix over a corpus: a hot set dominates — the
    online-service traffic model used by the decode-service demo and
    benchmark."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    return rng.choice(n_items, size=n_requests, p=probs)


def build_corpus(n: int = 200, *, seed: int = 0,
                 sizes: Optional[List[Tuple[int, int]]] = None,
                 num_classes: int = 10,
                 restart_intervals: Optional[List[int]] = None,
                 qualities: Optional[List[int]] = None,
                 subsamplings: Optional[List[str]] = None,
                 size_weights: Optional[List[float]] = None,
                 progressive: float = 0.0,
                 progressive_scans: str = "standard") -> Corpus:
    """Distribution knobs (every knob is RNG-stream-neutral when unset:
    leaving it at its default draws nothing extra, so the corpus
    fingerprint of existing profiles never moves):

    * ``restart_intervals`` sweeps DRI density: each non-rare image draws
      its restart interval (in MCUs; 0 = no DRI) uniformly from the pool
      — how the quick bench profile synthesizes the DRI-dense corpus the
      interval-parallel entropy axis needs.
    * ``qualities`` replaces the default quality pool
      ``[60, 75, 85, 92, 95]`` (uniform draw either way — one draw per
      non-rare image, so ``None`` keeps the stream).
    * ``subsamplings`` replaces the default 70/30 420-vs-444 Bernoulli
      draw with a uniform draw over the given pool (one draw either way).
    * ``size_weights`` replaces the uniform size draw with a weighted one
      (``p=`` normalized over the size pool; must match its length).
    * ``progressive`` is the per-image probability of encoding a non-rare
      image as a progressive (SOF2) stream with scan script
      ``progressive_scans``; the draw is guarded so ``0.0`` consumes no
      randomness. Progressive members are recorded on
      ``Corpus.progressive_indices``. The rare YCCK image stays baseline
      regardless, so the strict-skip anchor never aliases the
      progressive-capability skip axis.
    """
    rng = np.random.RandomState(seed)
    size_pool = sizes or [(64, 64), (64, 96), (96, 96), (96, 128),
                          (128, 128)]
    ri_pool = list(restart_intervals) if restart_intervals else []
    q_pool = list(qualities) if qualities else [60, 75, 85, 92, 95]
    if size_weights is not None:
        if len(size_weights) != len(size_pool):
            raise ValueError(
                f"size_weights has {len(size_weights)} entries for "
                f"{len(size_pool)} sizes")
        w_arr = np.asarray(size_weights, dtype=np.float64)
        size_p = w_arr / w_arr.sum()
    else:
        size_p = None
    rare = scaled_rare_index(n)
    files, dims = [], []
    prog_indices: List[int] = []
    labels = rng.randint(0, num_classes, size=n)
    for i in range(n):
        if size_p is None:
            si = int(rng.randint(len(size_pool)))
        else:
            si = int(rng.choice(len(size_pool), p=size_p))
        h, w = size_pool[si]
        img = natural_image(rng, h, w)
        if i == rare:
            files.append(encoder.encode_jpeg_ycck(img, quality=88))
        else:
            q = int(rng.choice(q_pool))
            if subsamplings:
                sub = str(subsamplings[int(rng.randint(len(subsamplings)))])
            else:
                sub = "420" if rng.rand() < 0.7 else "444"
            ri = (int(ri_pool[int(rng.randint(len(ri_pool)))])
                  if ri_pool else 0)
            # guarded draw: progressive=0.0 consumes no randomness
            prog = progressive > 0.0 and float(rng.rand()) < progressive
            if prog:
                prog_indices.append(i)
            files.append(encoder.encode_jpeg(img, quality=q,
                                             subsampling=sub,
                                             restart_interval=ri,
                                             progressive=prog,
                                             scan_script=progressive_scans))
        dims.append((h, w))
    return Corpus(files=files, labels=labels, rare_index=rare, sizes=dims,
                  progressive_indices=prog_indices)

