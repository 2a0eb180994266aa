#!/usr/bin/env python3
"""What a loader decoding beside the trainer costs the trainer's step.

    PYTHONPATH=src python3 tools/probe_train_contention.py [--steps 6]

ViT-100m in float32 (``repro_torch.train.vision_pipeline``, batch 16,
64x64) takes ``--steps`` train steps on one batch already on the card,
each timed on the host clock and synchronised, while one background
load runs in the same process:

* ``none``;
* ``busy-loop``: one thread spinning in pure Python (the interpreter
  lock alone: no decode, no CUDA);
* ``numpy-fast x2``: a ``numpy-fast`` loader in two threads decoding
  the ImageNet-val-sized images of ``chip_smoke.py`` (the port's
  ``build_corpus``, seed 0) without end (the lock and host work, no
  CUDA);
* ``cuda-batch x2`` and ``x1``: a ``cuda-batch`` loader, chunks of 8,
  in two threads and in one (the lock, host work, and CUDA copies and
  launches from the loader's threads);
* ``cuda-batch x2, 0.5 ms``: the same at a 0.5 ms interpreter switch
  interval.

Prints one JSON line per load (step ms: mean, min, max; images the load
decoded per second) and the card's name and power limit. Needs a card.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (500, 500)]


def _busy(stop: threading.Event, counter: dict) -> None:
    n = 0
    while not stop.is_set():
        n += 1
    counter["spins"] = n


def _decode(loader, stop: threading.Event, counter: dict) -> None:
    while not stop.is_set():
        for batch in loader:
            counter["images"] += batch["image"].shape[0]
            if stop.is_set():
                break


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_train_contention: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.codecs import open_decoder
    from repro_torch.data.loader import DataLoader, LoaderConfig, center_fit
    from repro_torch.jpeg.corpus import build_corpus
    from repro_torch.train import vision_pipeline as vp
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    corpus = build_corpus(33, seed=0, sizes=SIZES)
    outs = open_decoder("cuda-batch").decode_batch(corpus.files[:vp.BATCH])
    batch = {"image": torch.from_numpy(np.stack(
                 [center_fit(o.image, 64, 64) for o in outs])).to(dev),
             "label": torch.tensor(corpus.labels[:vp.BATCH],
                                   dtype=torch.int32, device=dev)}
    cfg = vp.MODELS["100m"]
    state = vp.init_state(cfg, 0, dev)
    for _ in range(2):                   # cuBLAS handles, first launches
        state, _ = vp.train_step(state, batch, cfg, vp.OPT, vp.CTX)
    torch.cuda.synchronize()

    def loader(path, workers):
        return DataLoader(corpus.files, corpus.labels, cfg=LoaderConfig(
            batch_size=vp.BATCH, num_workers=workers,
            decode_batch=8 if path == "cuda-batch" else 0), path_name=path)

    loads = [("none", None, None), ("busy-loop", "busy", None),
             ("numpy-fast x2", "numpy-fast", 2),
             ("cuda-batch x2", "cuda-batch", 2),
             ("cuda-batch x1", "cuda-batch", 1),
             ("cuda-batch x2, 0.5 ms", "cuda-batch", 2)]
    default_interval = sys.getswitchinterval()
    for label, path, workers in loads:
        stop = threading.Event()
        counter = {"images": 0}
        thread = None
        if path == "busy":
            thread = threading.Thread(target=_busy, args=(stop, counter))
        elif path is not None:
            thread = threading.Thread(target=_decode, args=(
                loader(path, workers), stop, counter))
        if label.endswith("0.5 ms"):
            sys.setswitchinterval(5e-4)
        try:
            if thread is not None:
                thread.start()
                time.sleep(1.0)          # the load reaches its steady state
            t0 = time.perf_counter()
            start_images = counter["images"]
            steps = []
            for _ in range(args.steps):
                ts = time.perf_counter()
                state, _ = vp.train_step(state, batch, cfg, vp.OPT, vp.CTX)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - ts) * 1e3)
            wall = time.perf_counter() - t0
            images = counter["images"] - start_images
        finally:
            stop.set()
            if thread is not None:
                thread.join(timeout=120)
            sys.setswitchinterval(default_interval)
        print(json.dumps({"load": label, "step_ms_mean": float(np.mean(steps)),
                          "step_ms_min": min(steps), "step_ms_max": max(steps),
                          "load_images_s": images / wall, "steps": args.steps,
                          "thread_ended": thread is None or
                          not thread.is_alive()}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
