#!/usr/bin/env python3
"""What the fork-mode loader's scaling costs on this host.

    PYTHONPATH=src python3 tools/probe_fork_scaling.py [--images 16]

The paper's fork harness: a process-mode ``numpy-fast``
``repro_torch.data.DataLoader`` at workers 0, 2, 4 and 8 over the
ImageNet-val-sized images of ``chip_smoke.py`` (the port's
``build_corpus``, seed 0), two passes each, timed on the host clock
with the pool's start included, as ``LoaderProtocol`` times a pass.
Each variant runs in a fresh interpreter, so that its settings hold
before numpy loads:

* BLAS threads: the library's default (one per CPU in each worker, so
  that eight workers start eight times as many BLAS threads as there
  are CPUs) or one (``OPENBLAS_NUM_THREADS`` and its kin set to 1);
* the parent: a plain process, or one that holds a CUDA context (a
  tensor on ``cuda:0``) when it forks, as ``chip_smoke.py`` phase 7 does
  (only where a card is visible).

Prints one JSON line per variant and worker count (pool start seconds,
images/s of each pass), and the card's name and power limit where a
card is visible.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (500, 500)]
WORKERS = (0, 2, 4, 8)
BLAS_VARS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def child(images: int, cuda: bool) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.loader import DataLoader, LoaderConfig
    from repro_torch.jpeg.corpus import build_corpus
    corpus = build_corpus(images, seed=0, sizes=SIZES)
    held = None
    if cuda:
        import torch
        held = torch.zeros(1 << 20, device="cuda")
        torch.cuda.synchronize()
    for w in WORKERS:
        rates, starts = [], []
        for _ in range(2):
            loader = DataLoader(corpus.files, corpus.labels, cfg=LoaderConfig(
                batch_size=16, num_workers=w, mode="process",
                target_hw=(224, 224)), path_name="numpy-fast")
            t0 = time.perf_counter()
            if w:
                loader._ensure_pool()
            t1 = time.perf_counter()
            n = sum(b["image"].shape[0] for b in loader)
            t2 = time.perf_counter()
            loader.close()
            starts.append(t1 - t0)
            rates.append(n / (t2 - t0))
        print(json.dumps({"workers": w, "pool_start_s": starts,
                          "images_s": rates}), flush=True)
    del held


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--cuda", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.images, args.cuda)
        return 0
    card = False
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        card = True
        print("card:", smi)
    except (OSError, subprocess.SubprocessError, IndexError):
        print("card: none visible")
    print(f"host CPUs: os.cpu_count() {os.cpu_count()}, sched_getaffinity "
          f"{len(os.sched_getaffinity(0))}; {args.images} images")
    for blas in ("default", "1"):
        for cuda in ((False, True) if card else (False,)):
            env = dict(os.environ)
            for var in BLAS_VARS:
                env.pop(var, None)
                if blas == "1":
                    env[var] = "1"
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   "--images", str(args.images)] + (["--cuda"] if cuda
                                                    else [])
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=1200)
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            for line in out.stdout.splitlines():
                row = json.loads(line)
                row.update(blas_threads=blas, parent_holds_cuda=cuda)
                print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
