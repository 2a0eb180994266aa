"""Train the ViT on loader-fed JPEG batches: the deployment the paper's
protocol exists to serve.

Port of the reference's ``examples/train_vision_pipeline.py``. The
loader's worker count is autotuned on this machine first (the paper's
worker sweep as a runtime feature); batches reach the device through
``prefetch_to_device``; the ViT trains in float32 with the reference's
AdamW; checkpoints (model, optimizer and loader state) are written
asynchronously, and a run resumes from the latest one. The report is
the loader's wait against the step time: the input-pipeline share.

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.train.vision_pipeline \\
        [--steps 200] [--model small|100m] [--decoder cuda-batch] \\
        [--decode-batch 8] [--corpus 96] [--ckpt artifacts/...]

On the card both models run every attention through the float32 flash
kernel, one launch per layer per step: ``small`` (head dim 48, the
default) 6, ``--model 100m`` (head dim 64) 12.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.autotune import autotune_workers
from repro_torch.data.loader import (DataLoader, LoaderConfig,
                                     prefetch_to_device)
from repro_torch.device import current_device, use_device
from repro_torch.jpeg.corpus import build_corpus
from repro_torch.models import vision
from repro_torch.models.layers import ModelContext
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)

#: the example's two models (``examples/train_vision_pipeline.py:40-45``)
MODELS = {
    "100m": vision.ViTConfig(d_model=768, num_heads=12, num_kv_heads=12,
                             head_dim=64, d_ff=3072, num_layers=12,
                             num_classes=10),      # ~113.5M parameters
    "small": vision.ViTConfig(d_model=192, num_heads=4, num_kv_heads=4,
                              head_dim=48, d_ff=768, num_layers=6,
                              num_classes=10),
}
OPT = OptimizerConfig(lr=1e-3, warmup_steps=20)
CTX = ModelContext(q_chunk=64, k_chunk=64)
BATCH = 16


def init_state(cfg: vision.ViTConfig, seed: int,
               device: torch.device) -> Dict[str, Any]:
    """Random parameters from ``seed``, zero moments and step 0, made on
    ``device``."""
    params = vision.init(torch.Generator(device=device).manual_seed(seed),
                         cfg)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def loss_and_grads(params, batch, cfg: vision.ViTConfig,
                   ctx: ModelContext) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(metrics {"loss", "acc"}, grads): the forward and ``backward`` of
    ``vision.loss_fn`` at ``params``."""
    leaves = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = vision.loss_fn(leaves, batch, cfg, ctx)
    loss.backward()
    grads = tree.tree_map(lambda p: p.grad, leaves)
    return {k: v.detach() for k, v in metrics.items()}, grads


def train_step(state, batch, cfg: vision.ViTConfig,
               opt_cfg: OptimizerConfig, ctx: ModelContext):
    """One step: forward, backward, AdamW, step + 1. Returns the new
    state and {"loss", "acc", "grad_norm", "lr"} (device tensors)."""
    metrics, grads = loss_and_grads(state["params"], batch, cfg, ctx)
    params, opt, om = adamw_update(grads, state["opt"], state["params"],
                                   state["step"], opt_cfg)
    return ({"params": params, "opt": opt, "step": state["step"] + 1},
            dict(metrics, **om))


def device_batches(loader: DataLoader
                   ) -> Iterator[Tuple[Dict[str, torch.Tensor], dict]]:
    """Endless (batch on the current device, loader state after it):
    epoch after epoch of ``loader`` through ``prefetch_to_device``.

    ``prefetch_to_device`` runs the loader ahead of the consumer, so
    ``loader.state()`` read by the consumer would count batches it has
    not trained on yet; each batch carries the state read when it was
    collated, which is what a checkpoint after that batch must hold."""
    states: collections.deque = collections.deque()

    def host():
        empty = 0        # a restored cursor may leave one empty pass
        while empty < 2:
            empty += 1
            for batch in loader:
                states.append(loader.state())
                empty = 0
                yield batch
        raise ValueError("the loader gives no batch: fewer images than "
                         "a batch, or every image skipped")

    batches = prefetch_to_device(host())
    try:
        for batch in batches:
            yield batch, states.popleft()
    finally:
        batches.close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(state, loader: DataLoader, *, steps: int,
          cfg: vision.ViTConfig, opt_cfg: OptimizerConfig = OPT,
          ctx: ModelContext = CTX,
          mgr: Optional[CheckpointManager] = None, save_every: int = 50,
          log_every: int = 50):
    """Train from ``state`` until its step counter reads ``steps``,
    saving asynchronously every ``save_every`` steps and once at the end.

    Returns (state, report): per step the loss and the labels trained
    on; ``data_s``, the seconds spent waiting for a batch; ``step_s``,
    the seconds of the steps (each synchronised); and the input-pipeline
    share ``data_s / (data_s + step_s)``."""
    device = state["step"].device
    report = {"losses": [], "labels": [], "data_s": 0.0, "step_s": 0.0}
    done = int(state["step"])
    loader_state = None
    batches = device_batches(loader)
    try:
        tb = time.perf_counter()
        while done < steps:
            batch, loader_state = next(batches)
            report["data_s"] += time.perf_counter() - tb
            ts = time.perf_counter()
            state, metrics = train_step(state, batch, cfg, opt_cfg, ctx)
            _sync(device)
            report["step_s"] += time.perf_counter() - ts
            report["losses"].append(float(metrics["loss"]))
            report["labels"].append(batch["label"].cpu().numpy())
            done += 1
            if done % log_every == 0:
                print(f"step {done:4d} loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['acc']):.3f}")
            if mgr is not None and done % save_every == 0 and done < steps:
                mgr.save_async(done, state, extra={"loader": loader_state})
            tb = time.perf_counter()
    finally:
        batches.close()
    if mgr is not None:
        mgr.wait()
        if loader_state is not None:
            mgr.save(done, state, extra={"loader": loader_state})
    busy = report["data_s"] + report["step_s"]
    report["share"] = report["data_s"] / busy if busy else 0.0
    return state, report


def make_loader(corpus, decoder: str, workers: int, decode_batch: int,
                *, shuffle: bool = False) -> DataLoader:
    """A thread-mode loader of ``BATCH`` images at 64x64 over
    ``decoder``, chunked by ``decode_batch`` (0: one image per call).
    The shuffled (training) loader backs up stragglers, as the
    example's does, where it decodes per image: a chunk has no per-item
    backup."""
    return DataLoader(
        corpus.files, corpus.labels,
        cfg=LoaderConfig(batch_size=BATCH, num_workers=workers,
                         decode_batch=decode_batch, shuffle=shuffle,
                         straggler_backup=shuffle and not decode_batch),
        path_name=decoder)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--model", default="small", choices=sorted(MODELS))
    ap.add_argument("--decoder", default="cuda-batch")
    ap.add_argument("--decode-batch", type=int, default=8,
                    help="images per decode_batch call in each loader "
                         "thread (0: one image per call)")
    ap.add_argument("--corpus", type=int, default=96)
    ap.add_argument("--ckpt", default="artifacts/ckpt_vision_torch")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    # the reference computes float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with use_device(args.device):
        return _run(args, current_device())


def _run(args, device: torch.device) -> Dict[str, Any]:
    cfg = MODELS[args.model]
    corpus = build_corpus(args.corpus, seed=5, num_classes=cfg.num_classes)

    # the worker count is measured on this machine, never hardcoded
    # (paper §4.3: the best count depends on the decoder and the CPU)
    tune = autotune_workers(
        lambda w: make_loader(corpus, args.decoder, w, args.decode_batch),
        candidates=(0, 2, 4), max_items=48)
    print(f"autotuned workers: {tune['best']} (sweep: "
          f"{ {w: round(m, 1) for w, (m, s) in tune['sweep'].items()} })")
    loader = make_loader(corpus, args.decoder, tune["best"],
                         args.decode_batch, shuffle=True)

    state = init_state(cfg, 0, device)
    n_params = sum(p.numel() for p in tree.leaves(state["params"]))
    print(f"model params: {n_params / 1e6:.1f}M on {device}")
    mgr = CheckpointManager(args.ckpt, keep=2)
    step0, restored, extra = mgr.restore_latest(like=state)
    if step0 is not None:
        state = restored
        loader.restore(extra["loader"])
        print(f"resumed from step {step0}")

    t0 = time.perf_counter()
    state, report = train(state, loader, steps=args.steps, cfg=cfg,
                          mgr=mgr)
    wall = time.perf_counter() - t0
    done = int(state["step"])
    print(f"\n{done} steps in {wall:.1f}s; loader time "
          f"{report['data_s']:.1f}s, step time {report['step_s']:.1f}s -> "
          f"input-pipeline share {100 * report['share']:.0f}%")
    print("(when that share is large, the paper's loader protocol, not a "
          "single-thread decoder table, is the evidence that matters)")
    if report["losses"]:
        print(f"loss: first {report['losses'][0]:.4f}, last "
              f"{report['losses'][-1]:.4f}; finite "
              f"{bool(np.isfinite(report['losses']).all())}")
    return dict(report, step=done, workers=tune["best"])


if __name__ == "__main__":
    main()
