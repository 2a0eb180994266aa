"""Training launcher for the LM: any arch of the port on one card.

Port of the reference's ``launch/train.py``. It trains ``--arch`` (the
``-smoke`` reduced configs by default; every family: dense, MoE with
MLA and MTP, SSM, hybrid, audio, local/global, VLM) for ``--steps``
steps on random batches, checkpoints every ``--ckpt-every`` steps and
resumes from the newest checkpoint under ``--ckpt``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b-smoke \\
      --steps 30 [--grad-compression] [--microbatch 2] [--device cpu]

The batches are the reference's: ``np.random.RandomState(1)`` draws one
``[batch, seq + 1]`` int32 token array a step and, for an arch with
cross-attention layers (the VLM family), then ``0.1 * randn(batch,
num_image_tokens, d_model)`` image embeddings, float32 cast to bfloat16
whatever the model's dtype. A resumed run draws and drops the batches
of the steps its checkpoint holds, so it trains on the batches an
uninterrupted run would (the reference's resume starts the stream
again). It runs on the card unless ``--device cpu``; with no
card it exits 2, and it exits 2 for a mesh (``--data-parallel`` times
``--model-parallel`` above 1), which one card cannot hold.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.device import add_device_flag, entry_device, use_device
from repro_torch.models.layers import ModelContext
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import make_train_state, make_train_step


def train_batches(cfg, batch: int, seq: int
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """The reference launcher's batches for ``cfg``, one a step, endless,
    as CPU tensors: ``tokens`` int32 and, with ``cfg.cross_attn_every``,
    ``image_embeds`` bfloat16 drawn after the step's tokens from the same
    ``RandomState``."""
    rng = np.random.RandomState(1)
    while True:
        out = {"tokens": torch.from_numpy(rng.randint(
            0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32))}
        if cfg.cross_attn_every:
            out["image_embeds"] = torch.from_numpy((0.1 * rng.randn(
                batch, cfg.num_image_tokens, cfg.d_model)).astype(
                    np.float32)).to(torch.bfloat16)
        yield out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b-smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default="artifacts/ckpt_train_torch")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.data_parallel * args.model_parallel > 1:
        print("error: one card: no mesh until the port has a second device",
              file=sys.stderr)
        return 2
    dev = entry_device(args.device)
    if dev is None:
        return 2
    with use_device(dev):
        # the reference computes float32 products in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        train(args, dev)
    return 0


def train(args: argparse.Namespace, dev: torch.device) -> None:
    """The launcher's run on ``dev``."""
    cfg = get_config(args.arch)
    ctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=10)
    state = make_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, opt_cfg,
                             grad_compression=args.grad_compression)
    step_fn = make_train_step(cfg, ctx, opt_cfg,
                              grad_compression=args.grad_compression,
                              microbatch=args.microbatch)

    mgr = CheckpointManager(args.ckpt, keep=2)
    step0, restored, _ = mgr.restore_latest(like=state)
    if step0 is not None:
        state = restored
        print(f"resumed from step {step0}")

    batches = train_batches(cfg, args.batch, args.seq)
    done = int(state["step"])
    for _ in range(done):
        next(batches)
    t0 = time.perf_counter()
    while done < args.steps:
        batch = {k: v.to(dev) for k, v in next(batches).items()}
        state, metrics = step_fn(state, batch)
        done = int(state["step"])
        if done % 10 == 0 or done == args.steps:
            print(f"step {done:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0) / max(done - (step0 or 0), 1):.2f}"
                  f" s/step)")
        if done % args.ckpt_every == 0:
            mgr.save_async(done, state)
    mgr.wait()
    mgr.save(done, state)
    print(f"done: {done} steps, checkpoint at {args.ckpt}/step_{done}")


if __name__ == "__main__":
    sys.exit(main())
