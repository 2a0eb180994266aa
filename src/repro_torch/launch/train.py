"""Training launcher for the LM: any arch of the port, on one card or on
a ``data x model`` mesh of ranks.

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
again). It runs on the card unless ``--device cpu``; with no card it
exits 2.

``--data-parallel D --model-parallel M`` above 1 x 1 trains on a
``D x M`` mesh, as the reference's launcher does: one process a rank,
the world taken from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) and joined at ``--dist-init`` (default
``env://``; a ``file://`` URL needs no socket), NCCL on the cards and
gloo on the CPU. Every rank makes the whole initial state from the same
generator and keeps its block, as the reference's launcher places the
state by its partition rules (``convert.local_tp_state``): over the model
axis its heads, FFN hidden units, vocabulary rows and experts, over the
``data`` axis its FSDP block of the parameters, both moments and the
error buffer. It draws the global batch and takes its data shard's rows
(``train_step.data_shard``); the model runs tensor-parallel over the
model axis, gathers each layer's leaves over the data axis on use, and
the MoE layers run ``routed_ep``. Only rank 0 prints and writes
checkpoints, which hold the reference's whole leaves (each cut leaf and
its moments gathered over the data axis, then the model axis), so a
checkpoint written on a mesh is one written without; a resume cuts them
again. A mesh without a world of ``D·M`` ranks exits 2 with the
reason:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-7b-smoke --data-parallel 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.device import add_device_flag, entry_device, use_device
from repro_torch.distributed import data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.launch.mesh import BACKENDS, make_host_mesh
from repro_torch.models import convert
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import data_shard, make_train_state, \
    make_train_step


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
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init_method on a mesh")
    add_device_flag(ap)
    return ap.parse_args(argv)


def _join_world(args: argparse.Namespace, dev: torch.device
                ) -> Optional[str]:
    """Join the world of a ``D x M`` run (module docstring); the reason
    when it cannot be joined."""
    n = args.data_parallel * args.model_parallel
    mesh = f"a {args.data_parallel} x {args.model_parallel} mesh"
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except (KeyError, ValueError):
        return (f"{mesh} needs an initialised world of {n} ranks: run one "
                f"process a rank under torchrun (RANK and WORLD_SIZE are "
                f"not set)")
    if world != n:
        return f"{mesh} needs a world of {n} ranks; WORLD_SIZE is {world}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(BACKENDS[dev.type],
                                init_method=args.dist_init, rank=rank,
                                world_size=world,
                                device_id=dev if dev.type == "cuda" else None)
    except ValueError as e:
        return f"{mesh}: the world at {args.dist_init} cannot be joined: {e}"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = entry_device(args.device)
    if dev is None:
        return 2
    on_mesh = args.data_parallel * args.model_parallel > 1
    if on_mesh and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    with use_device(dev):
        # the reference computes float32 products in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = None
        if on_mesh:
            why = _join_world(args, dev)
            if why is None:
                try:
                    mesh = make_host_mesh(args.data_parallel,
                                          args.model_parallel)
                except ValueError as e:
                    why = str(e)
                    dist.destroy_process_group()
            if why is not None:
                print(f"error: {why}", file=sys.stderr)
                return 2
        try:
            train(args, dev, mesh)
        finally:
            if mesh is not None:
                dist.destroy_process_group()
    return 0


def train(args: argparse.Namespace, dev: torch.device, mesh=None) -> None:
    """The launcher's run on ``dev``, over ``mesh`` (a live device mesh)
    or none."""
    cfg = get_config(args.arch)
    ctx = make_context(mesh, remat="full", q_chunk=256, k_chunk=256)
    first = mesh is None or dist.get_rank() == 0
    say = print if first else (lambda *a, **k: None)
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
        say(f"resumed from step {step0}")
    state = convert.local_tp_state(state, cfg, ctx)
    split = TP.layout(cfg, ctx)

    def save(write, step, state):
        # every rank gathers; rank 0 writes the whole leaves
        whole = data_parallel.gather_split(state, ctx, split)
        if first:
            write(step, whole)

    batches = train_batches(cfg, args.batch, args.seq)
    done = int(state["step"])
    for _ in range(done):
        next(batches)
    t0 = time.perf_counter()
    while done < args.steps:
        batch = {k: v.to(dev) for k, v in data_shard(
            next(batches), ctx, args.microbatch).items()}
        state, metrics = step_fn(state, batch)
        done = int(state["step"])
        if done % 10 == 0 or done == args.steps:
            say(f"step {done:4d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.perf_counter() - t0) / max(done - (step0 or 0), 1):.2f}"
                f" s/step)")
        if done % args.ckpt_every == 0:
            save(mgr.save_async, done, state)
    mgr.wait()
    save(mgr.save, done, state)
    say(f"done: {done} steps, checkpoint at {args.ckpt}/step_{done}")


if __name__ == "__main__":
    sys.exit(main())
