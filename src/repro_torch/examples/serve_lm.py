"""Batched LM serving: prefill, then greedy decode with KV caches, for
any ported architecture, at its full config or its ``-smoke`` cut.

Port of the reference's ``examples/serve_lm.py``. Parameters come from
``model.init`` with a ``torch.Generator`` seeded 0, the prompt from a
second generator (seed 1) and, for a cross-attention arch, the bf16
``image_embeds`` from a third (seed 2, scaled 0.1), each on the device
the example runs on. The reference draws them with ``PRNGKey(0)``,
``(1)`` and ``(2)``, whose bits torch cannot reproduce, so the two
examples print different ids; the tests carry the reference's
parameters across with ``models.convert`` and hold the ids equal.

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        [--arch qwen2-7b-smoke] [--batch 4] [--prompt-len 32] \\
        [--new-tokens 24]

On the card a bf16 prefill runs each self-attention layer through the
``flash_attention_wgmma`` kernel (head dim 64 or 128) and decode runs
none; ``--arch qwen2-7b`` (28 layers, ~15 GB of bf16 weights) launches
it 28 times. The first prefill of a process builds the kernel (nvcc)
unless it was built before, and its time counts in the prefill's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.device import add_device_flag, on_device
from repro_torch.models import model
from repro_torch.models.layers import ModelContext
from repro_torch.serve.engine import generate

CTX = ModelContext(q_chunk=64, k_chunk=64)


def inputs(cfg, batch: int, prompt_len: int, device: torch.device
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prompt ``[batch, prompt_len]``, image embeddings or None), drawn
    from the generators seeded 1 and 2 on ``device``."""
    prompt = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    embeds = None
    if cfg.cross_attn_every:
        embeds = (0.1 * torch.randn(
            batch, cfg.num_image_tokens, cfg.d_model,
            generator=torch.Generator(device=device).manual_seed(2),
            device=device)).to(torch.bfloat16)
    return prompt, embeds


def main(argv: Optional[Sequence[str]] = None, *,
         dtype: Optional[str] = None, params=None) -> Dict[str, Any]:
    """Serve one batch; returns what it printed. ``dtype`` replaces the
    config's and ``params`` replace ``model.init``'s (tests run float32
    and carry the reference's parameters across)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b-smoke",
                    help="arch id; -smoke suffix for reduced configs")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    with on_device(args.device) as dev:
        cfg = get_config(args.arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        return _run(args, cfg, dev, params)


def _run(args, cfg, dev: torch.device, params) -> Dict[str, Any]:
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt, embeds = inputs(cfg, args.batch, args.prompt_len, dev)
    # the reference's bf16 embeddings promote to a float32 model's type
    # inside its products; torch's products do not promote
    kw = {} if embeds is None else {
        "image_embeds": embeds.to(getattr(torch, cfg.dtype))}

    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    out = generate(params, prompt, cfg, CTX, max_new_tokens=args.new_tokens,
                   timings=timings, **kw)
    dt = time.perf_counter() - t0
    ids = out.cpu()
    res: Dict[str, Any] = {
        "arch": cfg.name, "dtype": cfg.dtype, "device": str(dev),
        "shape": list(ids.shape), "ids": ids.tolist(), "seconds": dt,
        "tokens_per_s": args.batch * args.new_tokens / dt,
        "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"]}
    print(f"arch={cfg.name} generated {tuple(ids.shape)} in {dt:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s incl. first calls) on {dev}")
    print(f"prefill {args.batch} x {args.prompt_len} tokens: "
          f"{timings['prefill_s']:.4f} s; decode {args.new_tokens - 1} "
          f"steps: {timings['decode_s']:.4f} s")
    print("sample token ids:", ids[0, :12].tolist())
    if card:
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory: {res['peak_bytes']} bytes")
    return res


if __name__ == "__main__":
    main()
