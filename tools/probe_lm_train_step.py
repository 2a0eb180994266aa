#!/usr/bin/env python3
"""Where a bf16 LM train step's time goes, on the card.

    PYTHONPATH=src python3 tools/probe_lm_train_step.py [--layers 4]

``qwen2-7b`` at full width, its depth cut to ``--layers`` (bf16
weights, float32 AdamW moments, ``remat="full"``), the launcher's
batches at B 2 x S 2048 (``chip_smoke.py`` phase 11 (b)). After two
warm-up steps it times, on the host clock after a synchronise, three
steps split into their parts: ``train_step.loss_and_grads`` (forward,
remat recompute and backward) and ``optimizer.adamw_update``; then it
profiles one whole step with ``torch.profiler`` (device time by kernel
group, the device's idle share; Chrome trace under
``artifacts/lm_profile/``). Prints the card's name and power limit.
Needs a card.
"""
import argparse
import dataclasses
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("probe_lm_train_step: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches
    from repro_torch.models.layers import ModelContext
    from repro_torch.train import OptimizerConfig, adamw_update
    from repro_torch.train.train_step import (loss_and_grads,
                                              make_train_state,
                                              make_train_step)
    print("card:", chip_smoke.smi_line())
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=args.layers)
    ctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)
    box = {"state": make_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg)}
    step = make_train_step(cfg, ctx, opt_cfg)
    batches = token_batches(cfg.vocab_size, 2, 2048)

    def batch():
        return {"tokens": torch.from_numpy(next(batches)).to(dev)}

    for _ in range(2):
        box["state"], _ = step(box["state"], batch())
    parts = {"loss_and_grads": [], "adamw_update": []}
    for _ in range(3):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = loss_and_grads(box["state"]["params"], b, cfg, ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s = box["state"]
        params, opt, _ = adamw_update(grads, s["opt"], s["params"],
                                      s["step"], opt_cfg)
        del grads, s
        box["state"] = dict(box["state"], params=params, opt=opt,
                            step=box["state"]["step"] + 1)
        del params, opt
        torch.cuda.synchronize()
        parts["loss_and_grads"].append((t1 - t0) * 1e3)
        parts["adamw_update"].append((time.perf_counter() - t1) * 1e3)
    for name, ms in parts.items():
        print(f"{name}: {ms} ms (median {statistics.median(ms)})")
    b = batch()

    def one_step():
        box["state"], _ = step(box["state"], b)
    chip_smoke._profile(f"lm train step {args.layers} layers", one_step)
    print("card:", chip_smoke.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
