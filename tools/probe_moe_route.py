#!/usr/bin/env python3
"""Time the MoE router and the drop-free MoE block at
``deepseek-moe-16b``'s widths, for one or more checkouts of the port in
turns.

    PYTHONPATH=src python3 tools/probe_moe_route.py [--src DIR ...]

Each ``--src`` (a checkout's ``src`` directory; default this one's) runs
in a subprocess of its own, in the order given, so that two versions can
be timed parent, change, change, parent within one call. A run makes one
bf16 MoE layer (64 experts, top-6, 2 shared, d_model 2048) from seed 0
and times, by CUDA events over eager calls back to back after a warm-up:
``models.moe.route`` on 4 x 2048 tokens and on 4 decode tokens, and
``models.moe.moe_block`` with no context (the drop-free ``routed``) on
the same inputs (float32 standard normal rows cast to bf16, seed 1).
Both versions see the same inputs and weights, and check that they give
the same expert choices. Needs one NVIDIA card; prints the card's name
and power limit, then one JSON line a run.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-moe-16b"
BATCH, PROMPT = 4, 2048
ITERS, WARMUP = 20, 3


def _ms(fn, iters=ITERS, warmup=WARMUP):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(src: str) -> int:
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(ARCH)
    dev = torch.device("cuda:0")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"src": src, "module": moe.__file__}
    for label, S in (("prefill", PROMPT), ("decode", 1)):
        x = torch.randn(BATCH, S, cfg.d_model, generator=g,
                        device=dev).to(getattr(torch, cfg.dtype))
        xt = x.reshape(-1, cfg.d_model)
        _, idx, aux = moe.route(xt, p["router"], cfg.experts_per_token)
        out[f"{label}_tokens"] = xt.shape[0]
        out[f"{label}_idx_sum"] = int(idx.sum())
        out[f"{label}_aux"] = aux.item()
        out[f"{label}_route_ms"] = _ms(
            lambda: moe.route(xt, p["router"], cfg.experts_per_token))
        out[f"{label}_block_ms"] = _ms(lambda: moe.moe_block(p, x, cfg))
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append",
                    help="a checkout's src directory (repeatable; default "
                         "this checkout's)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch
    if not torch.cuda.is_available():
        print("probe_moe_route: no CUDA card visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card:", card, flush=True)
    runs = []
    for src in args.src or [os.path.join(ROOT, "src")]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", os.path.abspath(src)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            sys.stderr.write(res.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    keys = ("prefill_idx_sum", "decode_idx_sum")
    if any(tuple(r[k] for k in keys) != tuple(runs[0][k] for k in keys)
           for r in runs):
        print("probe_moe_route: the runs chose other experts",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
