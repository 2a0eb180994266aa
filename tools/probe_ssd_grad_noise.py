#!/usr/bin/env python3
"""How far float32 rounding alone moves a Mamba2 model's gradients: a
world of one's float32 ``loss_and_grads`` against the same step with
another SSD chunk (an equally valid order of the same sums) and against
float64, at ``zamba2-2.7b``'s width cut to 2 super-blocks (12 Mamba2
layers, 2 shared-attention applications), 1 x 512, remat full; and
whether ``models.ssm.ssd_scan`` gives a head the same bits when it runs
with half of the heads.

    PYTHONPATH=src python3 tools/probe_ssd_grad_noise.py [--seq 512]
    PYTHONPATH=src python3 tools/probe_ssd_grad_noise.py --cost

Prints, for the leaves whose float32 gradients move most between the two
chunks, each gap over the leaf's largest |element| of the float64
gradient, and the card's name and power limit. Needs one NVIDIA card
(``--device cpu`` runs it on the host, at ``zamba2-2.7b-smoke``).

``--cost`` times the two segment sums instead, in one process and in
turns (masked, cumsum, cumsum, masked): for ``mamba2-370m`` and
``zamba2-2.7b`` at full width and depth in bf16, ``chip_smoke.py``
phase 15's prefill (4 x 2048) and phase 19 (b)'s gradient (2 x 2048,
remat full), each the median of ``--reps`` calls by CUDA events, with
its peak device memory.
"""
import argparse
import dataclasses
import subprocess
import sys
import time

import torch


def _cumsum_segsum(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``_segsum``: the difference of two cumulative
    sums."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, -torch.inf)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--segsum", choices=("masked", "cumsum"),
                    default="masked",
                    help="masked: the port's ``ssm._segsum``; cumsum: the "
                         "reference's difference of two cumulative sums "
                         "in its place")
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.device import set_device
    from repro_torch.models import model, ssm
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card visible", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    set_device(args.device)
    if args.cost:
        return _cost(args)
    if args.segsum == "cumsum":
        ssm._segsum = _cumsum_segsum
    dev = torch.device(args.device)
    arch = "zamba2-2.7b" if args.device == "cuda" else "zamba2-2.7b-smoke"
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=args.layers)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, args.seq + 1),
                                     generator=g, device=dev)}

    def grads(p, c, chunk):
        ctx = ModelContext(remat="full", q_chunk=256, k_chunk=256,
                           ssd_chunk=chunk)
        (loss, _), gr = loss_and_grads(p, batch, c, ctx)
        return loss.item(), tree.flatten_with_names(gr)
    loss_a, ga = grads(params, cfg, 256)
    loss_b, gb = grads(params, cfg, 128)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    p64 = tree.unflatten_like(params, {
        n: t.double() for n, t in tree.flatten_with_names(params).items()})
    loss_64, g64 = grads(p64, cfg64, 256)
    del p64
    print(f"segsum {args.segsum}; "
          f"{arch} at {args.layers} layers, 1 x {args.seq}: loss chunk 256 "
          f"{loss_a}, chunk 128 {loss_b}, float64 {loss_64}")
    rows = []
    for n, w in g64.items():
        s = w.abs().max().item()
        if s == 0:
            continue
        rows.append(((ga[n] - gb[n]).abs().max().item() / s,
                     (ga[n].double() - w).abs().max().item() / s,
                     (gb[n].double() - w).abs().max().item() / s, n))
    rows.sort(key=lambda r: max(r[:3]), reverse=True)
    print("leaf: |chunk 256 - chunk 128|, |chunk 256 - float64|, "
          "|chunk 128 - float64|, each over the leaf's max |float64 g|")
    for r in rows[:12]:
        print(f"  {r[3]}: {r[0]:.4g} {r[1]:.4g} {r[2]:.4g}")
    print(f"{sum(r[0] > 1e-4 for r in rows)} of {len(rows)} leaves move "
          f"more than 1e-4 between the chunks")
    # one head's bits with all heads and with half of them
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = torch.randn(1, args.seq, h, p, generator=g, device=dev)
    dt = torch.rand(1, args.seq, h, generator=g, device=dev) * 0.1
    A = -torch.rand(h, generator=g, device=dev)
    B = torch.randn(1, args.seq, 1, n, generator=g, device=dev)
    C = torch.randn(1, args.seq, 1, n, generator=g, device=dev)
    y, st = ssm.ssd_scan(x, dt, A, B, C, 256)
    y2, st2 = ssm.ssd_scan(x[:, :, :h // 2], dt[:, :, :h // 2], A[:h // 2],
                           B, C, 256)
    print(f"ssd_scan with {h // 2} of {h} heads: y equal bit for bit "
          f"{torch.equal(y[:, :, :h // 2], y2)}, max diff "
          f"{(y[:, :, :h // 2] - y2).abs().max().item()}; state "
          f"{torch.equal(st[:, :h // 2], st2)}")
    return 0


def _cost(args) -> int:
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.models import model, ssm
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    dev = torch.device(args.device)
    smoke = "" if args.device == "cuda" else "-smoke"
    forms = {"masked": ssm._segsum, "cumsum": _cumsum_segsum}
    sync = torch.cuda.synchronize if args.device == "cuda" else (
        lambda: None)

    def timed(fn):
        """Median ms of ``args.reps`` calls after one warm-up, and the
        peak device memory over them."""
        fn()
        sync()
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(args.reps):
            if args.device == "cuda":
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                fn()
                b.record()
                sync()
                ms.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated()
                if args.device == "cuda" else 0)
        return statistics.median(ms), peak

    for arch in ("mamba2-370m", "zamba2-2.7b"):
        cfg = get_config(arch + smoke)
        params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
        g = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                               device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049),
                                         generator=g, device=dev)}
        ctx = ModelContext()
        tctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)

        def prefill():
            with torch.no_grad():
                model.prefill(params, prompt, cfg, ctx, cache_len=2049)

        def step():
            loss_and_grads(params, batch, cfg, tctx)

        for form in ("masked", "cumsum", "cumsum", "masked"):
            ssm._segsum = forms[form]
            for what, fn in (("prefill 4 x 2048", prefill),
                             ("gradient 2 x 2048", step)):
                ms, peak = timed(fn)
                print(f"{arch} {what}, segsum {form}: {ms} ms (median of "
                      f"{args.reps}), peak {peak} bytes")
        ssm._segsum = forms["masked"]
        del params
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
