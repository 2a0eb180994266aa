"""What a rank of the multi-pod mesh (2 x 16 x 16) pays, in the dry-run's
count, where the port's layout is not the reference's.

* GQA attention blocks whose KV heads do not divide over the model
  axis of 16 (``qwen2-7b``, ``granite-3-8b``, ``deepseek-coder-33b``,
  ``gemma3-4b``, ``musicgen-medium``, the VLM's self- and
  cross-attention) run context-parallel as the reference's do
  (``tensor_parallel.Plan.cp``): each rank holds 1/16 of their leaves
  and of their decode caches' sequence and computes its column blocks
  and its rows of the queries. Nothing to price: a block that ran whole
  on every model rank would cost 15/16 of its leaves (their FSDP block;
  in a train cell with both float32 moments) and decode caches and
  15/16 of its matmul FLOPs, counted under a spy on
  ``layers.attn_block`` at the config's depth (the forward, and in a
  train cell the remat recompute; the backward's two passes taken as
  twice those); the probe prints that price (``extra_*``, zero) beside
  the blocks' counted matmul FLOPs a rank (``attention_matmul_flops``).
* ``long_500k``'s batch of 1 is replicated over the 32 data ranks, and
  its attention caches are cut on the sequence over them as the
  reference cuts them (``layers.ContextSplit``); the Mamba2 state stays
  whole over them, where the reference cuts its heads: 31/32 of the
  state's bytes. (The MLA latent cache is cut over ``model`` as the
  reference's: nothing to price.)

Usage (no card; ~1-2 min on a CPU):
  PYTHONPATH=src python tools/probe_dryrun_whole_blocks.py [--arch A ...]
Prints one line a cell, and writes them as JSON with ``--out``.
"""
import argparse
import json
import sys

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, list_configs, \
    shape_applicable
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers, model
from repro_torch.models.layers import ShapesOnly

META = torch.device("meta")


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def whole_attention_leaves(cfg, ctx) -> int:
    """Bytes a rank holds of the GQA attention leaves that the model axis
    keeps whole (each over its FSDP cut)."""
    plan = TP.plan(cfg, ctx)
    if plan.attn or plan.cp:
        return 0
    own = [s for st in cfg.plan() for _ in range(st.repeat)
           for s in st.layers if not s.shared]
    cuts = TP.layout(cfg, ctx)
    D = TP.data_ways(ctx)
    total = 0
    for path, t in tree.flatten_with_names(model.init(ShapesOnly(), cfg)
                                           ).items():
        if TP._block_of(path, cfg, own) != "attn":
            continue
        c = cuts.get(path)
        total += t.numel() * t.element_size() // (
            D if c is not None and c.data is not None else 1)
    return total


def attention_flops(cfg, shape, ctx) -> int:
    """Matmul FLOPs inside ``layers.attn_block`` calls of the cell (every
    GQA self- and cross-attention block), at the config's depth: the
    spy's sum joins each of ``count_cell``'s counts as one more key, so
    depth by repeat extrapolates it as it does the others."""
    seen = [0]
    real, real_count = layers.attn_block, dryrun_lib.count

    def spy(*a, **k):
        c = _get_current_dispatch_mode()
        before = c.matmul_flops
        out = real(*a, **k)
        seen[0] += c.matmul_flops - before
        return out

    def count(*a, **k):
        seen[0] = 0
        out = real_count(*a, **k)
        out["attention_matmul_flops"] = seen[0]
        return out
    layers.attn_block, dryrun_lib.count = spy, count
    try:
        return dryrun_lib.count_cell(cfg, shape, ctx)[
            "attention_matmul_flops"]
    finally:
        layers.attn_block, dryrun_lib.count = real, real_count


def cell(arch: str, shape_name: str) -> dict:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=True)
    ctx = sharding.make_context(mesh.shape, remat="full")
    M, R = ctx.tp_size, ctx.data_axes_size
    plan = TP.plan(cfg, ctx)
    gqa = any(s.kind in ("attn", "cross_attn")
              for s in model.layer_specs(cfg))
    whole = gqa and not (plan.attn or plan.cp)
    out = {"arch": arch, "shape": shape_name, "whole_attention": whole,
           "context_parallel": gqa and plan.cp,
           "replicated_batch": shape.global_batch % R != 0}
    B = dryrun_lib.local_rows(shape.global_batch, ctx)
    caches = model.init_cache(cfg, B, shape.seq_len, device=META, ctx=ctx) \
        if shape.kind == "decode" else []
    specs = model.layer_specs(cfg)
    attn_cache = _nbytes(t for s, c in zip(specs, caches)
                         if s.kind == "attn" for t in c)
    state = _nbytes(c[1] for s, c in zip(specs, caches) if s.kind == "mamba")
    extra_bytes, extra_flops = 0, 0
    if gqa and (whole or plan.cp):
        f = attention_flops(cfg, shape, ctx)
        f *= 2 if shape.kind == "train" else 1      # the backward's
        out["attention_matmul_flops"] = f
    if whole:
        leaves = whole_attention_leaves(cfg, ctx)
        per = 5 if shape.kind == "train" else 1     # + float32 mu, nu
        # a replicated batch's caches are cut on the sequence over the
        # data axes, where the reference's are too (not over ``model``)
        cache = 0 if out["replicated_batch"] else attn_cache
        extra_bytes += (per * leaves + cache) * (M - 1) // M
        extra_flops += f * (M - 1) // M
    if out["replicated_batch"]:
        extra_bytes += state * (R - 1) // R
    out.update(extra_argument_bytes=extra_bytes,
               extra_matmul_flops=extra_flops)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for arch in args.arch or list_configs():
        for shape_name in SHAPES:
            if not shape_applicable(get_config(arch), SHAPES[shape_name])[0]:
                continue
            r = cell(arch, shape_name)
            if r["extra_argument_bytes"] or r["extra_matmul_flops"] or \
                    r["context_parallel"]:
                print(json.dumps(r), flush=True)
                rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
