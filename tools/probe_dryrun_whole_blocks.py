"""What a rank of the multi-pod mesh (2 x 16 x 16) pays, in the dry-run's
count, where the port's layout is not the reference's.

* GQA attention blocks whose query or KV heads do not divide over the
  model axis of 16 run whole on every model rank (``sharding.split_dim``);
  the reference splits their projections' columns and the attention's
  query rows 16 ways. Extra a rank: 15/16 of the blocks' leaves (their
  FSDP block; in a train cell with both float32 moments) and of their
  decode caches (the reference cuts the cache's sequence over ``model``),
  and 15/16 of the blocks' matmul FLOPs: counted under a spy on
  ``layers.attn_block`` (the forward, and in a train cell the remat
  recompute; the backward's two passes are taken as twice those).
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
    if TP.plan(cfg, ctx).attn:
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
    GQA self- and cross-attention block), by depth as the dry-run counts."""
    seen = [0]
    real = layers.attn_block

    def spy(*a, **k):
        c = _get_current_dispatch_mode()
        before = c.matmul_flops
        out = real(*a, **k)
        seen[0] += c.matmul_flops - before
        return out
    layers.attn_block = spy
    try:
        dryrun_lib.count_cell(cfg, shape, ctx)
    finally:
        layers.attn_block = real
    return seen[0]


def cell(arch: str, shape_name: str) -> dict:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=True)
    ctx = sharding.make_context(mesh.shape, remat="full")
    M, R = ctx.tp_size, ctx.data_axes_size
    whole = not TP.plan(cfg, ctx).attn and any(
        s.kind in ("attn", "cross_attn") for s in model.layer_specs(cfg))
    out = {"arch": arch, "shape": shape_name, "whole_attention": whole,
           "replicated_batch": shape.global_batch % R != 0}
    B = dryrun_lib.local_rows(shape.global_batch, ctx)
    caches = model.init_cache(cfg, B, shape.seq_len, device=META, ctx=ctx) \
        if shape.kind == "decode" else []
    specs = model.layer_specs(cfg)
    attn_cache = _nbytes(t for s, c in zip(specs, caches)
                         if s.kind == "attn" for t in c)
    state = _nbytes(c[1] for s, c in zip(specs, caches) if s.kind == "mamba")
    extra_bytes, extra_flops = 0, 0
    if whole:
        leaves = whole_attention_leaves(cfg, ctx)
        per = 5 if shape.kind == "train" else 1     # + float32 mu, nu
        # a replicated batch's caches are cut on the sequence over the
        # data axes, where the reference's are too (not over ``model``)
        cache = 0 if out["replicated_batch"] else attn_cache
        extra_bytes += (per * leaves + cache) * (M - 1) // M
        f = attention_flops(cfg, shape, ctx)
        f *= 2 if shape.kind == "train" else 1      # the backward's
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
            if r["extra_argument_bytes"] or r["extra_matmul_flops"]:
                print(json.dumps(r), flush=True)
                rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
