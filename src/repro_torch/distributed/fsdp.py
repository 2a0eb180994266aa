"""FSDP (ZeRO-3) over the data axis: each data rank holds its block of
the leaves that the reference's partition rules cut over ``data``, and
the model gathers them on use.

The reference's launcher places its parameters, both AdamW moments and
the error buffer by ``param_specs``, which put ``"data"`` on the d_model
dimension of almost every large leaf (``sharding.fsdp_dim``), and lets
XLA gather them where they are used. The port holds rank ``(d, m)``'s
block of each such leaf as a plain tensor (``convert.local_tp_params``,
``tensor_parallel.layout``'s ``Cuts.data``) and writes the collective
out: ``gather`` all-gathers a leaf over the ``data`` axis in rank order
along its cut dimension, and its backward reduce-scatters (sums) the
gradient back to the rank's block. So a data-cut leaf's gradient leaves
the backward already summed over the data ranks, and the training step
only averages it (``distributed.data_parallel.reduce_gradients``).

``models.model`` gathers each layer's data-cut leaves just before the
layer runs (under ``remat="full"`` inside the recomputed function, so
the backward gathers again and the whole leaves are not kept from the
forward), ``unembed`` before the cross-entropy and the logits, and the
MTP module before its layer; the gathered leaves are dropped after use.
Prefill and decode gather the same way. Over a data axis of one rank
(no mesh, a world of one, the dry-run's ``launch.mesh.RankMesh`` of a
mesh with one data rank) nothing is cut and nothing is gathered. The
collectives are ``all_gather`` and ``reduce_scatter``, through
``distributed.collectives`` (counted over the dry-run's ``RankMesh``),
which NCCL takes and gloo takes for CPU and CUDA tensors alike
(``tools/probe_gloo_cuda.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch import tree
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a context cuts over the data axis: ``ways`` ranks (1:
    nothing), this rank's index ``rank``, the axis's ``group``, and the
    data-axis ``Cut`` of each cut leaf by its name in the parameter tree
    (``cuts``)."""
    ways: int = 1
    rank: int = 0
    group: Any = None
    cuts: Mapping[str, TP.Cut] = dataclasses.field(default_factory=dict)


NONE = Plan()


def plan(cfg, ctx) -> Plan:
    """``ctx``'s data-axis cut of ``cfg``'s leaves (``Plan``)."""
    D = TP.data_ways(ctx)
    if D == 1:
        return NONE
    return Plan(ways=D, rank=ctx.mesh.get_local_rank("data"),
                group=ctx.mesh.get_group("data"),
                cuts={n: c.data for n, c in TP.layout(cfg, ctx).items()
                      if c.data is not None})


class _Gather(torch.autograd.Function):
    """A leaf's block -> the whole leaf, the ranks' blocks in rank order
    along ``dim``; backward: the sum over the axis of rank d's block of
    the gradient."""

    @staticmethod
    def forward(fctx, t, fs, dim):
        fctx.fs, fctx.dim = fs, dim
        return C.all_gather(t, fs.group, dim)

    @staticmethod
    def backward(fctx, g):
        fs = fctx.fs
        return C.reduce_scatter(g, fs.group, fctx.dim), None, None


def gather(p, name: str, fs: Plan):
    """``p`` (a leaf, or a tree of them such as a layer's dict) at ``name``
    in the parameter tree, with each leaf that ``fs`` cuts gathered whole
    over the data axis; every other leaf is the same tensor."""
    if fs.ways == 1:
        return p
    if isinstance(p, torch.Tensor):
        cut = fs.cuts.get(name)
        return p if cut is None else _Gather.apply(p, fs, cut.dim)
    return tree.unflatten_like(p, {
        n: gather(t, f"{name}/{n}", fs)
        for n, t in tree.flatten_with_names(p).items()})
