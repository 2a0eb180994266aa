"""A training step's collectives on a ``data x model`` mesh.

The reference jits its train step over the mesh with sharded inputs
(``launch/train.py:66``): its gradients, norm and int8 scales are those
of the global batch, with the reductions XLA inserts. The port runs the
step on every rank of a ``torch.distributed`` device mesh
(``launch.mesh.make_host_mesh``, ``sharding.make_context``), each rank
on its data shard's rows and with its block of each cut leaf
(``tensor_parallel.layout``, cut by ``convert.local_tp_params``): over
the model axis the *split leaves* (the tensor-parallel leaves and each
MoE layer's experts), over the data axis the *data-cut leaves* (FSDP,
``distributed.fsdp``: the leaves whose rule has ``"data"``). What the
reference's global values need:

* over the data axes, every gradient leaf is averaged: each rank's loss
  is the mean over its rows, and the shards hold equal rows. A data-cut
  leaf's gradient arrives already summed over the ``data`` axis (the
  backward of its gather reduce-scatters it), so it is only divided,
  and summed over the other data axes (``pod``; ``model`` under
  ``no_tp``), whose ranks hold the same block; summing it over ``data``
  again would multiply it by the axis's size;
* over the model axis, a whole leaf that a rank sees through its share
  of the positions only has its gradient summed: the MoE routers (each
  rank routes its ``S/M`` positions, ``models.moe.routed_ep``) and, with
  the sequence-split residual (``ModelContext.seq_parallel``), every
  leaf the model axis does not split. The split leaves are not reduced
  over it: each rank's share has its whole gradient (the collectives'
  backwards, ``distributed.tensor_parallel`` and the exchange of
  ``routed_ep``), and so has every other whole leaf, which sees the
  whole sequence on every rank (the whole leaves that feed only the
  rank's heads, MLA's ``wq_a``/``wkv_a`` and their norms and Mamba2's
  ``A_log``/``D``/``dt_bias``/``gnorm``, get every rank's heads'
  gradient through ``tensor_parallel.share``, which copies nothing
  under the sequence-split residual: their gradients are summed once);
* the global norm counts each leaf once: a split leaf's squares summed
  over the model axis, a data-cut leaf's over the ``data`` axis, a leaf
  cut on both over both (``global_sq_sums``);
* an int8 scale is the maximum over a whole leaf: the maximum over the
  model and ``data`` axes for a cut leaf (``whole_max``).

With ``no_tp`` the model axis is a data axis and nothing is reduced over
it as a model axis. An axis of one rank needs none of this, and nothing
is called over it: a world of one runs the step as one device does. Every
reduction goes through ``distributed.collectives``: over the dry-run's
``launch.mesh.RankMesh`` (no process group) it is counted, not run.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.tensor_parallel import cuts_of

#: cut leaves by name (``tensor_parallel.layout``)
Split = Mapping[str, TP.Cuts]


def on_mesh(ctx) -> bool:
    """Whether ``ctx`` computes on a mesh (a live one or the dry-run's)."""
    return ctx is not None and ctx.mesh is not None


def _groups(ctx, axes: Iterable[str]) -> List:
    """The process groups of those of ``axes`` with more than one rank."""
    mesh = ctx.mesh
    return [mesh.get_group(a) for a in axes
            if mesh.size(mesh.mesh_dim_names.index(a)) > 1]


def data_groups(ctx) -> List:
    return _groups(ctx, ctx.data_axes) if on_mesh(ctx) else []


def model_groups(ctx) -> List:
    """The model axis's group where it has more than one rank and is not
    a data axis (``no_tp``)."""
    if not on_mesh(ctx) or ctx.no_tp:
        return []
    return _groups(ctx, (ctx.model_axis,))


def fsdp_groups(ctx) -> List:
    """The ``data`` axis's group (the FSDP axis) where it has more than
    one rank."""
    if not on_mesh(ctx) or "data" not in ctx.mesh.mesh_dim_names:
        return []
    return _groups(ctx, ("data",))


def data_rank(ctx) -> int:
    """This rank's index along the data axes together (row-major)."""
    if not on_mesh(ctx):
        return 0
    mesh, r = ctx.mesh, 0
    for a in ctx.data_axes:
        r = r * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return r


def _sum(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over ``groups`` in place (the seam reduces a
    contiguous copy of a strided tensor); returns ``t``."""
    for g in groups:
        r = C.all_reduce(t, g)
        if r is not t:
            t.copy_(r)
    return t


@torch.no_grad()
def reduce_gradients(grads, ctx, split: Split = None, seq: bool = False):
    """This rank's gradients -> the reference's global ones on ``ctx``'s
    mesh (module docstring): every leaf averaged over the data axes, a
    data-cut leaf (``split``) summed over the data axes but ``data``;
    over the model axis the routers of ``routed_ep`` summed, and with
    ``seq`` (the step's residual was sequence-split) every leaf that
    ``split`` does not cut over it. In place; returns ``grads``."""
    data, model = data_groups(ctx), model_groups(ctx)
    if not data and not model:
        return grads
    flat = tree.flatten_with_names(grads)
    cuts = cuts_of(flat, split or {})
    fsdp = fsdp_groups(ctx)
    others = [g for g in data if g not in fsdp]
    n_data = ctx.data_axes_size
    for name, g in flat.items():
        c = cuts.get(name)
        split_here = c is not None and c.model is not None
        if model and (not split_here if seq else
                      ctx.moe_impl == "ep" and name.endswith("/router")):
            _sum(g, model)
        if data:
            cut_here = c is not None and c.data is not None and fsdp
            _sum(g, others if cut_here else data).div_(n_data)
    return grads


@torch.no_grad()
def global_sq_sums(grads, ctx, split: Split = None) -> List[torch.Tensor]:
    """Each leaf's float32 sum of squares in leaf order, a cut leaf's
    (``split``) summed over the axes that cut it: the model axis, the
    ``data`` axis or both (one all-reduce a group for them all)."""
    flat = tree.flatten_with_names(grads)
    sums = {n: g.float().square().sum() for n, g in flat.items()}
    model, fsdp = model_groups(ctx), fsdp_groups(ctx)
    by_groups: Dict[tuple, List[str]] = {}
    for n, c in cuts_of(flat, split or {}).items():
        groups = tuple((model if c.model is not None else []) +
                       (fsdp if c.data is not None else []))
        if groups:
            by_groups.setdefault(groups, []).append(n)
    for groups, names in by_groups.items():
        both = _sum(torch.stack([sums[n] for n in names]), groups)
        sums.update(zip(names, both.unbind()))
    return list(sums.values())


@torch.no_grad()
def whole_max(values: List[torch.Tensor], ctx) -> List[torch.Tensor]:
    """Each float32 0-d value's maximum over the model and ``data`` axes,
    in one all-reduce an axis: a cut leaf's whole maximum from its
    blocks' (a value that an axis holds the same on every rank stays
    what it is)."""
    groups = model_groups(ctx) + fsdp_groups(ctx)
    if not groups or not values:
        return values
    both = torch.stack(values)
    for g in groups:
        both = C.all_reduce(both, g, dist.ReduceOp.MAX)
    return list(both.unbind())


@torch.no_grad()
def global_metrics(metrics: Dict[str, torch.Tensor], ctx
                   ) -> Dict[str, torch.Tensor]:
    """``model.lm_loss``'s metrics on this rank -> the reference's: every
    metric averaged over the data axes but ``aux``, which is the first
    data shard's, as the reference's jitted step returns it (ROADMAP §3:
    its ``routed_ep`` declares the model-axis mean replicated over the
    data axes). ``loss`` is the caller's to recombine."""
    data = data_groups(ctx)
    if not data:
        return dict(metrics)
    names = [n for n in metrics if n != "aux"]
    first = data_rank(ctx) == 0
    v = torch.stack([metrics[n].float() for n in names] +
                    [metrics["aux"].float() if first else
                     torch.zeros((), device=metrics["aux"].device)])
    _sum(v, data)
    out = {n: x / ctx.data_axes_size for n, x in zip(names, v[:-1])}
    out["aux"] = v[-1]
    return out


@torch.no_grad()
def gather_split(state, ctx, split: Split):
    """A tree holding parameter-shaped trees (parameters, moments, error
    buffer) with this rank's block of each cut leaf (``split``) -> the
    same tree with every cut leaf whole: gathered over the ``data`` axis,
    then over the model axis, in rank order along each cut dimension;
    every rank takes part. Other leaves are the same tensors."""
    model, fsdp = model_groups(ctx), fsdp_groups(ctx)
    if not model and not fsdp:
        return state
    flat = tree.flatten_with_names(state)
    out = dict(flat)
    for name, c in cuts_of(flat, split).items():
        t = flat[name]
        for groups, cut in ((fsdp, c.data), (model, c.model)):
            if groups and cut is not None:
                t = C.all_gather(t, groups[0], cut.dim)
        out[name] = t
    return tree.unflatten_like(state, out)
