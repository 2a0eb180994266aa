"""Train-step builder for the LM: the gradient of ``lm_loss``, optional
int8 gradient compression, then AdamW.

Port of the reference's ``train/train_step.py``. ``make_train_step``
returns a function ``(state, batch) -> (state, metrics)`` over the
state::

    {"params": ..., "opt": {"mu": ..., "nu": ...}, "step": int32 0-d,
     "err": ...}                     # err only with grad compression

``batch`` is ``{"tokens": [B, S + 1] integer tensor}`` on the
parameters' device, with ``"image_embeds"`` ``[B, N, d]`` for the VLM
family. The step runs eagerly; remat is the context's
(``ModelContext(remat="full")`` recomputes each layer in the
backward, as the reference's ``jax.checkpoint`` does).

On a mesh (``ctx.mesh``: ``sharding.make_context`` of a ``data x model``
device mesh) the step runs on every rank, as the reference's step jitted
over the mesh: ``batch`` holds this rank's rows (``data_shard``), the
state this rank's block of each cut leaf (``convert.local_tp_state``):
over the model axis its heads, FFN hidden units, vocabulary rows and
experts, over the ``data`` axis its FSDP block of parameters, moments
and error buffer, gathered layer by layer on use (``distributed.fsdp``).
The gradients are reduced to the global batch's before compression and
AdamW, which run on the blocks (``distributed.data_parallel``),
and the metrics are the reference's global values: ``ce`` (and ``mtp``)
averaged over the data axes, ``aux`` the first data shard's, ``loss``
recombined from them, ``grad_norm`` the whole model's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compression, data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import model
from repro_torch.models.layers import ModelContext, ShapesOnly, named_scope
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)

Metrics = Dict[str, torch.Tensor]
#: the scope of the compression and AdamW update (``layers.named_scope``;
#: the dry-run keeps a step's peak inside and outside it apart)
OPTIMIZER_SCOPE = "optimizer"


def make_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptimizerConfig, *,
                     grad_compression: bool = False,
                     keep=None) -> Dict[str, Any]:
    """Random parameters from ``gen`` (on its device), zero moments in
    ``cfg.opt_dtype``, step 0 and, with compression, a zero bf16 error
    buffer. ``keep`` as ``model.init``'s (``convert.local_tp_keep``: a
    rank's block, made a layer at a time)."""
    params = model.init(gen, cfg, keep=keep)
    state = {
        "params": params,
        "opt": adamw_init(params, cfg.opt_dtype),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }
    if grad_compression:
        state["err"] = compression.init_error_buffer(params)
    return state


def make_train_state_shapes(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                            grad_compression: bool = False
                            ) -> Dict[str, Any]:
    """The state of ``make_train_state`` on the ``meta`` device: every
    leaf's shape and dtype, no parameter memory (the dry-run reads it)."""
    return make_train_state(ShapesOnly(), cfg, opt_cfg,
                            grad_compression=grad_compression)


def loss_and_grads(params, batch, cfg: ModelConfig, ctx: ModelContext
                   ) -> Tuple[Tuple[torch.Tensor, Metrics], Any]:
    """((loss, metrics), grads) of ``model.lm_loss`` at ``params``: the
    gradient of every parameter leaf by ``torch.autograd.grad``, in a
    tree of ``params``' structure; everything detached."""
    flat = tree.flatten_with_names(params)
    live = {n: p.detach().requires_grad_() for n, p in flat.items()}
    loss, metrics = model.lm_loss(tree.unflatten_like(params, live), batch,
                                  cfg, ctx)
    grads = torch.autograd.grad(loss, list(live.values()))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten_like(params, dict(zip(live, grads))))


def data_shard(batch: Dict[str, torch.Tensor], ctx: ModelContext,
               microbatch: int = 0) -> Dict[str, torch.Tensor]:
    """The rows of the global ``batch`` that this rank's step takes, in
    the order it takes them: data shard ``d``'s ``B/D`` rows. With
    ``microbatch``, the reference's rows: it slices the global batch into
    microbatches of ``microbatch`` rows and shards each over the data
    axes, so shard ``d`` takes rows ``i·mb + d·mb/D`` to ``+ mb/D`` of
    each microbatch ``i``. Without a mesh, ``batch`` itself."""
    D = ctx.data_axes_size
    if D == 1:
        return batch
    B = batch["tokens"].shape[0]
    mb = microbatch or B
    if B % mb or mb % D:
        raise ValueError(f"batch {B} in microbatches of {mb} rows does not "
                         f"shard over {D} data ranks")
    d, per = data_parallel.data_rank(ctx), mb // D
    rows = torch.cat([torch.arange(i + d * per, i + (d + 1) * per)
                      for i in range(0, B, mb)])
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


def make_grads_fn(cfg: ModelConfig, ctx: ModelContext, *,
                  microbatch: int = 0) -> Callable:
    """The training step's gradient: ``(params, batch) -> (metrics,
    grads)``, what ``make_train_step``'s step hands to compression and
    AdamW. On a mesh the gradients are reduced to the global batch's
    (``data_parallel.reduce_gradients``) and the metrics are the global
    ones, ``loss`` recombined from them.

    ``microbatch > 0`` accumulates gradients over B / microbatch
    slices of the batch in order, with the reference's arithmetic: the
    first slice's gradients start the sum, each later slice's are added
    in the gradients' own dtype, and loss, metrics and gradients are
    scaled by 1/n at the end. On a mesh ``microbatch`` counts the global
    batch's rows, as the reference's: a rank's slices are ``microbatch
    / D`` of its rows (``data_shard`` orders them), and a
    ``microbatch`` that does not divide over the D data ranks raises
    ``ValueError``. The dense MoE route (the ``no_tp`` hint's default)
    over more than one data rank takes the global batch's load-balance
    aux, as the reference's (``models.moe.global_aux``)."""
    D = ctx.data_axes_size
    if microbatch % D:
        raise ValueError(f"microbatch {microbatch} does not divide over "
                         f"{D} data ranks")
    local_mb = microbatch // D
    mesh = data_parallel.on_mesh(ctx)
    split = TP.layout(cfg, ctx)

    def grads_of(params, batch):
        if not local_mb:
            return loss_and_grads(params, batch, cfg, ctx)
        B = batch["tokens"].shape[0]
        if B % local_mb:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{local_mb}")
        n = B // local_mb

        def piece(i):
            return {k: v[i * local_mb:(i + 1) * local_mb]
                    for k, v in batch.items()}

        (loss, metrics), grads = loss_and_grads(params, piece(0), cfg, ctx)
        for i in range(1, n):
            (l, m), g = loss_and_grads(params, piece(i), cfg, ctx)
            grads = tree.tree_map(torch.add, grads, g)
            loss = loss + l
            metrics = {k: metrics[k] + m[k] for k in metrics}
        scale = 1.0 / n
        return ((loss * scale, {k: v * scale for k, v in metrics.items()}),
                tree.tree_map(lambda g: g * scale, grads))

    def step_grads(params, batch):
        (_, metrics), grads = grads_of(params, batch)
        if mesh:
            seq = TP.for_sequence(
                ctx, batch["tokens"].shape[1] - 1).seq_parallel
            grads = data_parallel.reduce_gradients(grads, ctx, split, seq)
        if data_parallel.data_groups(ctx):
            metrics = data_parallel.global_metrics(metrics, ctx)
            metrics["loss"] = model.total_loss(
                metrics["ce"], metrics["aux"], metrics.get("mtp"))
        return metrics, grads

    return step_grads


def make_train_step(cfg: ModelConfig, ctx: ModelContext,
                    opt_cfg: OptimizerConfig, *,
                    grad_compression: bool = False,
                    microbatch: int = 0) -> Callable:
    """The step: ``make_grads_fn``'s gradient (``microbatch`` as there),
    then, with ``grad_compression``, int8 compression with error
    feedback, then AdamW, on this rank's blocks."""
    grads_fn = make_grads_fn(cfg, ctx, microbatch=microbatch)
    split = TP.layout(cfg, ctx)

    def train_step(state, batch):
        metrics, grads = grads_fn(state["params"], batch)
        new_state = dict(state)
        with named_scope(OPTIMIZER_SCOPE):
            if grad_compression:
                grads, new_err = compression.compress_grads_with_feedback(
                    grads, state["err"], model.layer_stacks(cfg), ctx, split)
                new_state["err"] = new_err
            params, opt, opt_metrics = adamw_update(
                grads, state["opt"], state["params"], state["step"],
                opt_cfg, ctx, split)
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        return new_state, dict(metrics, **opt_metrics)

    return train_step
