"""Train-step builder for the LM: the gradient of ``lm_loss``, optional
int8 gradient compression, then AdamW.

Port of the reference's ``train/train_step.py``. ``make_train_step``
returns a function ``(state, batch) -> (state, metrics)`` over the
state::

    {"params": ..., "opt": {"mu": ..., "nu": ...}, "step": int32 0-d,
     "err": ...}                     # err only with grad compression

``batch`` is ``{"tokens": [B, S + 1] integer tensor}`` on the
parameters' device. The step runs eagerly; remat is the context's
(``ModelContext(remat="full")`` recomputes each layer in the
backward, as the reference's ``jax.checkpoint`` does).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compression
from repro_torch.models import model
from repro_torch.models.layers import ModelContext, ShapesOnly
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)

Metrics = Dict[str, torch.Tensor]


def make_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptimizerConfig, *,
                     grad_compression: bool = False) -> Dict[str, Any]:
    """Random parameters from ``gen`` (on its device), zero moments in
    ``cfg.opt_dtype``, step 0 and, with compression, a zero bf16 error
    buffer."""
    params = model.init(gen, cfg)
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


def make_train_step(cfg: ModelConfig, ctx: ModelContext,
                    opt_cfg: OptimizerConfig, *,
                    grad_compression: bool = False,
                    microbatch: int = 0) -> Callable:
    """``microbatch > 0`` accumulates gradients over B / microbatch
    slices of the batch in order, with the reference's arithmetic: the
    first slice's gradients start the sum, each later slice's are added
    in the gradients' own dtype, and loss, metrics and gradients are
    scaled by 1/n at the end."""

    def grads_of(params, batch):
        if not microbatch:
            return loss_and_grads(params, batch, cfg, ctx)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{microbatch}")
        n = B // microbatch

        def piece(i):
            return {k: v[i * microbatch:(i + 1) * microbatch]
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

    def train_step(state, batch):
        (_, metrics), grads = grads_of(state["params"], batch)
        new_state = dict(state)
        if grad_compression:
            grads, new_err = compression.compress_grads_with_feedback(
                grads, state["err"])
            new_state["err"] = new_err
        params, opt, opt_metrics = adamw_update(
            grads, state["opt"], state["params"], state["step"], opt_cfg)
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        return new_state, dict(metrics, **opt_metrics)

    return train_step
