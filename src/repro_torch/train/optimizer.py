"""AdamW with decoupled weight decay, global-norm clipping, bias correction.

Port of the reference's ``train/optimizer.py``: functional over the
same nested dicts, in the same order of operations. Moments live in
``opt_dtype`` (float32 by default); the update math is always float32.
Every function runs under ``torch.no_grad()``, so new parameters carry
no graph; the trainer marks them as requiring grad for the next step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import data_parallel


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


@torch.no_grad()
def adamw_init(params, opt_dtype: str = "float32") -> Dict[str, Any]:
    dt = getattr(torch, opt_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params)}


@torch.no_grad()
def global_norm(grads, ctx=None, split=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, leaf sums added in
    the reference's leaf order. On a mesh (``ctx``) the whole model's:
    each whole leaf once, each rank's block of a cut leaf (``split``,
    ``tensor_parallel.layout``) summed over the model and ``data`` axes
    that cut it (``data_parallel.global_sq_sums``)."""
    total = None
    for s in data_parallel.global_sq_sums(grads, ctx, split):
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    warm = torch.clamp((step.float() + 1.0) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(grads, opt_state, params, step: torch.Tensor,
                 cfg: OptimizerConfig, ctx=None, split=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: returns (params, opt_state, {"grad_norm", "lr"}).
    ``step`` is the int32 step counter before this update; ``ctx``, a
    context on a mesh, and ``split``, the leaves its axes cut, make the
    clip's norm the whole model's. On a mesh every leaf is this rank's
    block (FSDP: parameters and moments of the rank's block only), and
    the update is elementwise."""
    gnorm = global_norm(grads, ctx, split)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(step, cfg)
    t = step.float() + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu_f = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu_f = cfg.b2 * nu.float() + (1 - cfg.b2) * g.square()
        mhat = mu_f / bc1
        vhat = nu_f / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay \
            * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), mu_f.to(mu.dtype), nu_f.to(nu.dtype)

    flat_g = tree.flatten_with_names(grads)
    flat_mu = tree.flatten_with_names(opt_state["mu"])
    flat_nu = tree.flatten_with_names(opt_state["nu"])
    out = {name: upd(p, flat_g[name], flat_mu[name], flat_nu[name])
           for name, p in tree.flatten_with_names(params).items()}
    new_p, new_mu, new_nu = (
        tree.unflatten_like(params, {n: o[i] for n, o in out.items()})
        for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu}, \
        {"grad_norm": gnorm, "lr": lr}
