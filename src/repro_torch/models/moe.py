"""Mixture-of-Experts FFN: shared experts + routed top-k, on one device.

Port of the reference's ``models/moe.py`` (``init_moe`` ``:45``,
``_route`` ``:66``, ``routed_dense`` ``:91``, ``moe_block`` ``:161``).
``routed`` computes what the reference's dense oracle computes, the
exact drop-free top-k combine, without running every expert over every
token: the (token, slot) pairs are sorted by expert, each expert that
got rows runs its SwiGLU on those rows only, and the outputs return to
``[T, k, d]`` order through the inverse permutation, where the gates
weigh them and a sum over k combines them. No atomics: the combine is a
gather and a sum, so a run on the card gives the same bits every time.

The reference's expert-parallel path (``routed_ep``, a ``shard_map``
over a mesh with fixed capacity) is not ported: expert parallelism
exists only across cards (ROADMAP queue 1 item 16).

Both entry points return (y, aux) where aux is the switch-style
load-balance loss, float32.

On ``meta`` tensors (the dry-run's counting, ``launch.dryrun_lib``) the
expert choices have no values, so the per-expert counts come from a
stated routing model instead of the one host read: even load, ``T·k //
E`` rows an expert and one more for each of the first ``T·k % E``
experts (``expert_rows``). The SwiGLU FLOPs of a layer are then those of
its ``T·k`` rows, as on the card whatever the split; the reference's
dry-run compiles ``routed_ep``, every expert over a buffer of 1.25 times
its even share, and the difference is stated in ROADMAP §3.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg) -> Params:
    """The reference's leaves, shapes, dtypes and scales: the router
    ``[d, E]`` float32 whatever the model's dtype, expert ``w1``/``w3``
    ``[E, d, ff]`` and ``w2`` ``[E, ff, d]``, the shared experts one
    SwiGLU of width ``moe_d_ff * num_shared_experts``, ``ln`` zeros."""
    d = cfg.d_model
    E, ff = cfg.num_experts, cfg.moe_d_ff
    sh_ff = cfg.moe_d_ff * cfg.num_shared_experts
    dt = getattr(torch, cfg.dtype)
    s = lambda n: 1.0 / math.sqrt(n)
    p = {
        "router": L.normal_param(gen, (d, E), torch.float32, s(d)),
        "w1": L.normal_param(gen, (E, d, ff), dt, s(d)),
        "w3": L.normal_param(gen, (E, d, ff), dt, s(d)),
        "w2": L.normal_param(gen, (E, ff, d), dt, s(ff)),
        "ln": torch.zeros(d, dtype=dt, device=gen.device),
    }
    if cfg.num_shared_experts:
        p["sh_w1"] = L.normal_param(gen, (d, sh_ff), dt, s(d))
        p["sh_w3"] = L.normal_param(gen, (d, sh_ff), dt, s(d))
        p["sh_w2"] = L.normal_param(gen, (sh_ff, d), dt, s(sh_ff))
    return p


def route(xt: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: [T, d] -> (gates [T, k] in xt's dtype, idx [T, k] in
    descending probability, as ``jax.lax.top_k`` orders them, aux)."""
    T = xt.shape[0]
    E = router.shape[1]
    probs = torch.softmax(xt.float() @ router, dim=-1)           # [T, E]
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style aux: E * sum_e f_e * P_e, f_e the share of the T
    # tokens' k choices that went to e (counted, so exact)
    flat = idx.reshape(-1)
    # meta tensors have no counts: an [E] stand-in of bincount's type
    counts = flat.new_empty(E) if flat.is_meta else \
        torch.bincount(flat, minlength=E)
    f = counts.float() / T
    aux = E * torch.sum(f * probs.mean(0))
    return gates.to(xt.dtype), idx, aux


def expert_rows(flat: torch.Tensor, num_experts: int) -> list:
    """Rows routed to each expert, from ``flat`` ([T*k] expert ids): one
    host read on the card; on ``meta`` tensors the even-load model (see
    the module docstring)."""
    if flat.is_meta:
        n, extra = divmod(flat.shape[0], num_experts)
        return [n + (e < extra) for e in range(num_experts)]
    return torch.bincount(flat, minlength=num_experts).tolist()


def routed(xt: torch.Tensor, p: Params, cfg
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt: [T, d] -> (the top-k combine of the routed experts [T, d],
    aux). Each expert runs on the rows routed to it."""
    T, d = xt.shape
    k = cfg.experts_per_token
    gates, idx, aux = route(xt, p["router"], k)
    flat = idx.reshape(-1)                          # [T*k], token-major
    order = torch.argsort(flat, stable=True)        # the pairs by expert
    # the one host read of the layer: the slices below need the counts
    counts = expert_rows(flat, cfg.num_experts)
    rows = xt[order // k]                           # [T*k, d]
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(L.swiglu(rows[start:start + n], p["w1"][e],
                                 p["w3"][e], p["w2"][e]))
            start += n
    y = torch.cat(outs)[torch.argsort(order)].reshape(T, k, d)
    return (y * gates[..., None]).sum(dim=1), aux


def moe_block(p: Params, x: torch.Tensor, cfg, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE residual block: x + shared experts + routed experts.
    ``ctx`` is the reference's (it picks the expert-parallel path on a
    mesh); on one device the block computes the same either way."""
    B, S, d = x.shape
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    r, aux = routed(xn.reshape(B * S, d), p, cfg)
    r = r.reshape(B, S, d)
    if cfg.num_shared_experts:
        return x + L.swiglu(xn, p["sh_w1"], p["sh_w3"], p["sh_w2"]) + r, aux
    return x + r, aux
