"""Model assembly for the dense and MoE LM families: init, forward,
prefill, decode.

Port of the reference's ``models/model.py`` (``init`` ``:55``,
``forward`` ``:133``, ``fused_ce`` ``:173``, ``lm_loss`` ``:201``,
``init_cache`` ``:255``, ``_fold_prefill_cache`` ``:272``, ``prefill``
``:295``, ``decode_step`` ``:329``) for one device. The reference
scans over stacked per-layer parameters; here ``params["layers"]`` is
a list with one dict per layer and a Python loop walks it. Caches are
a list with one ``(k, v)`` pair per layer, each ``[B, cache_len, KV,
head_dim]``; ``decode_step`` writes the new token's k and v into them
IN PLACE and returns the same list.

The config's plan (``cfg.plan()``) is unrolled to one ``LayerSpec`` a
layer (``layer_specs``): the dense family's one stage, or the MoE
family's leading dense layers (``dense_d_ff`` wide) and then its MoE
layers (``models.moe``). Each layer is ``{"attn", "ffn"}``; a MoE
layer's ``ffn`` holds the router and experts. ``forward`` sums the MoE
layers' load-balance aux over the layers, as the reference's scan does.

With ``ctx.remat == "full"`` each layer of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scanned block): the backward recomputes the layer from its input, so a
training step keeps one ``[B, S, d]`` activation per layer.

Only the ``dense`` family and the ``moe`` family without MLA or MTP
are ported: anything else raises ``NotImplementedError`` naming the
family.

Entry points:
  init(generator, cfg)                -> params
  forward(params, tokens, ...)        -> (hidden [B,S,d], aux_loss)
  lm_loss(params, batch, ...)         -> (scalar loss, metrics)   [train]
  prefill(params, tokens, ...)        -> (caches, last_logits)    [serve]
  decode_step(params, caches, ...)    -> (caches, logits)         [serve]
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import current_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ModelContext

Params = Dict[str, Any]
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The config's plan unrolled to one spec per layer; raises for what
    the port does not run yet."""
    if cfg.family not in ("dense", "moe") or cfg.use_mla or cfg.mtp_depth:
        raise NotImplementedError(
            f"repro_torch runs the dense family and the moe family without "
            f"MLA or MTP; {cfg.name} is {cfg.family!r} (use_mla="
            f"{cfg.use_mla}, mtp_depth={cfg.mtp_depth})")
    specs = []
    for stage in cfg.plan():
        for _ in range(stage.repeat):
            for spec in stage.layers:
                if spec.kind != "attn" or spec.shared or \
                        spec.ffn not in ("dense", "moe"):
                    raise NotImplementedError(f"layer spec {spec}")
                specs.append(spec)
    return specs


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters with the reference's scales: embed x0.02,
    unembed and projections /sqrt(fan_in), norms and biases zero, made
    on ``gen``'s device (``layers.ShapesOnly()`` for ``gen``: on the
    ``meta`` device, no memory). The numbers differ from
    ``jax.random``'s; tests that compare with the reference import its
    parameters instead (``models.convert``). A MoE layer's router is
    float32 in any model dtype, as the reference's."""
    specs = layer_specs(cfg)
    dt = getattr(torch, cfg.dtype)
    Vp, d = cfg.padded_vocab_size, cfg.d_model
    params: Params = {
        "embed": L.normal_param(gen, (Vp, d), dt, 0.02),
        "unembed": L.normal_param(gen, (d, Vp), dt, 1.0 / d ** 0.5),
        "final_ln": torch.zeros(d, dtype=dt, device=gen.device),
        "layers": [{"attn": L.init_attn(gen, cfg),
                    "ffn": _init_ffn(gen, spec, cfg)} for spec in specs],
    }
    return params


def _init_ffn(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig
              ) -> Params:
    if spec.ffn == "moe":
        return MOE.init_moe(gen, cfg)
    # the MoE family's leading dense layers are dense_d_ff wide
    ff = cfg.dense_d_ff if (cfg.family == "moe" and cfg.dense_d_ff) else None
    return L.init_ffn(gen, cfg, d_ff=ff)


def _apply_layer(spec: LayerSpec, p: Params, x: torch.Tensor, cfg, ctx, *,
                 positions=None, cache=None, cache_pos=None,
                 return_cache=False):
    """One layer -> (x, cache, aux); aux is None for a dense FFN."""
    x, nc = L.attn_block(p["attn"], x, cfg, ctx, window=spec.window,
                         positions=positions, cache=cache,
                         cache_pos=cache_pos, return_kv=return_cache)
    if spec.ffn == "moe":
        x, aux = MOE.moe_block(p["ffn"], x, cfg, ctx)
        return x, nc, aux
    return L.ffn_block(p["ffn"], x, cfg), nc, None


# --------------------------------------------------------------------------
# forward (teacher-forced)
# --------------------------------------------------------------------------
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ModelContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (hidden [B, S, d], aux_loss)."""
    x = params["embed"][tokens]
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux_total = torch.zeros((), device=x.device)
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        if ctx.remat == "full":
            x, aux = checkpoint(_train_layer, spec, p, x, cfg, ctx,
                                positions, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, _, aux = _apply_layer(spec, p, x, cfg, ctx,
                                     positions=positions)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, aux_total


def _train_layer(spec, p, x, cfg, ctx, positions):
    x, _, aux = _apply_layer(spec, p, x, cfg, ctx, positions=positions)
    return x, aux


# --------------------------------------------------------------------------
# fused unembed + cross-entropy, chunked over the sequence: the float32
# [B, S, V] logits never exist whole (2.5 GB at B 2, S 2048, V 152064)
# --------------------------------------------------------------------------
def _ce_chunk(xc, unembed, tc, vmask):
    logits = (xc @ unembed).float()
    logits = torch.where(vmask, logits, -1e30)
    lz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None])[..., 0]
    return lz - ll


def fused_ce(x: torch.Tensor, unembed: torch.Tensor, targets: torch.Tensor,
             vocab_size: int, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of ``x [B, S, d] @ unembed [d, Vp]`` against
    ``targets [B, S]``, logits past ``vocab_size`` (the padding) masked
    to -1e30. One chunk of ``chunk`` positions at a time, each under
    ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    float32 logits instead of keeping them; ``chunk = S`` when S is
    not a multiple of it or not above it."""
    B, S, _ = x.shape
    if S % chunk or S <= chunk:
        chunk = S
    vmask = torch.arange(unembed.shape[1], device=x.device) < vocab_size
    targets = targets.long()
    losses = [checkpoint(_ce_chunk, x[:, i:i + chunk], unembed,
                         targets[:, i:i + chunk], vmask,
                         use_reentrant=False, preserve_rng_state=False)
              for i in range(0, S, chunk)]
    return torch.stack(losses).mean()               # [n, B, chunk]


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, ctx: ModelContext, *, mtp_weight: float = 0.3,
            aux_weight: float = 0.001
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch["tokens"] [B, S + 1]``: the first S
    tokens in, the last S as targets. Returns (loss, {"ce", "aux",
    "loss"}), loss = ce + ``aux_weight`` * aux; aux is the MoE layers'
    summed load-balance loss, 0 in the dense family. ``mtp_weight``
    weighs the reference's MTP loss: its MTP head and image embeddings
    belong to families the port does not run yet, and those raise."""
    if cfg.mtp_depth or cfg.cross_attn_every or "image_embeds" in batch:
        raise NotImplementedError(
            f"lm_loss: {cfg.name} needs the MTP head or image embeddings, "
            f"which the port does not run yet")
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux = forward(params, inputs, cfg, ctx)
    loss = fused_ce(hidden, params["unembed"], targets, cfg.vocab_size)
    metrics = {"ce": loss, "aux": aux}
    loss = loss + aux_weight * aux
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------------
# serve: cache construction, prefill, decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: Optional[torch.device] = None) -> Cache:
    """Zeroed caches, one (k, v) pair per layer."""
    dev = device or current_device()
    dt = getattr(torch, cfg.dtype)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))
            for _ in layer_specs(cfg)]


def _fold_prefill_cache(raw, cfg, cache_len: int):
    """Raw prefill (k, v) -> cache tensors of cache_len rows, zero past
    the prompt (neither ported family has windowed layers)."""
    dt = getattr(torch, cfg.dtype)

    def pad(t):
        out = t.new_zeros((t.shape[0], cache_len) + t.shape[2:], dtype=dt)
        out[:, :t.shape[1]] = t
        return out
    return tuple(pad(t) for t in raw)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ModelContext, *, cache_len: int
            ) -> Tuple[Cache, torch.Tensor]:
    """Teacher-forced pass emitting decode caches + last-position logits
    (float32, [B, padded_vocab])."""
    x = params["embed"][tokens]
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    caches: Cache = []
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        x, raw, _ = _apply_layer(spec, p, x, cfg, ctx, positions=positions,
                                 return_cache=True)
        caches.append(_fold_prefill_cache(raw, cfg, cache_len))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, -1] @ params["unembed"]).float()
    return caches, logits


def decode_step(params: Params, caches: Cache, token: torch.Tensor,
                pos: int, cfg: ModelConfig, ctx: ModelContext
                ) -> Tuple[Cache, torch.Tensor]:
    """One serve step: token [B, 1] at position ``pos``. Writes into
    ``caches`` in place and returns them with the float32 logits."""
    x = params["embed"][token]
    positions = torch.full(token.shape, pos, device=x.device)
    new_caches: Cache = []
    for spec, p, c in zip(layer_specs(cfg), params["layers"], caches):
        x, nc, _ = _apply_layer(spec, p, x, cfg, ctx, positions=positions,
                                cache=c, cache_pos=pos)
        new_caches.append(nc)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (x[:, -1] @ params["unembed"]).float()
    return new_caches, logits
