"""Model assembly for every LM family of the reference (dense, MoE with
MLA and MTP, SSM, hybrid, audio, local/global, VLM): init, forward,
prefill, decode.

Port of the reference's ``models/model.py`` (``init`` ``:55``,
``forward`` ``:133``, ``fused_ce`` ``:173``, ``lm_loss`` ``:201``,
``init_cache`` ``:255``, ``_fold_prefill_cache`` ``:272``, ``prefill``
``:295``, ``decode_step`` ``:329``). On a context whose model axis
splits the leaves (``distributed.tensor_parallel``) each rank holds its
share of the heads (GQA, cross-attention, MLA, Mamba2's SSD, the MTP
layer's; a GQA block whose KV heads do not divide over the axis its
column blocks, and it attends with its rows of the queries), FFN hidden
units and vocabulary rows
(``convert.local_tp_params``): the embedding is looked up where each
token's row lives, and the logits, gathered over the vocabulary, are
the same on every rank; ``forward`` under the ``seq_shard_residual``
hint returns this rank's share of the positions. On a data axis of more
than one rank each rank holds its block of the leaves the reference
cuts over ``data`` (``distributed.fsdp``): a layer's are gathered just
before it runs (inside the recomputed function under ``remat="full"``),
a shared layer's at each application, ``unembed`` before the
cross-entropy and the logits, the MTP module before its layer; prefill
and decode gather the same way. The reference
scans over stacked per-layer parameters; here ``params["layers"]`` is
a list with one dict per layer and a Python loop walks it.

The config's plan (``cfg.plan()``) is unrolled to one ``LayerSpec`` per
application (``layer_specs``): the dense and audio families' one stage;
the MoE family's leading dense layers (``dense_d_ff`` wide) and then its
MoE layers (``models.moe``); the SSM family's Mamba2 layers
(``models.ssm``, no FFN); the hybrid family's super-blocks of Mamba2
layers and one shared attention layer (no FFN); the local/global
family's super-blocks of ``local_global_ratio`` sliding-window layers
and one global layer, then its remaining window layers; the VLM
family's super-blocks of ``cross_attn_every - 1`` self-attention layers
and one cross-attention layer over the image embeddings. With
``use_mla`` (``deepseek-v3-671b``) the MoE family's layers are MLA
blocks (``layers.mla_block``). A layer is ``{"attn"}`` (the attention,
MLA or Mamba2 block's leaves, under the reference's key) and ``"ffn"``
unless its spec says ``ffn="none"``. With ``mtp_depth``, ``init`` adds
the reference's MTP module, ``params["mtp"]`` (``proj [2d, d]``,
``ln_h``, ``ln_e`` and one GQA attention layer with a dense FFN, under
``attn`` and ``ffn``), which only ``lm_loss`` reads. A
shared layer's
parameters are held once, as the reference's ``stage{s}_shared``:
``params[f"stage{s}_shared"][f"layer{j}"]``, not in ``params["layers"]``;
``layer_params`` gives the parameters of every application, a shared
layer's the same dict each time. ``forward`` sums the MoE layers'
load-balance aux over the layers, as the reference's scan does. The
audio family's ``num_codebooks`` belongs to its frontend; the model does
not read it, as in the reference.

Caches are a list with one entry per application: an attention layer's
``(k, v)``, each ``[B, rows, KV, head_dim]`` (a rank's ``rows / W`` of
them where ``init_cache`` cuts the sequence over W ranks), which
``decode_step`` writes IN PLACE (each application of a shared layer
keeps its own); an
MLA layer's latent ``(c_kv [B, cache_len, kv_lora_rank], k_pe [B,
cache_len, qk_rope_head_dim])``, also written in place; a Mamba2
layer's ``(conv tail [B, K-1, C]`` in the model dtype, ``state [B,
heads, head_dim, N]`` in float32), which ``decode_step`` replaces; a
cross-attention layer's ``()``: it recomputes the image K/V from
``image_embeds`` at every step, as the reference does.
``rows`` is ``cache_len``, or ``min(window, cache_len)`` for a
sliding-window layer, whose cache is a ring: position t lives in row
``t % rows``. ``prefill`` writes the prompt's last ``rows`` positions
there whatever the prompt's length; the reference keeps the last
``window`` rows in order, which is the same ring only when the prompt
length is a multiple of the window (ROADMAP §3).

With ``ctx.remat == "full"`` each layer of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scanned block): the backward recomputes the layer from its input, so a
training step keeps one ``[B, S, d]`` activation per layer.

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
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import ModelContext

Params = Dict[str, Any]
Cache = List[Tuple[torch.Tensor, torch.Tensor]]

#: the families the port runs: every family of the reference
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio",
                   "local_global", "vlm")
#: the layer kinds and FFN kinds of the reference's plans
LAYER_KINDS = ("attn", "mla", "mamba", "cross_attn")
FFN_KINDS = ("dense", "moe", "none")
#: the MTP module's one layer (the reference's ``model.py:85-87``)
MTP_SPEC = LayerSpec("attn", "dense")


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The config's plan unrolled to one spec per application (a shared
    layer once per repeat); raises for a family or layer kind the
    reference does not have."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch runs the {', '.join(PORTED_FAMILIES)} families; "
            f"{cfg.name} is {cfg.family!r}")
    specs = []
    for stage in cfg.plan():
        for _ in range(stage.repeat):
            for spec in stage.layers:
                if spec.kind not in LAYER_KINDS or \
                        spec.ffn not in FFN_KINDS:
                    raise NotImplementedError(f"layer spec {spec}")
                specs.append(spec)
    return specs


def layer_stacks(cfg: ModelConfig) -> List[str]:
    """The reference's stacked leaf of each entry of ``params["layers"]``,
    in order: ``stage{s}/layer{j}`` (its ``init`` stacks each layer of a
    stage's block over the stage's repeats)."""
    return [f"stage{si}/layer{j}" for si, stage in enumerate(cfg.plan())
            for _ in range(stage.repeat)
            for j, spec in enumerate(stage.layers) if not spec.shared]


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """The parameters of every application, in ``layer_specs`` order: the
    next dict of ``params["layers"]``, or for a shared layer its one dict
    under ``stage{s}_shared``."""
    out, own = [], iter(params["layers"])
    for si, stage in enumerate(cfg.plan()):
        for _ in range(stage.repeat):
            for j, spec in enumerate(stage.layers):
                out.append(params[f"stage{si}_shared"][f"layer{j}"]
                           if spec.shared else next(own))
    if next(own, None) is not None:
        raise ValueError(f"params hold more layers than {cfg.name}'s plan")
    return out


def layer_names(cfg: ModelConfig) -> List[str]:
    """The name in the parameter tree of every application's parameters,
    in ``layer_specs`` order: ``layers/[i]``, or ``stage{s}_shared/layer{j}``
    for a shared layer (``layer_params``)."""
    out, k = [], 0
    for si, stage in enumerate(cfg.plan()):
        for _ in range(stage.repeat):
            for j, spec in enumerate(stage.layers):
                if spec.shared:
                    out.append(f"stage{si}_shared/layer{j}")
                else:
                    out.append(f"layers/[{k}]")
                    k += 1
    return out


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init(gen: torch.Generator, cfg: ModelConfig, *, keep=None) -> Params:
    """Random parameters with the reference's scales: embed x0.02,
    unembed and projections /sqrt(fan_in), norms and biases zero, made
    on ``gen``'s device (``layers.ShapesOnly()`` for ``gen``: on the
    ``meta`` device, no memory). The numbers differ from
    ``jax.random``'s; tests that compare with the reference import its
    parameters instead (``models.convert``). A MoE layer's router and a
    Mamba2 layer's ``A_log``, ``D`` and ``dt_bias`` are float32 in any
    model dtype, as the reference's. With ``mtp_depth`` the MTP module
    is ``params["mtp"]``.

    ``keep(name, part)`` (``convert.local_tp_keep``: a rank's block)
    takes each top-level leaf, each layer's parameters and the MTP module
    as they are made, by their name in the tree (``embed``,
    ``layers/[i]``, ``stage{s}_shared/layer{j}``, ``mtp``), and what it
    returns is kept: the whole model is never held at once. The numbers
    are those of a call without it."""
    layer_specs(cfg)                                # raises if not ported
    keep = keep or (lambda name, part: part)
    dt = getattr(torch, cfg.dtype)
    Vp, d = cfg.padded_vocab_size, cfg.d_model
    params: Params = {
        "embed": keep("embed", L.normal_param(gen, (Vp, d), dt, 0.02)),
        "unembed": keep("unembed", L.normal_param(gen, (d, Vp), dt,
                                                  1.0 / d ** 0.5)),
        "final_ln": keep("final_ln", torch.zeros(d, dtype=dt,
                                                 device=gen.device)),
        "layers": [],
    }
    for si, stage in enumerate(cfg.plan()):
        shared = {f"layer{j}": keep(f"stage{si}_shared/layer{j}",
                                    _init_layer(gen, spec, cfg))
                  for j, spec in enumerate(stage.layers) if spec.shared}
        if shared:
            params[f"stage{si}_shared"] = shared
        for _ in range(stage.repeat):
            for spec in stage.layers:
                if not spec.shared:
                    params["layers"].append(keep(
                        f"layers/[{len(params['layers'])}]",
                        _init_layer(gen, spec, cfg)))
    if cfg.mtp_depth:
        params["mtp"] = keep("mtp", {
            "proj": L.normal_param(gen, (2 * d, d), dt, 1.0 / (2 * d) ** 0.5),
            "ln_h": torch.zeros(d, dtype=dt, device=gen.device),
            "ln_e": torch.zeros(d, dtype=dt, device=gen.device),
            **_init_layer(gen, MTP_SPEC, cfg)})
    return params


def _init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig
                ) -> Params:
    if spec.kind == "mamba":
        p = {"attn": SSM.init_mamba(gen, cfg)}
    elif spec.kind == "mla":
        p = {"attn": L.init_mla(gen, cfg)}
    else:
        p = {"attn": L.init_attn(gen, cfg, cross=spec.kind == "cross_attn")}
    if spec.ffn == "moe":
        p["ffn"] = MOE.init_moe(gen, cfg)
    elif spec.ffn == "dense":
        # the MoE family's leading dense layers are dense_d_ff wide
        ff = cfg.dense_d_ff if (cfg.family == "moe" and cfg.dense_d_ff) \
            else None
        p["ffn"] = L.init_ffn(gen, cfg, d_ff=ff)
    return p


def _apply_layer(spec: LayerSpec, p: Params, x: torch.Tensor, cfg, ctx, *,
                 positions=None, cache=None, cache_pos=None,
                 cross_kv=None, return_cache=False):
    """One layer -> (x, cache, aux); aux is None but for a MoE FFN. A
    cross-attention layer reads ``cross_kv`` and its cache is ``()``."""
    if spec.kind == "mamba":
        x, nc = SSM.mamba_block(p["attn"], x, cfg, ctx, cache=cache,
                                return_state=return_cache)
    elif spec.kind == "cross_attn":
        if cross_kv is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"image_embeds")
        x, _ = L.attn_block(p["attn"], x, cfg, ctx, cross_kv=cross_kv)
        nc = ()
    elif spec.kind == "mla":
        x, nc = L.mla_block(p["attn"], x, cfg, ctx, positions=positions,
                            cache=cache, cache_pos=cache_pos,
                            return_kv=return_cache)
    else:
        x, nc = L.attn_block(p["attn"], x, cfg, ctx, window=spec.window,
                             positions=positions, cache=cache,
                             cache_pos=cache_pos, return_kv=return_cache)
    if spec.ffn == "moe":
        x, aux = MOE.moe_block(p["ffn"], x, cfg, ctx)
        return x, nc, aux
    if spec.ffn == "dense":
        x = L.ffn_block(p["ffn"], x, cfg, ctx)
    return x, nc, None


# --------------------------------------------------------------------------
# forward (teacher-forced)
# --------------------------------------------------------------------------
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ModelContext, *, image_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (hidden [B, S, d], aux_loss); ``image_embeds``
    ``[B, N, d]`` for the cross-attention layers. With the
    ``seq_shard_residual`` hint on a model axis of M ranks that S
    divides, ``hidden`` is this rank's S/M positions
    (``tensor_parallel``)."""
    S = tokens.shape[1]
    ctx = TP.for_sequence(ctx, S)
    fs = FS.plan(cfg, ctx)
    x = TP.embed(params["embed"], tokens, TP.plan(cfg, ctx))
    positions = torch.arange(S, device=x.device)[None, :]
    aux_total = torch.zeros((), device=x.device)
    for spec, name, p in zip(layer_specs(cfg), layer_names(cfg),
                             layer_params(params, cfg)):
        if ctx.remat == "full":
            x, aux = checkpoint(_train_layer, spec, p, x, cfg, ctx,
                                positions, image_embeds, fs, name,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _train_layer(spec, p, x, cfg, ctx, positions,
                                  image_embeds, fs, name)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, aux_total


def _train_layer(spec, p, x, cfg, ctx, positions, image_embeds, fs, name):
    # the layer's data-cut leaves gathered here, inside the recomputed
    # function under remat: the backward gathers them again
    x, _, aux = _apply_layer(spec, FS.gather(p, name, fs), x, cfg, ctx,
                             positions=positions, cross_kv=image_embeds)
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
             vocab_size: int, chunk: int = 512,
             split: Optional[TP.Plan] = None) -> torch.Tensor:
    """Mean cross-entropy of ``x [B, S, d] @ unembed [d, Vp]`` against
    ``targets [B, S]``, logits past ``vocab_size`` (the padding) masked
    to -1e30. One chunk of ``chunk`` positions at a time, each under
    ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    float32 logits instead of keeping them; ``chunk = S`` when S is
    not a multiple of it or not above it. With ``split`` (a
    ``tensor_parallel.Plan`` whose vocabulary splits) ``unembed`` is this
    rank's ``Vp/M`` columns: ``x`` enters the model axis (its positions
    gathered under ``split.seq``) and each chunk's reductions run over
    it (``tensor_parallel.vocab_ce``). Positions of ``x`` past the
    targets' are dropped (the MTP layer's last one under the
    sequence-split residual, ``lm_loss``)."""
    if split is not None:
        x = TP.enter(x, split)
    x = x[:, :targets.shape[1]]
    B, S, _ = x.shape
    if S % chunk or S <= chunk:
        chunk = S
    targets = targets.long()
    if split is not None:
        fn, extra = TP.vocab_ce, (vocab_size, split)
    else:
        fn = _ce_chunk
        extra = (torch.arange(unembed.shape[1], device=x.device)
                 < vocab_size,)
    losses = [checkpoint(fn, x[:, i:i + chunk], unembed,
                         targets[:, i:i + chunk], *extra,
                         use_reentrant=False, preserve_rng_state=False)
              for i in range(0, S, chunk)]
    return torch.stack(losses).mean()               # [n, B, chunk]


def mtp_input(params: Params, hidden: torch.Tensor, targets: torch.Tensor,
              cfg: ModelConfig, split: TP.Plan = TP.WHOLE) -> torch.Tensor:
    """The MTP layer's input ``[B, S - 1, d]``: the final hidden state of
    positions 0..S-2 and the embedding of their next tokens
    (``targets[:, :-1]``; ``split``: the embedding's split), each normed,
    concatenated and projected (``params["mtp"]`` whole on the data
    axis: ``lm_loss`` gathers it). Under ``split.seq`` ``hidden`` is
    this rank's S/M positions and so is the input, of all S positions
    (the last one's next token is ``targets[:, -1]``)."""
    p = params["mtp"]
    if split.seq:
        h, nxt = hidden, targets
    else:
        h, nxt = hidden[:, :-1], targets[:, :-1]
    h = L.rms_norm(h, p["ln_h"], cfg.norm_eps)
    e = L.rms_norm(TP.embed(params["embed"], nxt, split), p["ln_e"],
                   cfg.norm_eps)
    return torch.cat([h, e], dim=-1) @ p["proj"]


#: ``lm_loss``'s weights of the MTP and load-balance terms (the reference's)
MTP_WEIGHT, AUX_WEIGHT = 0.3, 0.001


def total_loss(ce: torch.Tensor, aux: torch.Tensor,
               mtp: Optional[torch.Tensor] = None, *,
               mtp_weight: float = MTP_WEIGHT,
               aux_weight: float = AUX_WEIGHT) -> torch.Tensor:
    """``ce + mtp_weight * mtp + aux_weight * aux``, in ``lm_loss``'s
    order (no MTP term without ``mtp``)."""
    loss = ce
    if mtp is not None:
        loss = loss + mtp_weight * mtp
    return loss + aux_weight * aux


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, ctx: ModelContext, *,
            mtp_weight: float = MTP_WEIGHT, aux_weight: float = AUX_WEIGHT
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch["tokens"] [B, S + 1]`` (and
    ``batch["image_embeds"]`` for the VLM family): the first S tokens
    in, the last S as targets. Returns (loss, {"ce", "aux", ["mtp"],
    "loss"}), loss = ce + ``mtp_weight`` * mtp + ``aux_weight`` * aux;
    aux is the MoE layers' summed load-balance loss, 0 without MoE.

    With ``mtp_depth`` and ``params["mtp"]``, the reference's MTP loss
    (``model.py:211-222``): position t's final hidden state and the
    embedding of token t + 1, each normed, concatenated and projected,
    go through the MTP layer (GQA attention at positions 0..S-2 and a
    dense FFN, no final norm) to predict token t + 2. Its ``fused_ce``
    chunks as any other: one chunk when S - 1 is not a multiple of
    512."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux = forward(params, inputs, cfg, ctx,
                          image_embeds=batch.get("image_embeds"))
    ctx = TP.for_sequence(ctx, inputs.shape[1])
    tp, fs = TP.plan(cfg, ctx), FS.plan(cfg, ctx)
    vocab = tp if tp.vocab or tp.seq else None
    # gathered once over the data axis for both cross-entropies
    unembed = FS.gather(params["unembed"], "unembed", fs)
    ce = fused_ce(hidden, unembed, targets, cfg.vocab_size, split=vocab)
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        # gathered over the data axis; its layer splits over the model
        # axis as the model's GQA and dense FFN blocks do. Under the
        # sequence-split residual the layer runs on all S positions, each
        # rank's S/M of them: the last one (whose target is past the
        # batch) changes no earlier position and leaves the loss
        pm = FS.gather(params["mtp"], "mtp", fs)
        hm = mtp_input(dict(params, mtp=pm), hidden, targets, cfg, tp)
        positions = torch.arange(hm.shape[1] * (tp.ways if tp.seq else 1),
                                 device=hm.device)[None, :]
        hm, _, _ = _apply_layer(MTP_SPEC, pm, hm, cfg, ctx,
                                positions=positions)
        mtp = fused_ce(hm, unembed, targets[:, 1:], cfg.vocab_size,
                       split=vocab)
        metrics["mtp"] = mtp
    loss = total_loss(ce, aux, metrics.get("mtp"), mtp_weight=mtp_weight,
                      aux_weight=aux_weight)
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------------
# serve: cache construction, prefill, decode
# --------------------------------------------------------------------------
def cache_rows(spec: LayerSpec, cache_len: int) -> int:
    """An attention or MLA cache's rows: ``cache_len``, or the ring of a
    sliding-window layer, ``min(window, cache_len)`` (the reference's
    ``_cache_spec_for_layer``)."""
    return min(spec.window, cache_len) if spec.window else cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: Optional[torch.device] = None,
               ctx: Optional[ModelContext] = None) -> Cache:
    """Zeroed caches, one per application: (k, v) for attention, the
    latent (c_kv, k_pe) for MLA, (conv tail, state) for Mamba2, () for
    cross-attention, each this rank's part on ``ctx``'s mesh, as the
    reference's ``cache_specs`` cuts them (``distributed.sharding``):
    where the model axis splits the attention (``tensor_parallel.plan``)
    (k, v) hold this rank's KV heads; where it splits the Mamba2 heads,
    (conv tail, state) hold this rank's (``ssm.init_mamba_cache``); where
    it splits the MLA heads and divides both latent widths, the latent
    holds this rank's 1/M of its last dimension (``layers.latent_ways``).
    An attention layer's (k, v) may be cut on the sequence instead
    (``layers.cache_axis``), each rank holding its contiguous ``rows /
    W`` of the ring, a ``layers.ContextSplit``: over the D data ranks
    where the batch is the same on every one of them
    (``ctx.batch_replicated``: it does not divide over them), else over
    the M model ranks where the attention runs context-parallel (its KV
    heads do not divide over them). The Mamba2 state stays whole over
    the data axes (the reference cuts its heads there, ROADMAP §3)."""
    dev = device or current_device()
    tp = TP.plan(cfg, ctx)
    kv = cfg.num_kv_heads // tp.ways if tp.attn else cfg.num_kv_heads
    lat = L.latent_ways(cfg, tp)
    dt = getattr(torch, cfg.dtype)
    caches: Cache = []
    for spec in layer_specs(cfg):
        if spec.kind == "mamba":
            caches.append(SSM.init_mamba_cache(
                cfg, batch, dt, device=dev,
                ways=tp.ways if tp.mamba else 1))
            continue
        if spec.kind == "cross_attn":
            caches.append(())
            continue
        rows = cache_rows(spec, cache_len)
        if spec.kind == "mla":
            caches.append(tuple(torch.zeros(
                (batch, rows, n // lat), dtype=dt, device=dev)
                for n in (cfg.kv_lora_rank, cfg.qk_rope_head_dim)))
            continue
        axis = L.cache_axis(cfg, ctx, rows)
        W = L.context_cut(ctx, axis)[0] if axis else 1
        shape = (batch, rows // W, kv, cfg.head_dim)
        pair = tuple(torch.zeros(shape, dtype=dt, device=dev)
                     for _ in range(2))
        caches.append(L.context_split(pair, axis) if axis else pair)
    return caches


def _fold_prefill_cache(spec: LayerSpec, raw, cfg, cache_len: int,
                        ctx: Optional[ModelContext] = None):
    """Raw prefill (k, v) or MLA's (c_kv, k_pe) -> cache tensors of
    ``cache_rows`` rows, zero where no position was written: position t
    of the prompt goes to row ``t % rows``, so a sliding-window layer
    keeps the prompt's last ``rows`` positions on the ring
    ``decode_step`` writes. Where ``init_cache`` cuts an attention
    layer's (k, v) on the sequence (``layers.cache_axis``: over the data
    axes or the model axis), this rank's rows of that ring, a
    ``layers.ContextSplit``. A Mamba2 layer's (tail, state) -> the tail
    in the model dtype and the state; a cross-attention layer's () stays
    ()."""
    dt = getattr(torch, cfg.dtype)
    if spec.kind == "mamba":
        tail, state = raw
        return (tail.to(dt), state)
    rows = cache_rows(spec, cache_len)

    def ring(t):
        S = t.shape[1]
        keep = min(S, rows)
        out = t.new_zeros((t.shape[0], rows) + t.shape[2:], dtype=dt)
        start = (S - keep) % rows           # the row of position S - keep
        head = min(keep, rows - start)      # rows up to the ring's end
        out[:, start:start + head] = t[:, S - keep:S - keep + head]
        if keep > head:                     # the rest wraps to row 0
            out[:, :keep - head] = t[:, S - keep + head:]
        return out
    folded = tuple(ring(t) for t in raw)
    axis = L.cache_axis(cfg, ctx, rows) if folded and spec.kind != "mla" \
        else None
    if axis:
        W, r, _ = L.context_cut(ctx, axis)
        n = rows // W
        return L.context_split(tuple(t[:, r * n:(r + 1) * n].clone()
                                     for t in folded), axis)
    return folded


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ModelContext, *, cache_len: int,
            image_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[Cache, torch.Tensor]:
    """Teacher-forced pass emitting decode caches + last-position logits
    (float32, [B, padded_vocab], the same on every rank of a model
    axis)."""
    S = tokens.shape[1]
    ctx = TP.for_sequence(ctx, S)
    tp, fs = TP.plan(cfg, ctx), FS.plan(cfg, ctx)
    x = TP.embed(params["embed"], tokens, tp)
    positions = torch.arange(S, device=x.device)[None, :]
    caches: Cache = []
    for spec, name, p in zip(layer_specs(cfg), layer_names(cfg),
                             layer_params(params, cfg)):
        x, raw, _ = _apply_layer(spec, FS.gather(p, name, fs), x, cfg, ctx,
                                 positions=positions, cross_kv=image_embeds,
                                 return_cache=True)
        caches.append(_fold_prefill_cache(spec, raw, cfg, cache_len, ctx))
    x = L.rms_norm(TP.gather_seq(x, tp), params["final_ln"], cfg.norm_eps)
    return caches, _logits(x[:, -1], params["unembed"], tp, fs)


def _logits(x: torch.Tensor, unembed: torch.Tensor, tp: TP.Plan,
            fs: FS.Plan) -> torch.Tensor:
    """float32 [B, padded_vocab] of x [B, d], ``unembed`` gathered over
    the data axis and the logits over the model axis where the vocabulary
    splits."""
    unembed = FS.gather(unembed, "unembed", fs)
    return TP.gather_vocab((x @ unembed).float(), tp)


def decode_step(params: Params, caches: Cache, token: torch.Tensor,
                pos: int, cfg: ModelConfig, ctx: ModelContext, *,
                image_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[Cache, torch.Tensor]:
    """One serve step: token [B, 1] at position ``pos``. Writes the
    attention and MLA caches in place and returns the caches (a Mamba2
    layer's replaced) with the float32 logits."""
    ctx = TP.for_sequence(ctx, token.shape[1])
    tp, fs = TP.plan(cfg, ctx), FS.plan(cfg, ctx)
    x = TP.embed(params["embed"], token, tp)
    positions = torch.full(token.shape, pos, device=x.device)
    new_caches: Cache = []
    for spec, name, p, c in zip(layer_specs(cfg), layer_names(cfg),
                                layer_params(params, cfg), caches):
        x, nc, _ = _apply_layer(spec, FS.gather(p, name, fs), x, cfg, ctx,
                                positions=positions, cache=c, cache_pos=pos,
                                cross_kv=image_embeds)
        new_caches.append(nc)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return new_caches, _logits(x[:, -1], params["unembed"], tp, fs)
