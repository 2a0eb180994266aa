"""Small vision transformer consuming loader-fed RGB batches.

Port of the reference's ``models/vision.py``: JPEG bytes ->
(multi-worker loader) -> patches -> ViT -> classifier, built from the
port's layer library. Parameters are the reference's nested dict
(``patch_proj``, ``pos``, ``final_ln``, ``head``,
``layer{i}/{attn,ffn}/<name>``), so checkpoint leaf names match and
``convert.import_reference_vit_params`` maps one onto the other.

Attention is bidirectional without RoPE. On the card a float32 or
bfloat16 ViT at a head dim of ``ops.FLASH_HEAD_DIMS`` runs every layer's
attention through the flash kernel (one launch per layer per forward,
``layers.attention``); at other head dims, with
``ModelContext(flash_kernel=False)`` and on the CPU it runs the chunked
loop of the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ModelContext

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_hw: Tuple[int, int] = (64, 64)
    patch: int = 8
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    num_layers: int = 4
    num_classes: int = 10
    norm_eps: float = 1e-6
    dtype: str = "float32"
    qkv_bias: bool = False
    rope_theta: float = 1e4

    @property
    def num_patches(self) -> int:
        return (self.image_hw[0] // self.patch) * \
            (self.image_hw[1] // self.patch)


def init(gen: torch.Generator, cfg: ViTConfig) -> Params:
    """Random parameters from ``gen`` (made on ``gen.device``), with the
    reference's shapes and scales."""
    dt = getattr(torch, cfg.dtype)
    pdim = cfg.patch * cfg.patch * 3
    params: Params = {
        "patch_proj": L.normal_param(gen, (pdim, cfg.d_model), dt,
                                     1.0 / math.sqrt(pdim)),
        "pos": L.normal_param(gen, (cfg.num_patches, cfg.d_model), dt,
                              0.02),
        "final_ln": torch.zeros(cfg.d_model, dtype=dt, device=gen.device),
        "head": L.normal_param(gen, (cfg.d_model, cfg.num_classes), dt,
                               1.0 / math.sqrt(cfg.d_model)),
    }
    for i in range(cfg.num_layers):
        params[f"layer{i}"] = {"attn": L.init_attn(gen, cfg),
                               "ffn": L.init_ffn(gen, cfg)}
    return params


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, N, patch*patch*3] float32."""
    B, H, W, C = images.shape
    x = images.float() / 127.5 - 1.0
    x = x.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, patch * patch * C)


def forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
            ctx: ModelContext = ModelContext()) -> torch.Tensor:
    """[B, H, W, 3] uint8 images -> [B, num_classes] logits."""
    x = patchify(images, cfg.patch) @ params["patch_proj"]
    x = x + params["pos"][None]
    for i in range(cfg.num_layers):
        p = params[f"layer{i}"]
        # bidirectional attention (no causal mask, no rope for patches)
        xn = L.rms_norm(x, p["attn"]["ln"], cfg.norm_eps)
        B, S, _ = xn.shape
        q = (xn @ p["attn"]["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = (xn @ p["attn"]["wk"]).reshape(B, S, cfg.num_kv_heads,
                                           cfg.head_dim)
        v = (xn @ p["attn"]["wv"]).reshape(B, S, cfg.num_kv_heads,
                                           cfg.head_dim)
        o = L.attention(q, k, v, causal=False, q_chunk=ctx.q_chunk,
                        k_chunk=ctx.k_chunk, use_kernel=ctx.flash_kernel)
        x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
        x = L.ffn_block(p["ffn"], x, cfg, ctx)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x.mean(dim=1) @ params["head"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ViTConfig,
            ctx: ModelContext = ModelContext()):
    """Mean cross-entropy of the labels (int32, widened for ``gather``):
    returns (loss, {"loss", "acc"})."""
    logits = forward(params, batch["image"], cfg, ctx).float()
    labels = batch["label"].long()
    lz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (lz - ll).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}
