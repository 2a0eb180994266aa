"""Meta-tensor input stand-ins for every (arch x shape) cell.

Port of the reference's ``launch/specs.py``. Every tensor here is on
the ``meta`` device: shapes and dtypes, no memory, so nothing here
allocates on any device. The port's ``decode_step`` takes the position
as a Python int; the dry-run counts it as the reference's int32 scalar
(``SCALAR_BYTES``). The VLM family's vision tower is a stub in both
packages: its inputs carry the patch embeddings, ``image_embeds [B,
num_image_tokens, d_model]`` in the model dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model

META = torch.device("meta")
#: bytes of the reference's int32 decode position, a 0-d argument there
SCALAR_BYTES = 4


def _tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=META)


def _with_image_embeds(cfg: ModelConfig, B: int, inputs: Dict[str, Any]
                       ) -> Dict[str, Any]:
    if cfg.cross_attn_every:
        inputs["image_embeds"] = torch.empty(
            (B, cfg.num_image_tokens, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=META)
    return inputs


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    return _with_image_embeds(cfg, B, {"tokens": _tokens(B, S + 1)})


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    return _with_image_embeds(cfg, B, {"tokens": _tokens(B, S)})


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, *,
                  ctx=None) -> Dict[str, Any]:
    """One new token against a cache of length shape.seq_len, written at
    the cache's last row; the caches of a rank of ``ctx``'s mesh
    (``model.init_cache``: its KV and Mamba2 heads where the model axis
    splits them, its rows of an attention cache's sequence where the KV
    heads do not divide over it)."""
    B, S = shape.global_batch, shape.seq_len
    return _with_image_embeds(cfg, B, {
        "caches": model.init_cache(cfg, B, S, device=META, ctx=ctx),
        "token": _tokens(B, 1),
        "pos": S - 1,
    })


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (train; fwd+bwd) or 2·N·D (serve; fwd only),
    N = active params for MoE."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
