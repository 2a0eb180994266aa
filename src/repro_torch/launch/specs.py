"""Meta-tensor input stand-ins for every (arch x shape) cell.

Port of the reference's ``launch/specs.py``. Every tensor here is on
the ``meta`` device: shapes and dtypes, no memory, so nothing here
allocates on any device. The port's ``decode_step`` takes the position
as a Python int; the dry-run counts it as the reference's int32 scalar
(``SCALAR_BYTES``). Configs with image embeddings
(``cross_attn_every``) raise, as ``model.lm_loss`` does: their family is
not ported (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model

META = torch.device("meta")
#: bytes of the reference's int32 decode position, a 0-d argument there
SCALAR_BYTES = 4


def _no_image_embeds(cfg: ModelConfig) -> None:
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name} needs image embeddings, which the port does not "
            f"run yet (ROADMAP queue 1 item 4)")


def _tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    _no_image_embeds(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(B, S + 1)}


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    _no_image_embeds(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(B, S)}


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """One new token against a cache of length shape.seq_len, written at
    the cache's last row."""
    _no_image_embeds(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {
        "caches": model.init_cache(cfg, B, S, device=META),
        "token": _tokens(B, 1),
        "pos": S - 1,
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (train; fwd+bwd) or 2·N·D (serve; fwd only),
    N = active params for MoE."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
