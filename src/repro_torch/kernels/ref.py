"""Plain PyTorch versions of the kernels (one for both flash kernels).

Same semantics as the reference's oracles (``repro/kernels/ref.py``).
The ``ops`` wrappers run these for tensors on the CPU; on the card they
are what each CUDA kernel is held against.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.jpeg import tables as T

IDCT64 = T.idct64_matrix().astype(np.float32)   # [64, 64] kron(C.T, C.T)
_matrix_on: Dict[torch.device, torch.Tensor] = {}


def idct_matrix(like: torch.Tensor) -> torch.Tensor:
    """IDCT64 on ``like``'s device (copied there once per device)."""
    if like.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        # TF32 rounds the product's inputs to 10 mantissa bits: errors of
        # several pixel levels, far outside the kernels' tolerance
        raise RuntimeError("the plain IDCT needs full FP32 matmul; "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    m = _matrix_on.get(like.device)
    if m is None:
        m = torch.from_numpy(IDCT64).to(like.device)
        _matrix_on[like.device] = m
    return m


def idct8x8(x: torch.Tensor) -> torch.Tensor:
    """x: [N, 64] f32 dequantized coefficient rows -> spatial rows."""
    return x @ idct_matrix(x).T


def dequant_idct(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x: [N, 64] raw coefficients; q: [64] quant table row."""
    pix = (x * q[None, :]) @ idct_matrix(x).T + 128.0
    return torch.clamp(pix, 0.0, 255.0)


def decode_batch(x: torch.Tensor, qidx: torch.Tensor,
                 qtab: torch.Tensor) -> torch.Tensor:
    """x: [N, 64] raw rows; qidx: [N] i32 table index; qtab: [T, 64]."""
    pix = (x * qtab[qidx.long()]) @ idct_matrix(x).T + 128.0
    return torch.clamp(pix, 0.0, 255.0)


def ycbcr2rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return r, g, b


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The flash kernel's oracle (reference ``kernels/ref.py:37``) in the
    wrapper's layout: q [B, S, H, D], k and v [B, S, KV, D] -> [B, S, H, D].

    Query head h attends with KV head h // (H // KV), as the reference's
    ``jnp.repeat`` of the KV heads gives. Scores, softmax and the PV
    product run in float32; the output is cast to q's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
