"""Transformer layers of the dense LM family: RMSNorm, RoPE, GQA
attention with a KV cache, SwiGLU.

Port of the reference's ``models/layers.py`` (norms ``:96-106``, RoPE
``:112-126``, attention ``:132-277``, the attention block ``:283-376``,
the FFN block ``:476-496``) for one device. Functions take parameters
as plain dicts of tensors and keep the reference's layouts: activations
``[B, S, d]``, q ``[B, S, H, D]``, k and v ``[B, S, KV, D]``, caches
``[B, S_cache, KV, D]``.

``attention`` has three cases, chosen by shape and device:

* ``Sq == 1`` (decode): one query row against the cache in float32 with
  ``kv_len`` masking, plain tensor ops;
* causal or full self-attention over a whole sequence on a CUDA device
  (``Sq == Skv``, offsets 0, no ``kv_len``, ``window == 0``, default
  scale, ``ctx.flash_kernel``): the hand-written flash kernel
  (``kernels.ops.flash_attention``), where the reference leaves the
  ``vmem_flash`` region to XLA;
* everything else, and every call on the CPU: the chunked online-softmax
  loop of the reference, which is also the plain version the card run
  holds the kernel path against.

A training call (grad enabled, inputs that require grad) takes the
same route. On the card its forward is the same one kernel launch and
its backward the float32 attention gradient of
``ops._FlashAttention`` (plain tensor math, no kernel); the chunked
loop is differentiated by autograd, as XLA differentiates the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Runtime knobs threaded through the model (single device; mesh and
    sharding come with the port's ``distributed`` slice)."""
    q_chunk: int = 1024
    k_chunk: int = 1024
    attn_skip_noncausal: bool = False  # skip fully masked KV blocks
    flash_kernel: bool = True          # False: plain loop on the card too
    # "full": forward recomputes each layer in the backward
    # (torch.utils.checkpoint); the reference's default is "full", the
    # port's "none" so that serving and the ViT keep their graphs
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got "
                             f"{self.remat!r}")


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


# --------------------------------------------------------------------------
# RoPE (llama-style rotate-half convention)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _block_mask(q_idx: torch.Tensor, k_idx: torch.Tensor, causal: bool,
                window: int, kv_len: Optional[int]) -> torch.Tensor:
    """[Q, K] boolean mask; True = attend."""
    m = torch.ones(q_idx.shape[0], k_idx.shape[0], dtype=torch.bool,
                   device=q_idx.device)
    if causal:
        m &= k_idx[None, :] <= q_idx[:, None]
    if window > 0:
        m &= (q_idx[:, None] - k_idx[None, :]) < window
    if kv_len is not None:
        m &= k_idx[None, :] < kv_len
    return m


def _flash_case(q, k, v, *, window, q_offset, kv_offset, kv_len, scale,
                use_kernel) -> bool:
    """Whether the call is one the flash kernel computes: self-attention
    over a whole sequence on a CUDA device, in the kernel's types."""
    return (use_kernel and q.is_cuda and q.shape[1] == k.shape[1] > 1
            and window == 0 and kv_len is None and scale is None
            and q_offset == 0 and kv_offset == 0
            and v.shape[-1] == q.shape[-1]
            and q.shape[-1] in ops.FLASH_HEAD_DIMS
            and q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16))


def attention(
    q: torch.Tensor,                 # [B, Sq, H, D]
    k: torch.Tensor,                 # [B, Skv, KV, D]
    v: torch.Tensor,                 # [B, Skv, KV, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,               # global position of q[0]
    kv_offset: int = 0,              # global position of k[0]
    kv_len: Optional[int] = None,    # valid cache length (decode)
    q_chunk: int = 1024,
    k_chunk: int = 1024,
    skip_noncausal: bool = False,
    scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    rep = H // KV
    if _flash_case(q, k, v, window=window, q_offset=q_offset,
                   kv_offset=kv_offset, kv_len=kv_len, scale=scale,
                   use_kernel=use_kernel):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device

    if Sq == 1:
        # Decode: one query row against the KV cache, in float32.
        qh = q.reshape(B, KV, rep, D).float()
        s = torch.einsum("bgrd,bkgd->bgrk", qh, k.float()) * scale
        k_idx = kv_offset + torch.arange(Skv, device=dev)
        valid = k_idx < kv_len if kv_len is not None else \
            torch.ones(Skv, dtype=torch.bool, device=dev)
        if window > 0 and kv_len is not None:
            valid &= (kv_len - 1 - k_idx) < window
        s = torch.where(valid[None, None, None, :], s,
                        torch.tensor(-1e30, device=dev))
        p = torch.softmax(s, dim=-1)                 # f32 probabilities
        out = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
        return out.reshape(B, 1, H, Dv).to(v.dtype)

    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Skv)
    nq = max(Sq // q_chunk, 1)
    nk = max(Skv // k_chunk, 1)
    # One block if not divisible (smoke shapes), as the reference does.
    if Sq % q_chunk:
        q_chunk, nq = Sq, 1
    if Skv % k_chunk:
        k_chunk, nk = Skv, 1

    qb = q.reshape(B, nq, q_chunk, KV, rep, D)
    kb = k.reshape(B, nk, k_chunk, KV, D)
    vb = v.reshape(B, nk, k_chunk, KV, Dv)
    outs = []
    for qi in range(nq):
        qi_q = qb[:, qi].float()                             # [B,qc,KV,rep,D]
        q_idx = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, rep, q_chunk), -math.inf, device=dev)
        l = torch.zeros((B, KV, rep, q_chunk), device=dev)
        acc = torch.zeros((B, KV, rep, q_chunk, Dv), device=dev)
        for ki in range(nk):
            if skip_noncausal and causal:
                # blocks wholly in the future or outside the window
                k_start = kv_offset + ki * k_chunk
                q_hi = q_offset + qi * q_chunk + q_chunk - 1
                q_lo = q_offset + qi * q_chunk
                if k_start > q_hi or (
                        window > 0 and q_lo - (k_start + k_chunk - 1)
                        >= window):
                    continue
            k_i = kb[:, ki]
            v_i = vb[:, ki]
            k_idx = kv_offset + ki * k_chunk + torch.arange(k_chunk,
                                                            device=dev)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qi_q, k_i.float()) * scale
            mask = _block_mask(q_idx, k_idx, causal, window, kv_len)
            s = s.masked_fill(~mask[None, None, None], -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # probabilities rounded to v's dtype before the PV product
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v_i.dtype).float(),
                              v_i.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        # [B,KV,rep,qc,Dv] -> [B,qc,KV*rep,Dv]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dv)
                    .to(v.dtype))
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# GQA attention block with optional KV cache for decode
# --------------------------------------------------------------------------
class ShapesOnly:
    """Stands for the generator of an ``init``: every parameter comes out
    on the ``meta`` device, shapes and dtypes without memory."""
    device = torch.device("meta")


def normal_param(gen: torch.Generator, shape, dtype: torch.dtype,
            std: float) -> torch.Tensor:
    if isinstance(gen, ShapesOnly):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


def init_attn(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    p = {
        "wq": normal_param(gen, (d, h * hd), dt, 1.0 / math.sqrt(d)),
        "wk": normal_param(gen, (d, kv * hd), dt, 1.0 / math.sqrt(d)),
        "wv": normal_param(gen, (d, kv * hd), dt, 1.0 / math.sqrt(d)),
        "wo": normal_param(gen, (h * hd, d), dt, 1.0 / math.sqrt(h * hd)),
        "ln": torch.zeros(d, dtype=dt, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dt, device=dev)
        p["bk"] = torch.zeros(kv * hd, dtype=dt, device=dev)
        p["bv"] = torch.zeros(kv * hd, dtype=dt, device=dev)
    return p


def attn_block(
    p: Params, x: torch.Tensor, cfg, ctx: ModelContext, *,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    return_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Pre-norm attention residual block.

    Returns (y, new_cache). In decode mode (cache given), x is [B, 1, d]
    and the new k, v are written into the cache tensors IN PLACE at
    ``cache_pos`` (ring position for windowed caches); new_cache is that
    same pair. With return_kv (prefill), the raw rotated (k, v) are
    returned for the caller to fold into cache tensors.
    """
    B, S, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["ln"], cfg.norm_eps)

    q = xn @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, h, hd)
    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        s_cache = k_cache.shape[1]
        wpos = cache_pos % s_cache      # ring position for windowed caches
        k_cache[:, wpos:wpos + S] = k.to(k_cache.dtype)
        v_cache[:, wpos:wpos + S] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        kv_len = min(cache_pos + S, s_cache)
        out = attention(q, k_cache, v_cache, causal=False, window=0,
                        kv_len=kv_len, q_chunk=ctx.q_chunk,
                        k_chunk=ctx.k_chunk, use_kernel=ctx.flash_kernel)
    else:
        out = attention(q, k, v, causal=True, window=window,
                        q_chunk=ctx.q_chunk, k_chunk=ctx.k_chunk,
                        skip_noncausal=ctx.attn_skip_noncausal,
                        use_kernel=ctx.flash_kernel)

    y = out.reshape(B, S, h * hd) @ p["wo"]
    if return_kv:
        new_cache = (k, v)
    return x + y, new_cache


# --------------------------------------------------------------------------
# Dense FFN block
# --------------------------------------------------------------------------
def init_ffn(gen: torch.Generator, cfg,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {
        "w1": normal_param(gen, (d, ff), dt, 1.0 / math.sqrt(d)),
        "w3": normal_param(gen, (d, ff), dt, 1.0 / math.sqrt(d)),
        "w2": normal_param(gen, (ff, d), dt, 1.0 / math.sqrt(ff)),
        "ln": torch.zeros(d, dtype=dt, device=gen.device),
    }


def ffn_block(p: Params, x: torch.Tensor, cfg,
              ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Pre-norm SwiGLU residual block. ``ctx`` is the reference's
    (``models/layers.py:489``), where it only places sharding
    constraints; on one device the block computes the same either way."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + swiglu(xn, p["w1"], p["w3"], p["w2"])
