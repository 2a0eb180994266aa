"""Mamba2 / SSD (state-space duality) block: chunked path + O(1) decode.

Port of the reference's ``models/ssm.py`` (``_segsum`` ``:20``,
``_conv_channels`` ``:29``, ``init_mamba`` ``:33``, ``_split_proj``
``:55``, ``_causal_conv`` ``:64``, ``ssd_scan`` ``:74``, ``mamba_block``
``:134``, ``init_mamba_cache`` ``:196``) for one device: the SSD algorithm
of arXiv:2405.21060 (quadratic within a chunk, a linear recurrence
across chunks), a causal depthwise conv stem, gated RMSNorm, and the
one-token recurrent step of decode. The decode state is ``[B, heads,
head_dim, N]`` whatever the sequence length.

The reference writes the SSD's contractions as ``jnp.einsum`` of three
and four operands, which XLA contracts in the order ``opt_einsum``
picks. ``torch.einsum`` contracts left to right unless ``opt_einsum`` is
installed, so here each is written as two explicit steps in XLA's
order: ``y_diag = ((C·B) * L)·x``, ``states = B·(x * decay)``, ``y_off =
(C·h) * decay``. No intermediate is larger than the ``[b, h, chunks,
Q, Q]`` float32 decay matrix ``L``. The reference's cross-chunk
``lax.scan`` is a Python loop over the chunks with no host read.

Dtypes as the reference's: the conv's shifted adds run in the model
dtype, the scan, ``dt`` (softplus without a threshold) and the decode
state in float32, ``y`` is gated in float32 and cast to the input's
dtype before the gated norm; ``A_log``, ``D`` and ``dt_bias`` are
float32 in any model dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = Dict[str, Any]
SsmCache = Tuple[torch.Tensor, torch.Tensor]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., T] -> S[..., i, j] = sum_{k=j+1..i} a_k (i >= j), -inf
    else; the difference of two cumulative sums, as the reference's."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, -math.inf)


def _conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg) -> Params:
    """The reference's leaves, shapes, dtypes and scales (numbers from
    ``gen``, on its device; ``layers.ShapesOnly()`` gives ``meta``)."""
    d = cfg.d_model
    d_in = cfg.ssm_d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = _conv_channels(cfg)
    proj_out = 2 * d_in + 2 * g * n + h      # z, x, B, C, dt
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": L.normal_param(gen, (d, proj_out), dt, 1.0 / math.sqrt(d)),
        "conv_w": L.normal_param(gen, (cfg.ssm_conv, conv_ch), dt, 0.1),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones(h, **f32),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h,
                                                        **f32))),
        "gnorm": torch.zeros(d_in, dtype=dt, device=dev),
        "out_proj": L.normal_param(gen, (d_in, d), dt, 1.0 / math.sqrt(d_in)),
        "ln": torch.zeros(d, dtype=dt, device=dev),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_in = cfg.ssm_d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. xBC: [B, S, C]; w: [K, C]."""
    K = w.shape[0]
    out = xBC * w[-1]
    for i in range(1, K):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return F.silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold, where
    ``F.softplus`` returns x above 20."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: [b, s, h, p]; dt: [b, s, h]; A: [h] (negative);
    B, C: [b, s, g, n]. Returns (y [b, s, h, p], final_state [b, h, p,
    n]), both float32. One chunk of s when s is not a multiple of
    ``chunk``, as the reference."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if s % chunk:
        chunk = s
    nc = s // chunk

    # head-broadcast the group B/C: group i serves heads i*rep..i*rep+rep-1
    Bh = torch.repeat_interleave(B, rep, dim=2)          # [b,s,h,n]
    Ch = torch.repeat_interleave(C, rep, dim=2)

    xd = (x * dt[..., None]).float()                     # dt-discretized
    dA = (dt * A[None, None, :]).float()                 # [b,s,h]

    xc = xd.reshape(b, nc, chunk, h, p)
    Bc = Bh.float().reshape(b, nc, chunk, h, n)
    Cc = Ch.float().reshape(b, nc, chunk, h, n)
    Ac = dA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # [b,h,nc,Q]
    A_cs = torch.cumsum(Ac, dim=-1)

    # 1. intra-chunk: ((C.B) * L).x
    decay = torch.exp(_segsum(Ac))                       # [b,h,nc,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bhcqk", Cc, Bc) * decay
    del decay
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores, xc)
    del scores

    # 2. per-chunk end states: B.(x * decay)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)      # [b,h,nc,Q]
    xw = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bckhn,bckhp->bchpn", Bc, xw)  # [b,nc,h,p,n]

    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(A_cs[..., -1])               # [b,h,nc]
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # [b,nc,h,p,n]

    # 4. state contribution to outputs: (C.h) * decay
    state_decay = torch.exp(A_cs)                        # [b,h,nc,Q]
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cc, prev_states) * \
        state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, state


def mamba_block(
    p: Params, x: torch.Tensor, cfg, ctx, *,
    cache: Optional[SsmCache] = None,       # (conv_state, ssm_state)
    return_state: bool = False,             # prefill state emit
) -> Tuple[torch.Tensor, Optional[SsmCache]]:
    """Pre-norm Mamba2 residual block. ``cache`` given => one-token
    decode, returning new (conv tail, state) tensors; with
    ``return_state`` (prefill) the last K-1 rows of the conv input and
    the final state."""
    B_, S, d = x.shape
    d_in = cfg.ssm_d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = xn @ p["in_proj"]
    z, xBC, dtr = _split_proj(cfg, zxbcdt)

    A = -torch.exp(p["A_log"])                           # [h]
    dt = _softplus(dtr.float() + p["dt_bias"])

    new_cache = None
    if cache is None:
        xBC_raw = xBC
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xs = xBC[..., :d_in].reshape(B_, S, h, hd)
        Bm = xBC[..., d_in:d_in + g * n].reshape(B_, S, g, n)
        Cm = xBC[..., d_in + g * n:].reshape(B_, S, g, n)
        y, hfinal = ssd_scan(xs, dt, A, Bm, Cm, ctx.ssd_chunk)
        y = y + p["D"][None, None, :, None] * xs.float()
        if return_state:
            K = cfg.ssm_conv
            tail = xBC_raw[:, -(K - 1):] if K > 1 else xBC_raw[:, :0]
            new_cache = (tail, hfinal)
    else:
        conv_state, ssm_state = cache                    # [B,K-1,C],[B,h,hd,n]
        window = torch.cat([conv_state, xBC], dim=1)     # [B,K,C]
        yconv = torch.einsum("bkc,kc->bc", window.float(),
                             p["conv_w"].float()) + p["conv_b"]
        xBC1 = F.silu(yconv)[:, None, :]                 # [B,1,C] float32
        xs = xBC1[..., :d_in].reshape(B_, 1, h, hd)
        Bm = xBC1[..., d_in:d_in + g * n].reshape(B_, 1, g, n)
        Cm = xBC1[..., d_in + g * n:].reshape(B_, 1, g, n)
        rep = h // g
        Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1)   # [B,h,n]
        Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
        dt1 = dt[:, 0]                                   # [B,h]
        dA = torch.exp(dt1 * A[None, :])                 # [B,h]
        upd = (dt1[..., None] * xs[:, 0].float())[..., None] \
            * Bh[:, :, None, :].float()                  # [B,h,hd,n]
        ssm_state = ssm_state.float() * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch.float())[:, None]
        y = y + p["D"][None, None, :, None] * xs.float()
        new_cache = (window[:, 1:], ssm_state)

    y = y.reshape(B_, S, d_in)
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["gnorm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    return out, new_cache


def init_mamba_cache(cfg, batch: int, dtype=torch.float32, *,
                     device: Optional[torch.device] = None) -> SsmCache:
    """Zeroed (conv tail [batch, K-1, C] in ``dtype``, state [batch, h,
    head_dim, N] in float32)."""
    conv_ch = _conv_channels(cfg)
    return (
        torch.zeros(batch, cfg.ssm_conv - 1, conv_ch, dtype=dtype,
                    device=device),
        torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                    dtype=torch.float32, device=device),
    )
