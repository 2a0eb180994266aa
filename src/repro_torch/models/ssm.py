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

from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L

Params = Dict[str, Any]
SsmCache = Tuple[torch.Tensor, torch.Tensor]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., T] -> S[..., i, j] = sum_{k=j+1..i} a_k (i >= j), -inf
    else: column j of the ``[T, T]`` broadcast of ``a`` keeps ``a_k`` for
    ``k > j`` and is summed cumulatively down the rows. The reference
    takes the difference of two cumulative sums, the same values; its
    rounding of a difference of two long sums put the float32 gradient
    of ``A_log`` 8.0e-5 of its largest element from float64's at
    ``zamba2-2.7b``'s width (2 super-blocks, 1 x 512), this form 1.8e-5
    (``tools/probe_ssd_grad_noise.py`` on an H100)."""
    T = a.shape[-1]
    ones = torch.ones(T, T, dtype=torch.bool, device=a.device)
    x = a[..., :, None].expand(*a.shape, T)              # [..., k, j]: a_k
    x = x.masked_fill(~torch.tril(ones, diagonal=-1), 0)
    s = torch.cumsum(x, dim=-2)                          # [..., i, j]
    return s.masked_fill(~torch.tril(ones), -math.inf)


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


def _rank_heads(cfg, tp: TP.Plan, p: Params, zxbcdt: torch.Tensor):
    """This rank's share of a Mamba2 block split over the model axis
    (``tp.mamba``). The reference cuts ``in_proj``'s columns ``[z | x |
    B | C | dt]`` and the conv's ``x | B | C`` channels into contiguous
    blocks, which do not line up with the heads; ``out_proj``'s rows and
    the SSD's heads do. So the rank's block of the projection's columns
    and of the conv leaves are gathered over the axis where the rule cut
    them (the backward reduce-scatters), and the rank keeps its heads of
    ``z``, ``x`` and ``dt`` with all of ``B`` and ``C`` (one group, as in
    every config; several raise). Returns ``(z, xBC, dt, conv_w, conv_b,
    A_log, D, dt_bias, gnorm)``: the conv's channels and weights are the
    rank's ``x`` channels and then ``B`` and ``C``; the whole leaves
    ``A_log`` ... ``gnorm``, the rank's heads' part, copied onto the
    axis first (``share``)."""
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"a Mamba2 block of {cfg.ssm_ngroups} B/C groups split over "
            f"the model axis")
    d_in, h, n = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
    if zxbcdt.shape[-1] != 2 * d_in + 2 * n + h:         # a column block
        zxbcdt = TP.gather_dim(zxbcdt, tp, -1)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if conv_b.shape[0] != d_in + 2 * n:                  # a channel block
        # one gather for both: [K + 1, C/M] -> [K + 1, C]
        conv = TP.gather_dim(torch.cat([conv_w, conv_b[None]]), tp, 1)
        conv_w, conv_b = conv[:-1], conv[-1]
    di, hl = d_in // tp.ways, h // tp.ways
    mine = slice(tp.rank * di, (tp.rank + 1) * di)       # in d_inner
    heads = slice(tp.rank * hl, (tp.rank + 1) * hl)

    def xbc(t):
        # t's [x | B | C] channels (last dim) -> the rank's
        return torch.cat([t[..., mine], t[..., d_in:]], dim=-1)
    z = zxbcdt[..., :d_in][..., mine]
    xBC = xbc(zxbcdt[..., d_in:2 * d_in + 2 * n])
    dtr = zxbcdt[..., 2 * d_in + 2 * n:][..., heads]
    whole = [TP.share(p[k], tp)[heads] for k in ("A_log", "D", "dt_bias")]
    return (z, xBC, dtr, xbc(conv_w), xbc(conv_b), *whole,
            TP.share(p["gnorm"], tp)[mine])


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, d_in: int, eps: float,
                tp: TP.Plan) -> torch.Tensor:
    """``layers.rms_norm`` of the gated ``y`` over all of ``d_inner`` from
    this rank's ``d_inner/M`` units: the sum of squares over the axis
    (``norm_sum``, whose backward sums too: each rank's units depend on
    every rank's)."""
    dtype = y.dtype
    y = y.float()
    var = TP.norm_sum(y.square().sum(dim=-1, keepdim=True), tp) / d_in
    return (y * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dtype)


def mamba_block(
    p: Params, x: torch.Tensor, cfg, ctx, *,
    cache: Optional[SsmCache] = None,       # (conv_state, ssm_state)
    return_state: bool = False,             # prefill state emit
) -> Tuple[torch.Tensor, Optional[SsmCache]]:
    """Pre-norm Mamba2 residual block. ``cache`` given => one-token
    decode, returning new (conv tail, state) tensors; with
    ``return_state`` (prefill) the last K-1 rows of the conv input and
    the final state.

    On a model axis whose ranks split the SSD heads
    (``tensor_parallel.plan``) each rank holds the reference device's
    block of ``in_proj``, ``conv_w``, ``conv_b`` and ``out_proj`` and
    computes its ``h/M`` heads (``_rank_heads``): ``x`` enters the axis,
    the SSD runs on the rank's heads, the gated norm sums its squares
    over the axis (``_gated_norm``) and ``out_proj``'s rows leave it
    summed. Its caches hold the rank's heads: the state ``[B, h/M, p,
    N]``, the conv tail the rank's ``x`` channels and then ``B`` and
    ``C``."""
    d_in = cfg.ssm_d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    tp = TP.plan(cfg, ctx)
    split = tp.mamba
    if split and p["out_proj"].shape[0] != d_in // tp.ways:
        raise ValueError(
            f"the Mamba2 leaves want this rank's {h // tp.ways} of {h} "
            f"heads (convert.local_tp_params), got out_proj "
            f"{tuple(p['out_proj'].shape)}")
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    # the whole sequence, on the model axis when the heads are split
    xn = TP.enter(xn, tp) if split else TP.gather_seq(xn, tp)
    B_, S, d = xn.shape
    zxbcdt = xn @ p["in_proj"]
    if split:
        z, xBC, dtr, conv_w, conv_b, A_log, D, dt_bias, gnorm = \
            _rank_heads(cfg, tp, p, zxbcdt)
        d_in, h = d_in // tp.ways, h // tp.ways
    else:
        z, xBC, dtr = _split_proj(cfg, zxbcdt)
        conv_w, conv_b = p["conv_w"], p["conv_b"]
        A_log, D, dt_bias, gnorm = p["A_log"], p["D"], p["dt_bias"], \
            p["gnorm"]

    A = -torch.exp(A_log)                                # [h]
    dt = _softplus(dtr.float() + dt_bias)

    new_cache = None
    if cache is None:
        xBC_raw = xBC
        xBC = _causal_conv(xBC, conv_w, conv_b)
        xs = xBC[..., :d_in].reshape(B_, S, h, hd)
        Bm = xBC[..., d_in:d_in + g * n].reshape(B_, S, g, n)
        Cm = xBC[..., d_in + g * n:].reshape(B_, S, g, n)
        y, hfinal = ssd_scan(xs, dt, A, Bm, Cm, ctx.ssd_chunk)
        y = y + D[None, None, :, None] * xs.float()
        if return_state:
            K = cfg.ssm_conv
            tail = xBC_raw[:, -(K - 1):] if K > 1 else xBC_raw[:, :0]
            new_cache = (tail, hfinal)
    else:
        conv_state, ssm_state = cache                    # [B,K-1,C],[B,h,hd,n]
        window = torch.cat([conv_state, xBC], dim=1)     # [B,K,C]
        yconv = torch.einsum("bkc,kc->bc", window.float(),
                             conv_w.float()) + conv_b
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
        y = y + D[None, None, :, None] * xs.float()
        new_cache = (window[:, 1:], ssm_state)

    y = y.reshape(B_, S, d_in)
    y = y * F.silu(z.float())
    if split:
        y = _gated_norm(y.to(x.dtype), gnorm, cfg.ssm_d_inner,
                        cfg.norm_eps, tp)
        return x + TP.leave(y @ p["out_proj"], tp), new_cache
    y = L.rms_norm(y.to(x.dtype), gnorm, cfg.norm_eps)
    # this rank's positions of a whole block's output
    return x + TP.slice_seq(y @ p["out_proj"], tp), new_cache


def init_mamba_cache(cfg, batch: int, dtype=torch.float32, *,
                     device: Optional[torch.device] = None,
                     ways: int = 1) -> SsmCache:
    """Zeroed (conv tail [batch, K-1, C] in ``dtype``, state [batch, h,
    head_dim, N] in float32); with ``ways`` ranks splitting the heads
    (``tensor_parallel.Plan.mamba``) a rank's: ``h/ways`` heads, and the
    tail's ``d_inner/ways`` ``x`` channels with ``B`` and ``C``
    (``mamba_block``)."""
    conv_ch = cfg.ssm_d_inner // ways + \
        2 * cfg.ssm_ngroups * cfg.ssm_state
    return (
        torch.zeros(batch, cfg.ssm_conv - 1, conv_ch, dtype=dtype,
                    device=device),
        torch.zeros(batch, cfg.ssm_heads // ways, cfg.ssm_head_dim,
                    cfg.ssm_state, dtype=torch.float32, device=device),
    )
