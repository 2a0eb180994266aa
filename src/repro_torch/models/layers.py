"""Transformer layers: RMSNorm, RoPE, GQA self- and cross-attention with
a KV cache, MLA with a latent cache, SwiGLU.

Port of the reference's ``models/layers.py`` (norms ``:96-106``, RoPE
``:112-126``, attention ``:132-277``, the attention block ``:283-376``,
MLA ``:382-470``, the FFN block ``:476-496``) for one device. Functions
take parameters as plain dicts of tensors and keep the reference's
layouts: activations ``[B, S, d]``, q ``[B, S, H, D]``, k and v ``[B,
S, KV, D]``, caches ``[B, S_cache, KV, D]``.

``attention`` has three cases, chosen by shape and device:

* ``Sq == 1`` (decode): one query row against the cache in float32 with
  ``kv_len`` masking, plain tensor ops; on a cache cut on the sequence
  over ranks (``ContextSplit``: over the data axes for a batch of 1, over
  the model axis for a context-parallel block) each rank's part of the
  softmax, merged over them (``merge_softmax_parts``);
* causal or full self-attention over a whole sequence on a CUDA device
  (``Sq == Skv``, offsets 0, no ``kv_len``, ``window == 0``, default
  scale, ``ctx.flash_kernel``): the hand-written flash kernel
  (``kernels.ops.flash_attention``), where the reference leaves the
  ``vmem_flash`` region to XLA;
* everything else, and every call on the CPU: the chunked online-softmax
  loop of the reference, which is also the plain version the card run
  holds the kernel path against. Its KV-block body runs in the
  ``vmem_flash`` scope (``named_scope``), as the reference's does:
  the dry-run (``launch.dryrun_lib``), which counts on ``meta`` tensors
  and so always takes this loop, can count the scope's ops as the flash
  kernels move them. A context-parallel block's rows (``attn_block``:
  ``S/M`` queries at ``q_offset = rank · S/M`` against all ``S`` keys)
  take this loop on the card too.

A training call (grad enabled, inputs that require grad) takes the
same route. On the card its forward is the same one kernel launch and
its backward the float32 attention gradient of
``ops._FlashAttention`` (plain tensor math, no kernel); the chunked
loop is differentiated by autograd, as XLA differentiates the
reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

_SCOPES = threading.local()


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """Mark the enclosed ops as inside scope ``name`` on this thread (the
    reference's ``jax.named_scope``). Nothing reads it but the dry-run's
    counting mode (``current_scopes``); it changes no result and no route."""
    outer = current_scopes()
    _SCOPES.stack = outer + (name,)
    try:
        yield
    finally:
        _SCOPES.stack = outer


def current_scopes() -> Tuple[str, ...]:
    """The scopes the calling thread is in, outermost first."""
    return getattr(_SCOPES, "stack", ())


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Runtime knobs threaded through the model.

    Without a mesh (the default) every call runs on one device. ``mesh``
    is a ``torch.distributed.device_mesh.DeviceMesh`` over the live
    process group whose ``mesh_dim_names`` are the reference's axis names
    (``launch.mesh.make_host_mesh``, ``distributed.sharding
    .make_context``); each rank holds its batch rows of ``data_axes``.
    Over ``model_axis`` the model runs tensor-parallel
    (``distributed.tensor_parallel``: each rank holds its heads, FFN
    hidden units and vocabulary rows, ``tp_size`` ways), and with
    ``moe_impl="ep"`` a MoE block runs the expert-parallel path
    (``models.moe.routed_ep``), each rank holding its experts. The
    reference's two layout hints: ``seq_shard_residual`` keeps each
    rank's ``S/M`` positions of the residual between blocks
    (``seq_parallel``); ``no_tp`` splits nothing over the model axis,
    which ``make_context`` then adds to ``data_axes``. The caller's
    ``batch_replicated`` says that every data rank holds the whole batch
    (one that does not divide over them, such as a long-context decode's
    one row): the decode caches are then cut on the sequence over the
    data axes, as the reference's ``cache_specs`` cuts them
    (``context_ways``)."""
    mesh: Any = None
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)
    moe_impl: str = "dense"            # dense | ep (needs a mesh)
    # routed_ep's buffer: ceil(T·k / E · capacity_factor) rows an expert
    capacity_factor: float = 1.25
    q_chunk: int = 1024
    k_chunk: int = 1024
    attn_skip_noncausal: bool = False  # skip fully masked KV blocks
    flash_kernel: bool = True          # False: plain loop on the card too
    # "full": forward recomputes each layer in the backward
    # (torch.utils.checkpoint); the reference's default is "full", the
    # port's "none" so that serving and the ViT keep their graphs
    remat: str = "none"
    # positions per chunk of the SSD scan (``models.ssm.ssd_scan``)
    ssd_chunk: int = 256
    # Megatron-style sequence parallelism of the residual between blocks
    seq_shard_residual: bool = False
    # pure data parallelism over the model axis too
    no_tp: bool = False
    # the batch is the same on every data rank (it does not divide over
    # them): the decode caches are cut on the sequence instead
    batch_replicated: bool = False

    def __post_init__(self):
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got "
                             f"{self.remat!r}")
        if self.moe_impl not in ("dense", "ep"):
            raise ValueError(f"moe_impl must be 'dense' or 'ep', got "
                             f"{self.moe_impl!r}")

    def _axis_size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def model_axis_size(self) -> int:
        """Ranks along the model axis (1 without a mesh)."""
        return 1 if self.mesh is None else self._axis_size(self.model_axis)

    @property
    def tp_size(self) -> int:
        """The ranks the model's split leaves are split over: the model
        axis's, 1 with ``no_tp`` (``distributed.tensor_parallel``)."""
        return 1 if self.no_tp else self.model_axis_size

    @property
    def seq_parallel(self) -> bool:
        """Whether the residual between blocks is each rank's share of the
        positions (``seq_shard_residual`` over more than one rank; a call
        whose positions do not divide turns it off,
        ``tensor_parallel.for_sequence``)."""
        return self.seq_shard_residual and self.tp_size > 1

    @property
    def data_axes_size(self) -> int:
        """Ranks along the batch axes together (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return math.prod(self._axis_size(a) for a in self.data_axes)


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
           w2: torch.Tensor, split: Optional[TP.Plan] = None
           ) -> torch.Tensor:
    """``silu(x @ w1) * (x @ w3) @ w2``. With ``split`` (a
    ``tensor_parallel.Plan``) the weights are this rank's hidden units:
    ``x`` enters the model axis before the products and the partial
    outputs leave it summed."""
    if split is not None:
        return TP.leave(swiglu(TP.enter(x, split), w1, w3, w2), split)
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
    kv_groups: Tuple = (),           # groups the KV rows are cut over
) -> torch.Tensor:
    """softmax(q k^T · scale) v over ``[B, S, H, D]`` queries and ``[B,
    S, KV, D]`` keys and values (module docstring). In a decode call
    (``Sq == 1``) whose keys and values are this rank's rows of a cache
    cut on the sequence over ``kv_groups`` (``kv_offset`` the global
    position of its first row), each rank's part of the softmax is
    combined over them (``softmax_parts``, ``merge_softmax_parts``)."""
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
        if kv_groups:
            out = merge_softmax_parts(*softmax_parts(s, valid, v.float()),
                                      kv_groups)
            return out.reshape(B, 1, H, Dv).to(v.dtype)
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
            # the flash kernel keeps everything in this scope on chip; the
            # dry-run's counting mode reads the scope (``fused_scopes``)
            with named_scope("vmem_flash"):
                k_i = kb[:, ki]
                v_i = vb[:, ki]
                k_idx = kv_offset + ki * k_chunk + torch.arange(
                    k_chunk, device=dev)
                s = torch.einsum("bqgrd,bkgd->bgrqk", qi_q,
                                 k_i.float()) * scale
                mask = _block_mask(q_idx, k_idx, causal, window, kv_len)
                s = s.masked_fill(~mask[None, None, None], -1e30)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                # probabilities rounded to v's dtype before the PV product
                pv = torch.einsum("bgrqk,bkgd->bgrqd",
                                  p.to(v_i.dtype).float(), v_i.float())
                acc = acc * corr[..., None] + pv
                m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        # [B,KV,rep,qc,Dv] -> [B,qc,KV*rep,Dv]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dv)
                    .to(v.dtype))
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)


def softmax_parts(s: torch.Tensor, valid: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's part of a decode softmax over its rows of the keys:
    float32 scores ``s [B, KV, rep, K]``, ``valid [K]`` (the rows that
    attend) and values ``v [B, K, KV, Dv]`` -> (the rows' maximum ``m``
    ``[B, KV, rep]``, their sum of ``exp(s - m)`` ``l`` and the
    unnormalised output ``o [B, KV, rep, Dv]``). A part whose rows are
    all masked has ``m`` -1e30 and ``l``, ``o`` zero, not NaN."""
    s = torch.where(valid[None, None, None, :], s,
                    torch.tensor(-1e30, device=s.device))
    m = s.amax(dim=-1)
    p = torch.where(valid[None, None, None, :], torch.exp(s - m[..., None]),
                    torch.zeros((), device=s.device))
    return m, p.sum(dim=-1), torch.einsum("bgrk,bkgd->bgrd", p, v)


def merge_softmax_parts(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                        groups) -> torch.Tensor:
    """The softmax output ``[..., Dv]`` of the parts (``softmax_parts``)
    that the ranks of ``groups`` hold, each over its own rows of one
    key sequence: the maximum all-reduced, then each part's sum and
    output rescaled to it and summed (one all-reduce a group for both),
    through ``distributed.collectives``. The decode half of a
    context-parallel attention over any axis: the data axes for a cache
    cut on the sequence (``ContextSplit``)."""
    top = m.clone()
    for g in groups:
        top = C.all_reduce(top, g, dist.ReduceOp.MAX)
    c = torch.exp(m - top)
    both = torch.cat([(l * c)[..., None], o * c[..., None]], dim=-1)
    for g in groups:
        both = C.all_reduce(both, g)
    return both[..., 1:] / both[..., :1]


class ContextSplit(tuple):
    """An attention layer's decode cache ``(k, v)`` cut on its sequence
    over the axis that ``axis`` names (the reference's ``cache_specs``):
    the data axes (``"data"``, ``models.model.init_cache`` where the
    batch does not divide over them) or the model axis (``"model"``,
    ``ModelSplit``, where the KV heads do not divide over it): this
    rank's contiguous ``rows / W`` of the ring of the axis's ``W``
    ranks, whose global rows ``attn_block`` writes and attends to
    (``context_cut``)."""
    axis = "data"


class ModelSplit(ContextSplit):
    """A ``ContextSplit`` over the model axis."""
    axis = "model"


def context_split(pair, axis: str) -> ContextSplit:
    """``pair`` as the ``ContextSplit`` over ``axis``."""
    return (ModelSplit if axis == "model" else ContextSplit)(pair)


def cache_axis(cfg, ctx, rows: int) -> Optional[str]:
    """The axis over which an attention layer's decode cache of ``rows``
    rows is cut on its sequence, as the reference's ``cache_specs`` cuts
    it, or ``None`` (whole): the data axes where the batch is the same
    on each of their ``D`` ranks (``context_ways``) and ``rows`` divides
    over them; else the model axis where the block runs
    context-parallel (``tensor_parallel.Plan.cp``) and ``rows`` divides
    over it."""
    D = context_ways(ctx)
    if D > 1 and rows % D == 0:
        return "data"
    tp = TP.plan(cfg, ctx)
    if tp.cp and rows % tp.ways == 0:
        return "model"
    return None


def context_ways(ctx) -> int:
    """The data ranks (D) over which the attention caches' sequence is
    cut: D where the context's batch is the same on every one of more
    than one data rank (``batch_replicated``), else 1 (each rank holds
    its rows' whole caches)."""
    if ctx is None or ctx.mesh is None or not ctx.batch_replicated:
        return 1
    return ctx.data_axes_size


def context_cut(ctx, axis: str = "data") -> Tuple[int, int, Tuple]:
    """(the ranks W, this rank's index, their groups) of ``axis``: the
    cut of a ``ContextSplit`` cache over the data axes or the model
    axis."""
    if axis == "model":
        return (ctx.tp_size, ctx.mesh.get_local_rank(ctx.model_axis),
                tuple(data_parallel.model_groups(ctx)))
    return (ctx.data_axes_size, data_parallel.data_rank(ctx),
            tuple(data_parallel.data_groups(ctx)))


def row_split(S: int, q_chunk: int, ways: int) -> bool:
    """Whether a context-parallel attention over ``S`` query positions
    splits its rows over ``ways`` ranks: where its q chunks (``attention``'s
    ``nq``, one chunk when ``q_chunk`` does not divide ``S``) divide over
    them, as the reference's guard keeps the ``"model"`` entry of its
    chunk axis; elsewhere every rank attends with every row."""
    q_chunk = min(q_chunk, S)
    nq = 1 if S % q_chunk else S // q_chunk
    return nq % ways == 0


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


def init_attn(gen: torch.Generator, cfg, *, cross: bool = False) -> Params:
    """GQA attention leaves; ``cross`` (the VLM family's cross-attention
    layer) adds the 0-d ``gate``, zero, whose tanh scales the output."""
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
    if cross:
        p["gate"] = torch.zeros((), dtype=dt, device=dev)
    return p


def attn_block(
    p: Params, x: torch.Tensor, cfg, ctx: ModelContext, *,
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    cross_kv: Optional[torch.Tensor] = None,
    return_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Pre-norm attention residual block.

    Returns (y, new_cache). In decode mode (cache given), x is [B, 1, d]
    and the new k, v are written into the cache tensors IN PLACE at
    ``cache_pos`` (ring position for windowed caches); new_cache is that
    same pair. With return_kv (prefill), the raw rotated (k, v) are
    returned for the caller to fold into cache tensors.

    With ``cross_kv`` (image embeddings ``[B, N, d]``, the VLM family's
    cross-attention layer) k and v are projected from it, neither q nor
    k is rotated, attention is non-causal over the N rows in prefill
    and decode alike, no cache is read or returned, and the output is
    scaled by ``tanh(gate)``, taken in float32.

    On a model axis whose ranks split the heads (``tensor_parallel.plan``)
    each rank computes its heads, self- and cross-attention alike: ``x``
    enters the axis, the image embeddings are read as they are (whole on
    every rank, not sequence-split, no gradient), and the gate scales the
    output after the sum over the axis.

    Where the KV heads do not divide over the axis the block runs
    context-parallel (``Plan.cp``, the reference's route): each rank
    holds its column blocks of ``wq``, ``wk``, ``wv`` (and biases) and
    rows of ``wo``, computes its column blocks of q, k and v from the
    whole sequence, gathers k and v over their columns
    (``tensor_parallel.gather_dim``) and exchanges q into its ``S/M``
    contiguous rows of every head (``tensor_parallel.to_rows``) where
    the q chunks divide over the axis (``row_split``; elsewhere q is
    gathered and every rank attends with every row). RoPE is applied
    after the exchange (a column block may cut a head), and the rows
    attend at ``q_offset = rank · S/M``, so ``attention`` takes its
    chunked loop. The output returns to its column block
    (``to_columns``, or this rank's columns of every row) and meets
    ``wo``'s rows; ``leave`` sums it over the axis. A decode step gathers
    q, k and v over their columns, writes the new position on the rank
    that holds its row of a cache cut on the sequence over the model
    axis (``ModelSplit``; at a batch of 1 the cache is cut over the data
    axes instead and whole over ``model``), and merges each rank's part
    of the softmax over the axis (``merge_softmax_parts``).
    """
    B, d = x.shape[0], x.shape[2]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cross = cross_kv is not None
    tp = TP.plan(cfg, ctx)
    split, cp = tp.attn, tp.cp
    if split or cp:
        # this rank's heads, or its column blocks of every head
        want = (h * hd // tp.ways, kv * hd // tp.ways)
        if split:
            h, kv = h // tp.ways, kv // tp.ways
        if (p["wq"].shape[1], p["wk"].shape[1]) != want:
            raise ValueError(
                f"the attention leaves want this rank's {want} columns "
                f"of wq and wk (convert.local_tp_params), got wq "
                f"{tuple(p['wq'].shape)}, wk {tuple(p['wk'].shape)}")
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    # the whole sequence, on the model axis when the leaves are split
    xn = TP.enter(xn, tp) if split or cp else TP.gather_seq(xn, tp)
    S = xn.shape[1]

    q = xn @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    # the image embeddings are a batch input, whole on every rank and not
    # sequence-split: no gradient flows into them, so they need no copy
    # onto the axis (``enter`` would gather their image-token axis)
    kv_src = cross_kv if cross else xn
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    # a context-parallel block's rows: this rank's S/M from r0, or all
    rows = cp and row_split(S, ctx.q_chunk, tp.ways)
    r0 = tp.rank * (S // tp.ways) if rows else 0
    if cp:
        k, v = TP.gather_dim(k, tp, 2), TP.gather_dim(v, tp, 2)
        q = TP.to_rows(q, tp) if rows else TP.gather_dim(q, tp, 2)
    Sq = q.shape[1]
    q = q.reshape(B, Sq, h, hd)
    k = k.reshape(B, kv_src.shape[1], kv, hd)
    v = v.reshape(B, kv_src.shape[1], kv, hd)

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if not cross:
        q = apply_rope(q, positions[..., r0:r0 + Sq], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cross:
        out = attention(q, k, v, causal=False, window=0, q_offset=r0,
                        q_chunk=ctx.q_chunk, k_chunk=ctx.k_chunk,
                        use_kernel=ctx.flash_kernel)
    elif cache is not None:
        k_cache, v_cache = cache
        # a cache cut on the sequence: this rank's rows lo..lo + n of the
        # ring's W·n; a row another rank holds is written there
        n, lo, groups = k_cache.shape[1], 0, ()
        s_cache = n
        if isinstance(cache, ContextSplit):
            if S != 1:
                raise ValueError(f"a cache cut on the sequence takes one "
                                 f"position a step, got {S}")
            W, r, groups = context_cut(ctx, cache.axis)
            s_cache, lo = W * n, r * n
        wpos = cache_pos % s_cache      # ring position for windowed caches
        if lo <= wpos < lo + n:
            k_cache[:, wpos - lo:wpos - lo + S] = k.to(k_cache.dtype)
            v_cache[:, wpos - lo:wpos - lo + S] = v.to(v_cache.dtype)
        new_cache = type(cache)((k_cache, v_cache))
        kv_len = min(cache_pos + S, s_cache)
        out = attention(q, k_cache, v_cache, causal=False, window=0,
                        kv_offset=lo, kv_len=kv_len, q_chunk=ctx.q_chunk,
                        k_chunk=ctx.k_chunk, use_kernel=ctx.flash_kernel,
                        kv_groups=groups)
    else:
        out = attention(q, k, v, causal=True, window=window, q_offset=r0,
                        q_chunk=ctx.q_chunk, k_chunk=ctx.k_chunk,
                        skip_noncausal=ctx.attn_skip_noncausal,
                        use_kernel=ctx.flash_kernel)

    out = out.reshape(B, Sq, h * hd)
    if cp:
        # back to this rank's column block of every position
        out = TP.to_columns(out, tp) if rows else TP.slice_dim(out, tp, 2)
    y = out @ p["wo"]
    # back to the residual's layout: summed over the model axis when the
    # leaves are split, this rank's positions of a whole block's output
    y = TP.leave(y, tp) if split or cp else TP.slice_seq(y, tp)
    if cross:
        y = torch.tanh(p["gate"].float()).to(y.dtype) * y
    elif return_kv:
        new_cache = (k, v)
    return x + y, new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------
def init_mla(gen: torch.Generator, cfg) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = getattr(torch, cfg.dtype)
    dev = gen.device

    def w(shape):
        return normal_param(gen, shape, dt, 1.0 / math.sqrt(shape[0]))
    return {
        "wq_a": w((d, qr)),
        "q_ln": torch.zeros(qr, dtype=dt, device=dev),
        "wq_b": w((qr, h * (dn + dr))),
        "wkv_a": w((d, kvr + dr)),
        "kv_ln": torch.zeros(kvr, dtype=dt, device=dev),
        "wk_b": w((kvr, h * dn)),
        "wv_b": w((kvr, h * dv)),
        "wo": w((h * dv, d)),
        "ln": torch.zeros(d, dtype=dt, device=dev),
    }


def latent_ways(cfg, tp: TP.Plan) -> int:
    """The model-axis ranks over which an MLA layer's latent cache
    ``(c_kv, k_pe)`` is cut on its last dimension (the reference's
    ``cache_specs`` cuts ``kv_lora_rank`` and the rope dim where the axis
    divides them): ``tp.ways`` where the axis splits the MLA heads and
    divides both widths, else 1 (whole on every rank)."""
    M = tp.ways
    if M > 1 and tp.mla and cfg.kv_lora_rank % M == 0 and \
            cfg.qk_rope_head_dim % M == 0:
        return M
    return 1


def _blocks(x: torch.Tensor, dim: int, ways: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` as ``ways`` blocks, the block index
    moved to the front (a block a rank, for ``all_to_all_single``)."""
    shape = x.shape[:dim] + (ways, x.shape[dim] // ways) + x.shape[dim + 1:]
    return x.reshape(shape).movedim(dim, 0).contiguous()


def _exchange(x: torch.Tensor, tp: TP.Plan) -> torch.Tensor:
    """``[M, ...]`` blocks, block j to rank j of the model axis -> the
    blocks that arrive, in rank order (``distributed.collectives``)."""
    out = torch.empty_like(x)
    C.all_to_all_single(out, x, tp.group)
    return out


def _latent_decode(q_abs, q_pe, c_cache, pe_cache, kv_len, scale, tp):
    """The absorbed MLA decode on a latent cache cut over the model axis:
    this rank's ``h`` heads' ``q_abs [B, S, h, r]`` and ``q_pe [B, S, h,
    dr]``, its ``1/M`` of the cache's ``r`` and ``dr`` -> ``o_lat [B, S,
    h, r]`` of its heads. One all-to-all gives each rank every head's
    query over its slice; the partial scores of every head over the
    slice are reduce-scattered over the axis, each rank keeping its
    heads' sums (the float32 scores ``[B, H, S, T]`` are what moves: a
    row of them is ``H`` numbers against the cache's ``r + dr``); each
    rank takes the reference's casts and softmax over its heads; the
    probabilities, in the cache's dtype, are all-gathered, and ``a ·
    c_kv`` over the slice is every head's slice of ``o_lat``; a second
    all-to-all returns each rank its heads over the whole ``r``."""
    B, S, h, r = q_abs.shape
    M = tp.ways
    rm = c_cache.shape[-1]
    both = torch.cat([_blocks(q_abs, 3, M), _blocks(q_pe, 3, M)], dim=-1)
    got = _exchange(both, tp)                  # [M, B, S, h, rm + dm]
    q_all = got.movedim(0, 2).reshape(B, S, M * h, -1)
    s_all = torch.einsum("bshr,btr->bhst", q_all[..., :rm].float(),
                         c_cache.float()) + \
        torch.einsum("bshd,btd->bhst", q_all[..., rm:].float(),
                     pe_cache.float())
    s_mine = C.reduce_scatter(s_all, tp.group, 1)   # [B, h, S, T]
    s_mine = s_mine.to(q_abs.dtype).float() * scale
    t_idx = torch.arange(c_cache.shape[1], device=q_abs.device)
    s_mine = torch.where(t_idx < kv_len, s_mine,
                         torch.tensor(-1e30, device=q_abs.device))
    a = C.all_gather(torch.softmax(s_mine, dim=-1).to(c_cache.dtype),
                     tp.group, 1)                    # [B, H, S, T]
    o = torch.einsum("bhst,btr->bshr", a, c_cache)
    back = _exchange(_blocks(o, 2, M), tp)     # [M, B, S, h, rm]
    return back.permute(1, 2, 3, 0, 4).reshape(B, S, h, M * rm)


def mla_block(
    p: Params, x: torch.Tensor, cfg, ctx: ModelContext, *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    return_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """MLA residual block (the reference's ``mla_block``).

    Prefill and forward expand the latent to per-head ``k = [k_nope |
    k_pe]`` (``qk_nope_head_dim + qk_rope_head_dim`` wide, ``k_pe``
    shared by every head) and ``v`` (``v_head_dim``) and run the plain
    attention loop at scale ``1/sqrt(dn + dr)``: no flash kernel takes
    unequal q and v head dims or an explicit scale. With return_kv the
    raw ``(c_kv [B, S, kv_lora_rank], k_pe [B, S, qk_rope_head_dim])``
    are returned. Decode (cache given) writes them into the latent cache
    IN PLACE at ``cache_pos`` and attends in the latent space (q
    absorbed through ``wk_b``, the output through ``wv_b``), with the
    reference's casts: scores summed in the model dtype, softmax in
    float32 over the rows below ``cache_pos + S``, probabilities cast
    to the cache's dtype.

    On a model axis whose ranks split the heads (``tensor_parallel.plan``)
    each rank computes its ``h/M`` heads from its columns of ``wq_b``,
    ``wk_b`` and ``wv_b`` and its rows of ``wo``; ``wq_a``, ``q_ln``,
    ``wkv_a`` and ``kv_ln`` stay whole, so ``q_lat``, ``c_kv`` and the
    shared rope key ``k_pe`` are the same on every rank and enter the
    axis (``share``) before the heads. Under the sequence-split residual
    the block gathers its input's positions instead. Where the axis
    also divides both latent widths (``latent_ways``) each rank holds and
    writes its ``1/M`` of the latent cache's last dimension, returns that
    slice from a prefill, and decodes through ``_latent_decode``."""
    B, _, d = x.shape
    h = cfg.num_heads
    kvr = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    tp = TP.plan(cfg, ctx)
    split = tp.mla
    if split:
        h //= tp.ways
        if p["wk_b"].shape[1] != h * dn:
            raise ValueError(
                f"the MLA leaves want this rank's {h} of {cfg.num_heads} "
                f"heads (convert.local_tp_params), got wk_b "
                f"{tuple(p['wk_b'].shape)}")
    # the whole sequence on every rank
    xn = TP.gather_seq(rms_norm(x, p["ln"], cfg.norm_eps), tp)
    S = xn.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    def heads(t):
        # a tensor of the whole leaves, into this rank's heads
        return TP.share(t, tp) if split else t
    q_lat = heads(rms_norm(xn @ p["wq_a"], p["q_ln"], cfg.norm_eps))
    q = (q_lat @ p["wq_b"]).reshape(B, S, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    kv_a = xn @ p["wkv_a"]                              # [B, S, kvr + dr]
    c_kv = rms_norm(kv_a[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_pe = apply_rope(kv_a[..., kvr:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]          # [B, S, dr]

    scale = 1.0 / math.sqrt(dn + dr)
    ways = latent_ways(cfg, tp)

    def mine(t):
        # this rank's 1/M of a latent's last dimension
        n = t.shape[-1] // ways
        return t[..., tp.rank * n:(tp.rank + 1) * n] if ways > 1 else t
    new_cache = None
    if cache is not None:
        c_cache, pe_cache = cache
        if c_cache.shape[-1] != kvr // ways:
            raise ValueError(f"the MLA latent cache wants this rank's "
                             f"{kvr // ways} of {kvr} (init_cache), got "
                             f"{c_cache.shape[-1]}")
        c_cache[:, cache_pos:cache_pos + S] = mine(c_kv).to(c_cache.dtype)
        pe_cache[:, cache_pos:cache_pos + S] = mine(k_pe).to(pe_cache.dtype)
        new_cache = (c_cache, pe_cache)
        kv_len = cache_pos + S
        wk_b = p["wk_b"].reshape(kvr, h, dn)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)
        if ways > 1:
            o_lat = _latent_decode(q_abs, q_pe, c_cache, pe_cache, kv_len,
                                   scale, tp)
        else:
            s_lat = torch.einsum("bshr,btr->bhst", q_abs,
                                 c_cache.to(q_abs.dtype))
            s_pe = torch.einsum("bshd,btd->bhst", q_pe,
                                pe_cache.to(q_pe.dtype))
            s_all = (s_lat + s_pe).float() * scale
            t_idx = torch.arange(c_cache.shape[1], device=x.device)
            s_all = torch.where(t_idx < kv_len, s_all,
                                torch.tensor(-1e30, device=x.device))
            a = torch.softmax(s_all, dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", a.to(c_cache.dtype),
                                 c_cache)
        wv_b = p["wv_b"].reshape(kvr, h, dv)
        out = torch.einsum("bshr,rhd->bshd", o_lat, wv_b)
    else:
        c_h, pe_h = heads(c_kv), heads(k_pe)
        k_nope = (c_h @ p["wk_b"]).reshape(B, S, h, dn)
        v = (c_h @ p["wv_b"]).reshape(B, S, h, dv)
        k = torch.cat([k_nope, pe_h[:, :, None, :].expand(B, S, h, dr)],
                      dim=-1)
        out = attention(torch.cat([q_nope, q_pe], dim=-1), k, v,
                        causal=True, scale=scale, q_chunk=ctx.q_chunk,
                        k_chunk=ctx.k_chunk,
                        skip_noncausal=ctx.attn_skip_noncausal,
                        use_kernel=ctx.flash_kernel)

    y = out.reshape(B, S, h * dv) @ p["wo"]
    # summed over the model axis when the heads are split, this rank's
    # positions of a whole block's output
    y = TP.leave(y, tp) if split else TP.slice_seq(y, tp)
    if return_kv:
        new_cache = (mine(c_kv), mine(k_pe))
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
    (``models/layers.py:489``); on a model axis whose ranks split the FFN
    (``tensor_parallel.plan``) each rank holds its hidden units."""
    tp = TP.plan(cfg, ctx)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + swiglu(xn, p["w1"], p["w3"], p["w2"],
                      split=tp if tp.ffn else None)
