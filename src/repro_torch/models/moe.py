"""Mixture-of-Experts FFN: shared experts + routed top-k.

Port of the reference's ``models/moe.py`` (``init_moe`` ``:45``,
``_route`` ``:66``, ``routed_dense`` ``:91``, ``routed_ep`` ``:109``,
``moe_block`` ``:161``). Two routes, as there:

* ``routed`` computes what the reference's dense oracle computes, the
  exact drop-free top-k combine, without running every expert over every
  token: the (token, slot) pairs are sorted by expert, each expert that
  got rows runs its SwiGLU on those rows only, and the outputs return to
  ``[T, k, d]`` order through the inverse permutation, where the gates
  weigh them and a sum over k combines them. It reads the expert counts
  to the host once a layer.
* ``routed_ep`` is the reference's production path, expert parallelism
  over the mesh's model axis (``ctx.mesh``, a ``torch.distributed``
  device mesh): each expert gets a fixed buffer of ``cap`` rows, the
  (token, slot) pairs beyond it are dropped, ``all_to_all_single`` over
  the model-axis group sends each buffer to the rank that holds its
  expert and brings the outputs back. Its shapes are fixed by ``cap``,
  so it makes no host read. It has a backward (a training step on a
  mesh): the exchanges run in reverse, the sequence slice and gather
  return the input's gradient whole on every rank, and the router's
  gradient, partial on each rank, is summed over the model axis by
  ``distributed.data_parallel``. A sequence that does not divide over
  the model axis is routed whole on every rank, the cotangent divided
  by M (the reference's transpose of its replicated output).

Over more than one data rank the dense route's load-balance aux is the
global batch's, as the reference's ``routed_dense`` under GSPMD: the
expert counts and the probabilities' sums are summed over the data
axes (``global_aux``).

No atomics on either route's forward: the combine is a gather and a
sum, so a run on the card gives the same bits every time; a backward
adds one term to each row it writes but ``routed_ep``'s discarded spare
row, so it repeats its bits too. Both return (y, aux) where
aux is the switch-style load-balance loss, float32. ``moe_block`` takes
``routed_ep`` when ``ctx.moe_impl == "ep"`` and ``ctx.mesh`` is set, as
the reference's does.

The dry-run (``launch.dryrun_lib``, ``meta`` tensors) counts
``routed_ep`` as the reference's dry-run compiles it: its context's mesh
is ``launch.mesh.RankMesh``, one rank of the mesh and no process group,
whose exchanges and gathers are counted, not run
(``distributed.collectives``; over a model axis of one rank the exchange
is a copy); every expert runs over its ``cap`` rows. ``routed``
on ``meta`` tensors (a context without a mesh, or ``moe_impl="dense"``)
has no expert choices to count, so its per-expert counts come from a
stated routing model instead of the one host read: even load, ``T·k //
E`` rows an expert and one more for each of the first ``T·k % E``
experts (``expert_rows``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg) -> Params:
    """The reference's leaves, shapes, dtypes and scales: the router
    ``[d, E]`` float32 whatever the model's dtype, expert ``w1``/``w3``
    ``[E, d, ff]`` and ``w2`` ``[E, ff, d]``, the shared experts one
    SwiGLU of width ``moe_d_ff * num_shared_experts``, ``ln`` zeros."""
    d = cfg.d_model
    E, ff = cfg.num_experts, cfg.moe_d_ff
    sh_ff = cfg.moe_d_ff * cfg.num_shared_experts
    dt = getattr(torch, cfg.dtype)
    s = lambda n: 1.0 / math.sqrt(n)
    p = {
        "router": L.normal_param(gen, (d, E), torch.float32, s(d)),
        "w1": L.normal_param(gen, (E, d, ff), dt, s(d)),
        "w3": L.normal_param(gen, (E, d, ff), dt, s(d)),
        "w2": L.normal_param(gen, (E, ff, d), dt, s(ff)),
        "ln": torch.zeros(d, dtype=dt, device=gen.device),
    }
    if cfg.num_shared_experts:
        p["sh_w1"] = L.normal_param(gen, (d, sh_ff), dt, s(d))
        p["sh_w3"] = L.normal_param(gen, (d, sh_ff), dt, s(d))
        p["sh_w2"] = L.normal_param(gen, (sh_ff, d), dt, s(sh_ff))
    return p


def route(xt: torch.Tensor, router: torch.Tensor, k: int,
          over: Optional["GlobalAux"] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: [T, d] -> (gates [T, k] in xt's dtype, idx [T, k] in
    descending probability, as ``jax.lax.top_k`` orders them, aux). With
    ``over`` (``global_aux``) the aux is the global batch's: the expert
    counts and the probabilities' sums are summed over its groups before
    their product, and divided by the global token count."""
    T = xt.shape[0]
    E = router.shape[1]
    probs = torch.softmax(xt.float() @ router, dim=-1)           # [T, E]
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style aux: E * sum_e f_e * P_e, f_e the share of the T
    # tokens' k choices that went to e (counted, so exact)
    # a one-hot sum, as the reference's, not bincount, which reads the
    # largest id to the host on the card (and runs on meta tensors, so
    # the dry-run counts it as a rank runs it)
    counts = _one_hot(idx.reshape(-1), E).sum(1)
    if over is None:
        f = counts.float() / T
        aux = E * torch.sum(f * probs.mean(0))
    else:
        # one float32 sum a group for both (the counts are exact below
        # 2^24 and carry no gradient)
        both = _GlobalSum.apply(torch.stack([counts.float(), probs.sum(0)]),
                                over.groups, over.scale)
        n = T * over.copies
        aux = E * torch.sum((both[0] / n) * (both[1] / n))
    return gates.to(xt.dtype), idx, aux


class GlobalAux(NamedTuple):
    """Where the load-balance aux is the global batch's (``global_aux``):
    the ``groups`` its sums run over, the ranks whose tokens they join
    (``copies``: the global token count is ``copies`` times a rank's),
    and the ``scale`` of its backward."""
    groups: tuple
    copies: int
    scale: float


class _GlobalSum(torch.autograd.Function):
    """``v`` summed over ``groups``; backward: the cotangent times
    ``scale``. Every rank computes the same global aux from the sum, so
    a rank's own part gets ``scale`` times its cotangent: after the
    training step averages the gradients over the data axes (D of them)
    and sums the whole leaves' over a sequence-split model axis, that is
    the gradient of the one global aux (``global_aux``)."""

    @staticmethod
    def forward(fctx, v, groups, scale):
        fctx.scale = scale
        out = v.clone()
        for g in groups:
            out = C.all_reduce(out, g)
        return out

    @staticmethod
    def backward(fctx, g):
        return g * fctx.scale, None, None


def global_aux(ctx, tp: TP.Plan, *inputs: torch.Tensor
               ) -> Optional[GlobalAux]:
    """The dense route's aux over the global batch (the reference's
    ``routed_dense`` under GSPMD, ``models/moe.py:66-103``), where the
    context's data axes have more than one rank: the sums run over the
    data axes (``no_tp``'s model axis among them). A rank routes its
    ``B/D`` rows at every position (under the sequence-split residual
    the MoE layer gathers the positions, ``moe_block``), so the global
    count is D times its own. Each of the D data ranks' losses holds the
    whole aux and the step averages their gradients, so a rank's part
    of the backward is scaled by D; on a sequence-split model axis of M
    ranks, which compute the same aux from the same positions and whose
    whole leaves' gradients the step sums, by D / M (no sum at all on
    one data rank). ``None`` on one data rank of a residual that is not
    sequence-split, and where none of ``inputs`` (the layer's input and
    router) takes a gradient: serving discards the aux."""
    groups = tuple(data_parallel.data_groups(ctx)) if ctx is not None \
        else ()
    if not (groups or tp.seq) or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in inputs):
        return None
    D = ctx.data_axes_size
    return GlobalAux(groups, D, D / (tp.ways if tp.seq else 1))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[N] ids -> [n, N] int32 with a 1 where pair j chose expert e, with
    no host read. Expert-major, so that sums and running counts over the
    pairs run along the inner dimension: CUDA's scan along an outer
    dimension runs one thread a column, 64 columns over 49,152 pairs at
    ``deepseek-moe-16b``'s prefill."""
    return (torch.arange(n, device=ids.device)[:, None] == ids).to(
        torch.int32)


def expert_rows(flat: torch.Tensor, num_experts: int) -> list:
    """Rows routed to each expert, from ``flat`` ([T*k] expert ids): one
    host read on the card; on ``meta`` tensors the even-load model (see
    the module docstring)."""
    if flat.is_meta:
        n, extra = divmod(flat.shape[0], num_experts)
        return [n + (e < extra) for e in range(num_experts)]
    return torch.bincount(flat, minlength=num_experts).tolist()


def routed(xt: torch.Tensor, p: Params, cfg,
           over: Optional[GlobalAux] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xt: [T, d] -> (the top-k combine of the routed experts [T, d],
    aux; ``over`` as ``route``'s). Each expert runs on the rows routed
    to it."""
    T, d = xt.shape
    k = cfg.experts_per_token
    gates, idx, aux = route(xt, p["router"], k, over)
    flat = idx.reshape(-1)                          # [T*k], token-major
    order = torch.argsort(flat, stable=True)        # the pairs by expert
    # the one host read of the layer: the slices below need the counts
    counts = expert_rows(flat, cfg.num_experts)
    rows = xt[order // k]                           # [T*k, d]
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(L.swiglu(rows[start:start + n], p["w1"][e],
                                 p["w3"][e], p["w2"][e]))
            start += n
    y = torch.cat(outs)[torch.argsort(order)].reshape(T, k, d)
    return (y * gates[..., None]).sum(dim=1), aux


def capacity(tokens: int, cfg, ctx) -> int:
    """``routed_ep``'s rows an expert for ``tokens`` local tokens: the
    reference's ``max(1, ceil(T·k / E · capacity_factor))``."""
    return max(1, int(math.ceil(tokens * cfg.experts_per_token /
                                cfg.num_experts * ctx.capacity_factor)))


def dispatch_slots(ids: torch.Tensor, num_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: [T*k] expert ids in token-major (t, slot) order -> (pos, keep):
    each pair's slot in its expert's buffer (the count of earlier pairs
    to that expert) and whether it is below ``cap``."""
    counts = _one_hot(ids, num_experts).cumsum(1, dtype=torch.int32)
    pos = counts.gather(0, ids[None, :])[0] - 1
    return pos, pos < cap


def local_experts(p: Params, ctx) -> Params:
    """A MoE layer's parameters with only this rank's experts: rows
    ``m·E/M`` to ``(m+1)·E/M`` of ``w1``, ``w3`` and ``w2`` for rank ``m``
    of the model axis (the reference's ``in_specs`` ``P(model, None,
    None)``); the router, ``ln`` and the shared experts stay whole. With
    one rank on the axis (or no mesh) ``p`` is returned as it is."""
    M = ctx.model_axis_size
    if M == 1:
        return p
    El = p["w1"].shape[0] // M
    m = ctx.mesh.get_local_rank(ctx.model_axis)
    return {name: t[m * El:(m + 1) * El].clone()
            if name in ("w1", "w3", "w2") else t for name, t in p.items()}


def _expert_ffn(h: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """h: [E, C, d] through each expert's SwiGLU (batched products, as the
    reference's ``_expert_ffn`` ``:81``)."""
    return torch.bmm(F.silu(torch.bmm(h, w1)) * torch.bmm(h, w3), w2)


def _all_to_all(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_to_all_single`` of equal blocks over ``group``
    (``distributed.collectives``); over an axis of one rank (no group) the
    exchange of one rank with itself, a copy."""
    if group is None:
        out.copy_(x)
    else:
        C.all_to_all_single(out, x, group)


class _Exchange(torch.autograd.Function):
    """x: [N, d] in M equal blocks, block j to rank j of ``group`` ->
    ``[N + pad, d]``: the blocks that arrive, in rank order, then ``pad``
    zero rows. The exchange is its own transpose: the backward sends the
    gradient of the first N rows back the same way."""

    @staticmethod
    def forward(fctx, x, group, pad):
        fctx.group, fctx.pad = group, pad
        n = x.shape[0]
        out = x.new_empty((n + pad,) + tuple(x.shape[1:]))
        _all_to_all(out[:n], x.contiguous(), group)
        out[n:].zero_()
        return out

    @staticmethod
    def backward(fctx, g):
        n = g.shape[0] - fctx.pad
        out = g.new_empty((n,) + tuple(g.shape[1:]))
        _all_to_all(out, g[:n].contiguous(), fctx.group)
        return out, None, None


class _ModelMean(torch.autograd.Function):
    """The mean of a value over the ranks of ``group`` (M of them). Every
    rank's loss reads the mean, so the gradient of a rank's own term is
    g / M, with no all-reduce: the terms' gradients meet where the
    parameters' gradients are summed (``distributed.data_parallel``)."""

    @staticmethod
    def forward(fctx, v, group, M):
        fctx.M = M
        out = v.clone()
        if group is not None:
            out = C.all_reduce(out, group)
        return out / M

    @staticmethod
    def backward(fctx, g):
        return g / fctx.M, None, None


def _gather_seq(y: torch.Tensor, group) -> torch.Tensor:
    return C.all_gather(y, group, 1)


class _SeqSlice(torch.autograd.Function):
    """x: [B, S, d], the same on every rank of ``group`` -> rank m's S/M
    positions. Every rank computes the same loss from the gathered
    output (``_SeqGather``), so the input's gradient is the gather of
    each rank's slice gradient, not their sum."""

    @staticmethod
    def forward(fctx, x, group, m, M):
        fctx.group = group
        s = x.shape[1] // M
        return x[:, m * s:(m + 1) * s].contiguous()

    @staticmethod
    def backward(fctx, g):
        return _gather_seq(g, fctx.group), None, None, None


class _SeqGather(torch.autograd.Function):
    """y: [B, S/M, d] on rank m -> [B, S, d], every rank's positions in
    rank order; the backward keeps rank m's positions of the (replicated)
    gradient."""

    @staticmethod
    def forward(fctx, y, group, m):
        fctx.m, fctx.s = m, y.shape[1]
        return _gather_seq(y, group)

    @staticmethod
    def backward(fctx, g):
        s = fctx.s
        return g[:, fctx.m * s:(fctx.m + 1) * s].contiguous(), None, None


class _Share(torch.autograd.Function):
    """Identity forward; backward: the cotangent divided by ``M``, the
    ranks that computed the same output (the reference's transpose of a
    replicated ``out_specs``)."""

    @staticmethod
    def forward(fctx, y, M):
        fctx.M = M
        return y.view_as(y)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.M, None


def routed_ep(x: torch.Tensor, p: Params, cfg, ctx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``ctx.model_axis`` on this rank.

    x: [B_local, S, d], this rank's rows of the data axes, the same on
    every rank of the model axis; ``p`` holds this rank's ``E/M`` experts
    (``local_experts``). -> (y [B_local, S, d], aux): the values of the
    reference's global ``routed_ep`` at these rows, and aux averaged over
    the model axis. When ``S`` divides over the ``M`` ranks, each routes
    its ``S/M`` positions and the outputs are all-gathered; with the
    sequence-split residual (``ctx.seq_parallel``) ``x`` and ``y`` are
    already this rank's S/M positions, the same slice, and nothing is
    sliced or gathered here; otherwise every rank routes all of them, at
    a ``cap`` of its ``B_local·S`` tokens (the reference's ``tok_spec``
    without the model axis), and each rank's experts take M copies of
    every row. The reference's ``out_specs`` replicate ``y`` there, so
    its transpose divides the cotangent by M; here ``_Share`` does (the
    expert gradients are then the sum of M parts of 1/M), and the
    input's 1/M parts meet in the sum over the axis of its copy onto it
    (``tensor_parallel.enter``), the router's in the training step's.
    Each expert
    takes at most ``cap`` (``capacity``) of a rank's (token, slot) pairs,
    in token-major order; the rest are dropped (weight 0).

    The backward runs the exchanges in reverse and gathers the input's
    gradient over the sequence slices (``_SeqSlice``/``_SeqGather``);
    the router's gradient on a rank covers its S/M positions only and
    is summed over the model axis with the other gradients
    (``distributed.data_parallel.reduce_gradients``). Each kept pair
    reads its own row and a dropped one the spare zero row, so the
    backward of the gathers adds one term to each kept row (the spare
    row's, all zero, are discarded): the same bits every run."""
    M = ctx.model_axis_size
    E, k = cfg.num_experts, cfg.experts_per_token
    if E % M:
        raise ValueError(f"{E} experts do not divide over {M} ranks")
    El = E // M
    if p["w1"].shape[0] != El:
        raise ValueError(f"routed_ep wants this rank's {El} experts, got "
                         f"{p['w1'].shape[0]} (models.moe.local_experts)")
    group = ctx.mesh.get_group(ctx.model_axis)
    m = ctx.mesh.get_local_rank(ctx.model_axis)
    B, S, d = x.shape
    presliced = ctx.seq_parallel        # the residual's own slice
    # the reference's tok_spec
    seq_shard = presliced or (S % M == 0 and S >= M)
    every = not seq_shard and M > 1         # every rank routes all of S
    if every:
        # the input's 1/M parts summed over the axis in the backward
        x = TP.enter(x, TP.plan(cfg, ctx))
    if seq_shard and M > 1 and not presliced:
        x = _SeqSlice.apply(x, group, m, M)
    bl, sl = x.shape[:2]
    T = bl * sl
    xt = x.reshape(T, d)
    gates, idx, aux = route(xt, p["router"], k)
    aux = _ModelMean.apply(aux, group, M)
    cap = capacity(T, cfg, ctx)
    ids = idx.reshape(-1)                               # [T*k]
    pos, keep = dispatch_slots(ids, E, cap)
    # kept (expert, slot) pairs are unique, so an index copy places them;
    # a dropped pair goes to the spare row E·cap, cut off below
    dest = torch.where(keep, ids * cap + pos, E * cap)
    buf = xt.new_zeros(E * cap + 1, d).index_copy(
        0, dest, xt[:, None].expand(T, k, d).reshape(T * k, d))
    # dispatch: [E, cap, d] in M blocks of E/M experts, block j to rank j;
    # rank i's block arrives as [M, E/M, cap, d] -> [E/M, M·cap, d]
    recv = _Exchange.apply(buf[:E * cap], group, 0)
    h = recv.view(M, El, cap, d).transpose(0, 1).reshape(El, M * cap, d)
    hidden = _expert_ffn(h, p["w1"], p["w3"], p["w2"])
    # return: [E/M, M·cap, d] -> [M, E/M, cap, d], block i to rank i;
    # what comes back is [E, cap, d], the outputs for this rank's pairs,
    # and the spare zero row that the dropped pairs read
    send = hidden.view(El, M, cap, d).transpose(0, 1).reshape(E * cap, d)
    back = _Exchange.apply(send, group, 1)
    w = keep.to(xt.dtype) * gates.reshape(-1)
    y = (back.index_select(0, dest) * w[:, None]).reshape(T, k, d).sum(
        dim=1).reshape(bl, sl, d)
    if seq_shard and M > 1 and not presliced:
        y = _SeqGather.apply(y, group, m)
    if every:
        y = _Share.apply(y, M)
    return y, aux


def moe_block(p: Params, x: torch.Tensor, cfg, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE residual block: x + shared experts + routed experts.
    ``routed_ep`` when ``ctx`` asks for it (``moe_impl="ep"`` on a mesh),
    else the drop-free ``routed``, whose aux is the global batch's over
    more than one data rank (``global_aux``); under the sequence-split
    residual ``routed`` runs on every position, gathered over the model
    axis, and returns the rank's. On a model axis whose ranks split the
    shared experts (``tensor_parallel.plan``) each rank holds their
    hidden units."""
    B, S, d = x.shape
    tp = TP.plan(cfg, ctx)
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if ctx is not None and ctx.moe_impl == "ep" and ctx.mesh is not None:
        r, aux = routed_ep(xn, p, cfg, ctx)
    else:
        xw = TP.gather_seq(xn, tp)
        Bw, Sw = xw.shape[:2]
        r, aux = routed(xw.reshape(Bw * Sw, d), p, cfg,
                        global_aux(ctx, tp, xw, p["router"]))
        r = TP.slice_seq(r.reshape(Bw, Sw, d), tp)
    if cfg.num_shared_experts:
        sh = L.swiglu(xn, p["sh_w1"], p["sh_w3"], p["sh_w2"],
                      split=tp if tp.shared else None)
        return x + sh + r, aux
    return x + r, aux
