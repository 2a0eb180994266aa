"""Tensor parallelism over the model axis: what a rank holds and the
collectives between its shards.

The reference splits its large leaves over the mesh's ``model`` axis by
its partition rules and lets XLA insert the collectives. The port holds
each rank's shard of a leaf as a plain tensor and writes every
collective out, each in a ``torch.autograd.Function``:

* ``enter`` before a product whose columns are split (``wq``/``wk``/
  ``wv``, ``w1``/``w3``, ``in_proj``, ``unembed``): the copy onto the
  axis (identity forward, sum backward);
* ``leave`` after a product whose rows are split (``wo``, ``w2``,
  ``out_proj``), and after the vocabulary-split embedding lookup: the
  sum over the axis (sum forward, identity backward);
* ``share`` on a tensor that every rank computes alike from whole
  leaves and that feeds the rank's heads (MLA's ``q_lat``, ``c_kv`` and
  ``k_pe``; Mamba2's ``A_log``, ``D``, ``dt_bias`` and ``gnorm``): the
  copy onto the axis, so that those whole leaves get the gradient of
  every rank's heads;
* ``gather_dim`` where a rank needs more than its block of a split
  leaf's output or of the leaf itself (Mamba2's ``in_proj`` columns and
  conv channels, cut in contiguous blocks that do not line up with the
  heads): the gather over the axis (its backward reduce-scatters), and
  ``norm_sum`` for a sum of squares over split units (Mamba2's gated
  RMSNorm over ``d_inner``): the sum over the axis both ways.

A GQA block whose KV heads do not divide over the axis runs
context-parallel (``Plan.cp``, the reference's route where ``KV % M !=
0``): its leaves are cut as the partition rules cut them (``wq``,
``wk``, ``wv`` columns, ``wo`` rows), each rank computes its column
block of q, k and v, ``to_rows`` exchanges q into the rank's ``S/M``
rows of every head (an all-to-all; its backward is the inverse one),
``gather_dim`` gathers k and v over their columns, and ``to_columns``
returns the rows' output to its column block before ``wo``'s rows
(``models.layers.attn_block``).

With the ``seq_shard_residual`` hint (``ModelContext.seq_parallel``) the
residual between blocks is each rank's ``S/M`` positions ``[B, S/M,
d]``: ``enter`` then gathers the sequence (its backward
reduce-scatters) and ``leave`` reduce-scatters it (its backward
gathers); MLA gathers at the block's input (``gather_seq``) and
``share`` copies nothing. A block that stays whole (Mamba2 heads that do
not divide over the axis) gathers the sequence, runs whole and keeps its
rank's positions (``gather_seq``, ``slice_seq``). Each rank then sees
the leaves that are not split (the norms, the routers, MLA's and
Mamba2's whole leaves, a whole block's) through its own positions or
heads only, and the training step sums their gradients over the axis
(``distributed.data_parallel.reduce_gradients``), once.

``layout`` says which leaves of a config a context cuts, through
``distributed.sharding.split_dim`` over the model axis and
``sharding.fsdp_dim`` over the data axis (FSDP, whose gathers are
``distributed.fsdp``'s), both by the reference's rules; ``plan``
says the same of a config's blocks for the model's functions. The
vocabulary leaves split into ``Vp/M`` rows (``embed``) and columns
(``unembed``): ``embed`` looks each token up on the rank that holds
its row, ``gather_vocab`` gathers serving's float32 logits, and
``vocab_ce`` reduces each chunk's maximum, sum of exponentials and
target logit over the axis, so ``[B, S, Vp]`` is never formed whole.

Over an axis of one rank (a world of one, no mesh, the dry-run's
``launch.mesh.RankMesh`` of a 1 x 1 mesh, or the ``no_tp`` hint) nothing
splits and no collective runs. Every collective is one of
``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``all_to_all_single``, through
``distributed.collectives`` (counted, not run, over the dry-run's
``RankMesh``), which NCCL takes and gloo takes for CPU and CUDA tensors
alike (``tools/probe_gloo_cuda.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import fsdp_dim, split_dim


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a context splits of a config's blocks: ``ways`` ranks on the
    model axis (1: nothing), this rank's index ``rank`` and the axis's
    ``group``; whether the GQA self- and cross-attention blocks
    (the MTP layer's too) split their heads (``attn``: their KV heads
    divide over the axis) or run context-parallel (``cp``: their leaves
    split, their KV heads do not divide), the MLA blocks (``mla``), the
    Mamba2 blocks' heads (``mamba``), the dense FFNs (``ffn``), the MoE
    layers' shared experts (``shared``) and the vocabulary leaves
    (``vocab``) split; and whether the residual is each rank's ``S/M``
    positions (``seq``)."""
    ways: int = 1
    rank: int = 0
    group: Any = None
    attn: bool = False
    cp: bool = False
    mla: bool = False
    mamba: bool = False
    ffn: bool = False
    shared: bool = False
    vocab: bool = False
    seq: bool = False


WHOLE = Plan()


def ffn_width(cfg) -> int:
    """A dense FFN's hidden width: the MoE family's leading dense layers
    (and its MTP layer) are ``dense_d_ff`` wide, every other ``d_ff``
    (``models.model._init_layer``)."""
    return cfg.dense_d_ff if (cfg.family == "moe" and cfg.dense_d_ff) \
        else cfg.d_ff


def _heads(cfg, block: Optional[str]) -> Tuple[int, ...]:
    """The heads that must divide over the model axis for a block of kind
    ``block`` to split (``sharding.split_dim``): an MLA block's heads, a
    Mamba2 block's SSD heads; none for the other blocks. A GQA block's
    leaves split wherever the partition rules' guard keeps them split,
    its heads dividing or not (``Plan.cp``)."""
    return {"mla": (cfg.num_heads,),
            "mamba": (cfg.ssm_heads,)}.get(block, ())


def plan(cfg, ctx) -> Plan:
    """``ctx``'s split of ``cfg``'s blocks (``Plan``), by ``split_dim`` at
    the whole leaves' shapes. Every block takes the sequence-split
    residual, split or whole: the dense MoE route gathers the positions
    (``models.moe.moe_block``), and a vocabulary that does not split
    embeds and scores each rank's positions against the whole leaves
    (``embed``, ``models.model.fused_ce``)."""
    M = 1 if ctx is None else ctx.tp_size
    if M == 1:
        return WHOLE
    d, Vp = cfg.d_model, cfg.padded_vocab_size
    hd = cfg.head_dim
    H = cfg.num_heads

    def splits(name, block, shape):
        return split_dim(name, block, shape, M, _heads(cfg, block)) \
            is not None
    # the reference's route: heads split where the KV heads divide
    # (``H`` is a multiple of ``KV``), else the rows
    kv_heads = cfg.num_kv_heads % M == 0
    attn = splits("wq", "attn", (d, H * hd))
    if splits("wk", "attn", (d, cfg.num_kv_heads * hd)) != attn:
        raise NotImplementedError(
            f"{cfg.name}: the model axis of {M} splits one of wq "
            f"({H * hd} columns) and wk ({cfg.num_kv_heads * hd}) only")
    out = Plan(
        ways=M, rank=ctx.mesh.get_local_rank(ctx.model_axis),
        group=ctx.mesh.get_group(ctx.model_axis),
        attn=attn and kv_heads, cp=attn and not kv_heads,
        mla=cfg.use_mla and splits("wo", "mla", (H * cfg.v_head_dim, d)),
        mamba=splits("out_proj", "mamba", (cfg.ssm_d_inner, d)),
        ffn=split_dim("w1", "ffn", (d, ffn_width(cfg)), M) is not None,
        shared=bool(cfg.num_shared_experts) and split_dim(
            "sh_w1", "moe", (d, cfg.moe_d_ff * cfg.num_shared_experts),
            M) is not None,
        vocab=split_dim("embed", "top", (Vp, d), M) is not None,
        seq=ctx.seq_parallel)
    return out


def for_sequence(ctx, seq: int):
    """``ctx`` for a call over ``seq`` positions: the ``seq_shard_residual``
    hint holds only where the positions divide over the model axis (the
    reference's guard), so a decode step's one position is not split."""
    if ctx is not None and ctx.seq_parallel and seq % ctx.tp_size:
        return dataclasses.replace(ctx, seq_shard_residual=False)
    return ctx


# --------------------------------------------------------------------------
# collectives over the model axis
# --------------------------------------------------------------------------
class _Copy(torch.autograd.Function):
    """Identity forward, the sum over the axis backward."""

    @staticmethod
    def forward(fctx, x, tp):
        fctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return C.all_reduce(g.clone(), fctx.tp.group), None


class _Sum(torch.autograd.Function):
    """The sum over the axis forward, identity backward (every rank goes
    on from the same sum)."""

    @staticmethod
    def forward(fctx, x, tp):
        return C.all_reduce(x.clone(), tp.group)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """The sum over the axis forward and backward: a sum of parts whose
    consumers differ by rank, so that the gradient of each part is the
    sum of every rank's."""

    @staticmethod
    def forward(fctx, x, tp):
        fctx.tp = tp
        return C.all_reduce(x.clone(), tp.group)

    @staticmethod
    def backward(fctx, g):
        return C.all_reduce(g.clone(), fctx.tp.group), None


class _Gather(torch.autograd.Function):
    """The ranks' blocks along ``dim``, in rank order (``[B, S/M, ...] ->
    [B, S, ...]`` at dim 1); backward: the sum over the axis of rank m's
    block."""

    @staticmethod
    def forward(fctx, x, tp, dim):
        fctx.tp, fctx.dim = tp, dim
        return C.all_gather(x, tp.group, dim)

    @staticmethod
    def backward(fctx, g):
        tp = fctx.tp
        return C.reduce_scatter(g, tp.group, fctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    """[B, S, ...] partial sums -> rank m's positions of their sum over
    the axis; backward: the gradient's positions gathered."""

    @staticmethod
    def forward(fctx, x, tp):
        fctx.tp = tp
        return C.reduce_scatter(x, tp.group, 1)

    @staticmethod
    def backward(fctx, g):
        tp = fctx.tp
        return C.all_gather(g, tp.group, 1), None


class _Slice(torch.autograd.Function):
    """A tensor the same on every rank -> rank m's block along ``dim``
    (``[B, S, ...] -> [B, S/M, ...]`` at dim 1); backward: the gradient
    in that block, zero elsewhere."""

    @staticmethod
    def forward(fctx, x, tp, dim):
        fctx.tp, fctx.dim, fctx.size = tp, dim, x.shape[dim]
        n = x.shape[dim] // tp.ways
        return x[(slice(None),) * dim +
                 (slice(tp.rank * n, (tp.rank + 1) * n),)].contiguous()

    @staticmethod
    def backward(fctx, g):
        tp, dim = fctx.tp, fctx.dim
        shape = list(g.shape)
        shape[dim] = fctx.size
        out = g.new_zeros(shape)
        n = g.shape[dim]
        out[(slice(None),) * dim +
            (slice(tp.rank * n, (tp.rank + 1) * n),)] = g
        return out, None, None


def _columns_to_rows(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """[B, S, c], this rank's columns of every row -> [B, S/M, M·c], every
    rank's columns (in rank order) of this rank's S/M contiguous rows:
    block j of the rows goes to rank j in one all-to-all."""
    B, S, c = x.shape
    M = tp.ways
    send = x.reshape(B, M, S // M, c).movedim(1, 0).contiguous()
    got = torch.empty_like(send)
    C.all_to_all_single(got, send, tp.group)
    return got.permute(1, 2, 0, 3).reshape(B, S // M, M * c)


def _rows_to_columns(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The inverse of ``_columns_to_rows``: [B, S/M, M·c] -> [B, S, c]."""
    B, n, Mc = x.shape
    M = tp.ways
    send = x.reshape(B, n, M, Mc // M).permute(2, 0, 1, 3).contiguous()
    got = torch.empty_like(send)
    C.all_to_all_single(got, send, tp.group)
    return got.movedim(0, 1).reshape(B, M * n, Mc // M)


class _Exchange(torch.autograd.Function):
    """``_columns_to_rows`` (``rows``) or ``_rows_to_columns``; backward:
    the other, its adjoint."""

    @staticmethod
    def forward(fctx, x, tp, rows):
        fctx.tp, fctx.rows = tp, rows
        return (_columns_to_rows if rows else _rows_to_columns)(x, tp)

    @staticmethod
    def backward(fctx, g):
        back = _rows_to_columns if fctx.rows else _columns_to_rows
        return back(g, fctx.tp), None, None


def enter(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The input of a column-split product: the sequence gathered under
    ``tp.seq``, else ``x`` copied onto the axis."""
    if tp.ways == 1:
        return x
    return _Gather.apply(x, tp, 1) if tp.seq else _Copy.apply(x, tp)


def leave(y: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The output of a row-split product, summed over the axis: this
    rank's positions of the sum under ``tp.seq``."""
    if tp.ways == 1:
        return y
    return _ScatterSeq.apply(y, tp) if tp.seq else _Sum.apply(y, tp)


def gather_seq(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """Under ``tp.seq``, every rank's positions (``enter``'s gather); else
    ``x``."""
    return _Gather.apply(x, tp, 1) if tp.seq else x


def share(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """A tensor that every rank computes alike from whole leaves, before
    the rank's heads: copied onto the axis, so that those leaves get the
    gradient of every rank's heads; under ``tp.seq`` ``x`` as it is (the
    training step sums the whole leaves' gradients over the axis)."""
    return x if tp.ways == 1 or tp.seq else _Copy.apply(x, tp)


def gather_dim(x: torch.Tensor, tp: Plan, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` in rank order, the same
    on every rank; backward: the sum over the axis of this rank's
    block."""
    return x if tp.ways == 1 else _Gather.apply(x, tp, dim)


def norm_sum(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The sum over the axis of each rank's part ``x`` (a sum of squares
    over this rank's units), whose consumers differ by rank: the
    backward sums too."""
    return x if tp.ways == 1 else _SumBoth.apply(x, tp)


def slice_seq(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """Under ``tp.seq``, this rank's positions of a tensor that every rank
    holds whole; else ``x``."""
    return _Slice.apply(x, tp, 1) if tp.seq else x


def slice_dim(x: torch.Tensor, tp: Plan, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor that every rank holds
    alike; backward: the gradient in that block, zero elsewhere (each
    rank's consumer sees its block only)."""
    return x if tp.ways == 1 else _Slice.apply(x, tp, dim)


def to_rows(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """``[B, S, c]``, this rank's column block of every position -> ``[B,
    S/M, M·c]``, every column of this rank's ``S/M`` contiguous positions
    (one all-to-all; backward the inverse): the query rows of a
    context-parallel attention."""
    return x if tp.ways == 1 else _Exchange.apply(x, tp, True)


def to_columns(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The inverse of ``to_rows``: ``[B, S/M, M·c] -> [B, S, c]``."""
    return x if tp.ways == 1 else _Exchange.apply(x, tp, False)


def seq_sum(x: torch.Tensor, tp: Plan) -> torch.Tensor:
    """The sum over the axis of each rank's part of a value over its own
    positions (a loss over a whole vocabulary, ``models.model.fused_ce``):
    every rank goes on from the same sum, and each part's gradient is the
    cotangent (``leave`` without the sequence split)."""
    return _Sum.apply(x, tp)


# --------------------------------------------------------------------------
# the vocabulary leaves
# --------------------------------------------------------------------------
def embed(table: torch.Tensor, ids: torch.Tensor, tp: Plan
          ) -> torch.Tensor:
    """``table[ids]`` [B, S, d] (under ``tp.seq`` this rank's positions)
    from this rank's rows of a vocabulary-split table: each rank looks up
    the tokens in its rows, zero elsewhere, and the sum over the axis
    (``leave``) has each token's row from the one rank that holds it. A
    whole table under ``tp.seq`` looks up this rank's positions only."""
    if not tp.vocab:
        if tp.seq:
            n = ids.shape[1] // tp.ways
            ids = ids[:, tp.rank * n:(tp.rank + 1) * n]
        return table[ids]
    n = table.shape[0]
    local = ids.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return leave(torch.where(inside[..., None], rows, 0), tp)


def gather_vocab(logits: torch.Tensor, tp: Plan) -> torch.Tensor:
    """[B, Vp/M] logits of this rank's vocabulary columns -> [B, Vp] on
    every rank (serving; no gradient)."""
    if not tp.vocab:
        return logits
    return C.all_gather(logits, tp.group, -1)


def vocab_ce(xc: torch.Tensor, unembed: torch.Tensor, tc: torch.Tensor,
             vocab_size: int, tp: Plan) -> torch.Tensor:
    """A chunk's cross-entropy ``[B, c]`` from this rank's ``Vp/M``
    columns of ``unembed``, ``xc`` already on the axis (``enter``): the
    maximum of the logits over the axis (no gradient), then the sums of
    ``exp(logit - max)`` and of the target's logit (on the rank that holds
    its column) over the axis. Columns past ``vocab_size`` are -1e30."""
    n = unembed.shape[1]
    logits = (xc @ unembed).float()
    cols = tp.rank * n + torch.arange(n, device=xc.device)
    logits = torch.where(cols < vocab_size, logits, -1e30)
    top = C.all_reduce(logits.detach().amax(dim=-1), tp.group,
                        dist.ReduceOp.MAX)
    sumexp = _Sum.apply(torch.exp(logits - top[..., None]).sum(dim=-1), tp)
    local = tc - tp.rank * n
    inside = (local >= 0) & (local < n)
    target = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = _Sum.apply(torch.where(inside, target, 0.0), tp)
    return torch.log(sumexp) + top - target


# --------------------------------------------------------------------------
# what each rank holds
# --------------------------------------------------------------------------
class Cut(NamedTuple):
    """A leaf cut over one axis: the dimension cut and its whole size."""
    dim: int
    size: int


class Cuts(NamedTuple):
    """A leaf's cuts: over the model axis (tensor or expert parallelism)
    and over the data axis (FSDP, ``distributed.fsdp``); ``None`` where
    the axis keeps it whole."""
    model: Optional[Cut] = None
    data: Optional[Cut] = None


#: a layer's ``attn`` leaves' block kind by its spec's kind
_ATTN_BLOCK = {"attn": "attn", "cross_attn": "attn", "mla": "mla",
               "mamba": "mamba"}


def _block_of(path: str, cfg, own) -> Optional[str]:
    """The block kind (``sharding.TP_LEAVES``' keys, or ``None``) of the
    leaf at ``path`` of the port's parameter tree: ``"top"`` for a
    top-level leaf; under a layer's ``attn``, ``"attn"`` for a GQA self-
    or cross-attention layer, ``"mla"`` or ``"mamba"``; under its
    ``ffn``, ``"ffn"`` or ``"moe"`` by the layer's spec (``own``: the
    specs of ``params["layers"]``' entries); the MTP module's layer
    (``mtp/attn``, ``mtp/ffn``) as a GQA attention layer with a dense
    FFN (``models.model.MTP_SPEC``); ``None`` for anything else (the MTP
    module's ``proj`` and norms)."""
    parts = path.split("/")
    if len(parts) == 1:
        return "top"
    if parts[-2] not in ("attn", "ffn"):
        return None
    if len(parts) == 3 and parts[0] == "mtp":
        return "attn" if parts[-2] == "attn" else "ffn"
    if len(parts) < 4:
        return None
    outer, inner = parts[-4], parts[-3]
    if outer == "layers":
        spec = own[int(inner[1:-1])]
    elif outer.endswith("_shared"):
        spec = cfg.plan()[int(outer[len("stage"):-len("_shared")])].layers[
            int(inner[len("layer"):])]
    else:
        return None
    if parts[-2] == "attn":
        return _ATTN_BLOCK.get(spec.kind)
    return {"dense": "ffn", "moe": "moe"}.get(spec.ffn)


def data_ways(ctx) -> int:
    """Ranks on the mesh's ``data`` axis, the FSDP axis (1 without a mesh
    or without the axis)."""
    if ctx is None or ctx.mesh is None or \
            "data" not in ctx.mesh.mesh_dim_names:
        return 1
    return ctx.mesh.size(ctx.mesh.mesh_dim_names.index("data"))


def layout(cfg, ctx) -> Dict[str, Cuts]:
    """The leaves of ``cfg``'s parameter tree that ``ctx`` cuts, by their
    names in it (``tree.flatten_with_names``), with their ``Cuts``: over
    the model axis each leaf that ``sharding.split_dim`` splits and, under
    expert parallelism (``moe_impl="ep"``), each MoE layer's expert leaves
    on their first dimension (``models.moe.local_experts``); over the data
    axis each leaf that ``sharding.fsdp_dim`` cuts. Empty over axes of one
    rank; with ``no_tp`` nothing is cut over the model axis."""
    M = 1 if ctx is None or ctx.mesh is None else ctx.tp_size
    D = data_ways(ctx)
    if M == 1 and D == 1:
        return {}
    return _layout(cfg, M, D, ctx.moe_impl == "ep")


@functools.lru_cache(maxsize=32)
def _layout(cfg, M: int, D: int, ep: bool) -> Dict[str, Cuts]:
    from repro_torch.models.layers import ShapesOnly
    from repro_torch.models.model import init
    # the specs of params["layers"]' entries: every application but a
    # shared layer's
    own = [spec for stage in cfg.plan() for _ in range(stage.repeat)
           for spec in stage.layers if not spec.shared]
    out = {}
    for path, leaf in tree.flatten_with_names(init(ShapesOnly(), cfg)
                                              ).items():
        block, name = _block_of(path, cfg, own), path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        dim = split_dim(name, block, shape, M, _heads(cfg, block))
        if dim is None and M > 1 and block == "moe" and ep and \
                name in ("w1", "w3", "w2"):
            dim = 0
        ddim = fsdp_dim(name, shape, D)
        if dim is not None or ddim is not None:
            out[path] = Cuts(
                None if dim is None else Cut(dim, shape[dim]),
                None if ddim is None else Cut(ddim, shape[ddim]))
    return out


def cuts_of(names, split: Dict[str, Cuts]) -> Dict[str, Cuts]:
    """The cut leaves among ``names`` (a tree's leaf names, such as a
    training state's ``opt/mu/layers/[3]/attn/wq``): each name whose
    trailing part names a leaf of ``split``."""
    out = {}
    for name in names:
        parts = name.split("/")
        for i in range(len(parts)):
            cut = split.get("/".join(parts[i:]))
            if cut is not None:
                out[name] = cut
                break
    return out


def local(t: torch.Tensor, cut: Cut, rank: int, ways: int) -> torch.Tensor:
    """Rank ``rank``'s part of the leaf ``t``, whole along ``cut.dim``,
    a copy; a leaf that is not whole there raises ``ValueError``."""
    if t.shape[cut.dim] != cut.size:
        raise ValueError(f"a leaf of {tuple(t.shape)} is not whole on "
                         f"dimension {cut.dim} ({cut.size})")
    n = cut.size // ways
    return t.narrow(cut.dim, rank * n, n).clone()


def local_block(t: torch.Tensor, cuts: Cuts, model: Tuple[int, int],
                data: Tuple[int, int]) -> torch.Tensor:
    """The block of the whole leaf ``t`` that the rank at ``model`` and
    ``data`` (each ``(rank, ways)`` on its axis) holds: its model-axis
    part of its data-axis part, as the reference's device at the same
    mesh position holds it."""
    if cuts.model is not None:
        t = local(t, cuts.model, *model)
    if cuts.data is not None:
        t = local(t, cuts.data, *data)
    return t
