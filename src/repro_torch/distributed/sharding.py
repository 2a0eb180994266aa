"""Sharding rules as data: parameter path -> partition spec.

Port of the reference's ``distributed/sharding.py`` (MaxText-style
logical axes) for the port's layouts, and its ``make_context``.

``make_context`` given a mesh makes the context a run on that mesh
computes with, as the reference's does on any mesh: the mesh, its batch
axes, the model axis and ``moe_impl="ep"``; with the ``no_tp`` hint the
model axis becomes one more batch axis and the MoE layers run dense. A
live ``torch.distributed`` device mesh (``launch.mesh.make_host_mesh``)
is what a run computes on; plain axis sizes (the dry-run's production
meshes) give ``launch.mesh.RankMesh``, one rank of that mesh at its
origin with no process group, over which the dry-run counts what that
rank runs, its collectives counted (``distributed.collectives``).

The model-axis entries of the partition rules below are put to work by
``split_dim``: the leaves of the blocks it names (``TP_LEAVES``: the
vocabulary, GQA self- and cross-attention, MLA, Mamba2, the dense FFN
and the shared experts, the MTP layer's attention and FFN among them)
split over the model axis on the dimension their rule gives it, an
MLA or Mamba2 block only when its heads divide over the axis (otherwise
that block runs whole on every rank), a GQA block wherever the guard
keeps the entry: where its KV heads do not divide, each rank computes
its column blocks and attends with its rows of the queries, the
reference's context-parallel route (``models.layers.attn_block``,
``tensor_parallel.Plan.cp``). Each MoE layer's experts
split by ``models.moe``'s expert parallelism. The data-axis entries (``"data"`` on the d_model dims) are
put to work by ``fsdp_dim``: every leaf whose rule has one is cut over
the ``data`` axis on that dimension where the axis divides it, as the
reference's launcher places its parameters, moments and error buffer
(FSDP, ZeRO-3); only ``data`` is an FSDP axis (``pod`` replicates, and
under ``no_tp`` the model ranks hold the same data shard).
``distributed.tensor_parallel.layout`` reads both for a config and a
context, and the model (``models.layers``, ``models.model``,
``models.moe``, ``distributed.fsdp``'s gathers), the converter
(``models.convert.local_tp_params``) and the training step's
reductions (``distributed.data_parallel``) read that layout.
``param_specs`` gives the reference's specs for the dry-run's records.
A spec is a tuple with one entry per dimension: an axis name, a tuple
of axis names (the batch axes of a multi-pod mesh), or ``None``
(replicated); ``tuple()`` of the reference's ``PartitionSpec`` for the
same leaf gives the same tuple. The rule functions take the mesh as a
mapping of axis sizes (``launch.mesh.Mesh.shape``).

Physical mesh axes:
  pod    - outer data parallelism across pods (multi-pod mesh only)
  data   - data parallelism within a pod; also the FSDP/ZeRO-3 axis for
           parameters and optimizer state (weights sharded on their d_model
           dim, all-gathered on use)
  model  - tensor parallelism: heads / ffn-hidden / vocab / experts

The reference's rules are written for its stacked ``[L, ...]`` layer
leaves; the port keeps one dict per layer, so each per-layer leaf gets
the stacked rule without its leading layer axis. A shared layer's
leaves (``stage{s}_shared``) have no repeat axis in either package and
get the rule as it is. Every dim is guarded by divisibility against the
mesh (non-divisible dims replicate).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import RankMesh

Spec = Tuple[Any, ...]
AxisSizes = Mapping[str, int]

_FROM_MESH = ("make_context sets it from the mesh, on whose data and "
              "model axes the partition rules place the leaves (ROADMAP "
              "queue 1 items 16 (b), (d), (e))")

#: the reference's ``ModelContext`` fields that a caller may not set, and
#: why: the mesh fields come from the mesh
REFUSED_CONTEXT = {
    "mesh": _FROM_MESH,
    "model_axis": _FROM_MESH,
    "data_axes": _FROM_MESH,
}


def _context_class():
    # models.layers imports distributed.tensor_parallel, which imports
    # this module: the class is looked up when a context is made
    from repro_torch.models.layers import ModelContext
    return ModelContext


def check_context_fields(kw: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` for a refused (``REFUSED_CONTEXT``) or unknown
    ``ModelContext`` field."""
    known = {f.name for f in dataclasses.fields(_context_class())}
    for key in kw:
        if key in REFUSED_CONTEXT:
            raise ValueError(f"context field {key!r} is not the caller's: "
                             f"{REFUSED_CONTEXT[key]}")
        if key not in known:
            raise ValueError(f"unknown context field {key!r}; the port's "
                             f"ModelContext has {sorted(known)}")


def make_context(mesh: Union[None, AxisSizes, RankMesh, DeviceMesh], **kw):
    """The port's ``ModelContext``.

    Given a mesh, as the reference given a mesh: ``mesh``, ``data_axes``
    (those of ``pod`` and ``data`` that the mesh has),
    ``model_axis="model"`` and ``moe_impl="ep"`` unless ``kw`` sets it.
    With ``no_tp`` (the reference's pure data-parallel remap) the model
    axis joins the data axes and ``moe_impl`` is ``"dense"`` unless
    ``kw`` sets it; ``"ep"`` with ``no_tp`` over a model axis of more
    than one rank raises ``ValueError`` (its rows would differ on the
    ranks that exchange them). A live ``DeviceMesh`` or a ``RankMesh``
    is taken as it is; plain axis sizes (the dry-run's) become the
    ``RankMesh`` of the rank at the mesh's origin. ``None``: the
    single-device context. A refused or unknown field raises
    ``ValueError``."""
    check_context_fields(kw)
    ModelContext = _context_class()
    if mesh is None:
        return ModelContext(**kw)
    if not isinstance(mesh, (DeviceMesh, RankMesh)):
        sizes = dict(mesh)
        mesh = RankMesh(tuple(sizes), tuple(sizes.values()))
    data_axes = tuple(a for a in ("pod", "data")
                      if a in mesh.mesh_dim_names)
    if kw.get("no_tp"):
        data_axes += ("model",)
        kw.setdefault("moe_impl", "dense")
        if kw["moe_impl"] == "ep" and mesh.size(
                mesh.mesh_dim_names.index("model")) > 1:
            raise ValueError("no_tp spreads the batch over the model axis; "
                             "moe_impl='ep' would exchange rows that "
                             "differ on its ranks")
    kw.setdefault("moe_impl", "ep")
    return ModelContext(mesh=mesh, model_axis="model", data_axes=data_axes,
                        **kw)


def _axis_size(axis_sizes: AxisSizes, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(axis_sizes[a] for a in axis)
    return axis_sizes[axis]


def _guard(axis_sizes: AxisSizes, spec: Spec, shape: Tuple[int, ...]
           ) -> Spec:
    """Drop axes that don't divide their dim (replicate instead)."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is not None and dim % _axis_size(axis_sizes, axis) == 0 \
                and dim > 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


# Base (unstacked) rules: leaf name -> callable(shape) -> spec.
# 'fsdp' = data axis on the d_model-like dim; 'tp' = model axis. The
# reference's table, MoE, MLA, Mamba2 and MTP leaves included.
_RULES = {
    "embed":    lambda s: ("model", None),
    "unembed":  lambda s: ("data", "model"),
    "final_ln": lambda s: (None,),
    "wq":       lambda s: ("data", "model"),
    "wk":       lambda s: ("data", "model"),
    "wv":       lambda s: ("data", "model"),
    "wo":       lambda s: ("model", "data"),
    "bq":       lambda s: ("model",),
    "bk":       lambda s: ("model",),
    "bv":       lambda s: ("model",),
    "gate":     lambda s: (),
    "ln":       lambda s: (None,),
    # MLA
    "wq_a":     lambda s: ("data", None),
    "q_ln":     lambda s: (None,),
    "wq_b":     lambda s: (None, "model"),
    "wkv_a":    lambda s: ("data", None),
    "kv_ln":    lambda s: (None,),
    "wk_b":     lambda s: (None, "model"),
    "wv_b":     lambda s: (None, "model"),
    # FFN
    "w1":       lambda s: ("data", "model") if len(s) == 2
                          else ("model", "data", None),   # moe experts [E,d,ff]
    "w3":       lambda s: ("data", "model") if len(s) == 2
                          else ("model", "data", None),
    "w2":       lambda s: ("model", "data") if len(s) == 2
                          else ("model", None, "data"),   # moe [E,ff,d]
    "router":   lambda s: (None, None),
    "sh_w1":    lambda s: ("data", "model"),
    "sh_w3":    lambda s: ("data", "model"),
    "sh_w2":    lambda s: ("model", "data"),
    # Mamba2
    "in_proj":  lambda s: ("data", "model"),
    "conv_w":   lambda s: (None, "model"),
    "conv_b":   lambda s: ("model",),
    "A_log":    lambda s: (None,),
    "D":        lambda s: (None,),
    "dt_bias":  lambda s: (None,),
    "gnorm":    lambda s: (None,),
    "out_proj": lambda s: ("model", "data"),
    # MTP
    "proj":     lambda s: ("data", None),
    "ln_h":     lambda s: (None,),
    "ln_e":     lambda s: (None,),
}


def _spec_for_leaf(name: str, shape: Tuple[int, ...],
                   axis_sizes: AxisSizes) -> Spec:
    rule = _RULES.get(name)
    if rule is None:
        return ()
    return _guard(axis_sizes, rule(shape), shape)


def _map_named(fn, tree, name: str = ""):
    """``fn(leaf_name, leaf)`` over a tree of dicts and lists; a leaf's
    name is its innermost dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def param_specs(params, axis_sizes: AxisSizes, no_tp: bool = False):
    """A spec tree matching the parameter tree (tensors of any device,
    ``meta`` included): the reference's rule per leaf name, per layer;
    with ``no_tp`` no leaf on the model axis."""
    def spec(name, leaf):
        rule = _RULES.get(name)
        if rule is None:
            return ()
        shape = tuple(leaf.shape)
        s = rule(shape)
        if no_tp:
            s = tuple(None if a == "model" else a for a in s)
        return _guard(axis_sizes, s, shape)
    return _map_named(spec, params)


#: the leaves that tensor parallelism splits, by the block they are in
#: (``split_dim``): the top level's vocabulary leaves, a GQA self- or
#: cross-attention block's heads, an MLA block's heads (``wq_b``,
#: ``wk_b``, ``wv_b`` columns, ``wo`` rows), a Mamba2 block's
#: ``in_proj`` columns, conv channels and ``out_proj`` rows, a dense
#: FFN's hidden units and a MoE FFN's shared experts. Every other leaf
#: (norms, routers, gates, MLA's ``wq_a``/``wkv_a``, Mamba2's ``A_log``,
#: ``D``, ``dt_bias``, ``gnorm``, the MTP module's ``proj``) stays whole;
#: a MoE layer's routed experts are its expert parallelism's
#: (``models.moe.local_experts``)
TP_LEAVES = {
    "top": ("embed", "unembed"),
    "attn": ("wq", "wk", "wv", "bq", "bk", "bv", "wo"),
    "mla": ("wq_b", "wk_b", "wv_b", "wo"),
    "mamba": ("in_proj", "conv_w", "conv_b", "out_proj"),
    "ffn": ("w1", "w3", "w2"),
    "moe": ("sh_w1", "sh_w3", "sh_w2"),
}


def split_dim(name: str, block: Optional[str], shape: Tuple[int, ...],
              model: int, heads: Tuple[int, ...] = ()) -> Optional[int]:
    """The dimension of the whole leaf ``name`` (of ``shape``) in a block
    of kind ``block`` that a model axis of ``model`` ranks splits, or
    ``None`` (the leaf stays whole on every rank): the dimension of the
    ``"model"`` entry of the leaf's rule in ``_RULES``, kept where the
    axis divides it (``_guard``), for the leaves of ``TP_LEAVES[block]``.
    A block's leaves split only when each of ``heads`` (an MLA block's
    heads, a Mamba2 block's SSD heads; none for the other blocks, a GQA
    attention block's included) divides over the axis."""
    if model == 1 or name not in TP_LEAVES.get(block, ()):
        return None
    if any(h % model for h in heads):
        return None
    spec = _guard({"model": model, "data": 1}, _RULES[name](shape), shape)
    return spec.index("model") if "model" in spec else None


def fsdp_dim(name: str, shape: Tuple[int, ...], data: int
             ) -> Optional[int]:
    """The dimension of the whole leaf ``name`` (of ``shape``) that a
    ``data`` axis of ``data`` ranks cuts (FSDP), or ``None`` (the leaf
    stays whole on every data rank): the dimension of the ``"data"``
    entry of the leaf's rule in ``_RULES``, kept where the axis divides
    it (``_guard``). Any block's leaf: the counterpart of ``split_dim``
    for the data axis."""
    if data == 1 or name not in _RULES:
        return None
    spec = _guard({"data": data, "model": 1}, _RULES[name](shape), shape)
    return spec.index("data") if "data" in spec else None


def batch_axes(axis_sizes: AxisSizes) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes)


def _entry(axes: Tuple[str, ...]):
    """A spec entry for several axes, as ``PartitionSpec`` writes it: one
    axis is its name, none is ``None``."""
    if len(axes) == 1:
        return axes[0]
    return axes or None


def _ndim(leaf) -> int:
    # a Python int (decode's position) stands for a 0-d int32 scalar
    return leaf.ndim if isinstance(leaf, torch.Tensor) else 0


def batch_specs(axis_sizes: AxisSizes, batch: Dict[str, Any],
                axes: Optional[Tuple[str, ...]] = None):
    """Shard the leading (batch) dim of every input over the data axes."""
    baxes = axes if axes is not None else batch_axes(axis_sizes)

    def spec(name, leaf):
        n = _ndim(leaf)
        if n == 0:
            return ()
        if leaf.shape[0] % _axis_size(axis_sizes, baxes) == 0:
            return (_entry(baxes),) + (None,) * (n - 1)
        return (None,) * n
    return _map_named(spec, batch)


def cache_specs(caches, axis_sizes: AxisSizes):
    """Cache sharding, one pair per layer application: ``(k, v)``, each
    ``[B, S, KV, D]``, MLA's latent ``(c_kv [B, S, r], k_pe [B, S,
    dr])``, or a Mamba2 layer's ``(conv tail [B, K-1, C], state [B, h,
    p, n])``, whole. The batch over the data axes; for batch 1
    (long-context decode) dim 1 (the cache sequence) over them instead.
    Dim 2 (KV heads, the latent widths) over ``model`` when divisible,
    else dim 1. The reference's rule for its stacked ``[repeat, B, ...]``
    caches, without the leading repeat axis.

    ``models.model.init_cache`` allocates a rank's part by these specs,
    but for two entries: a batch-1 Mamba2 state keeps its heads (dim 1)
    whole over the data axes and cuts them, not ``p``, over ``model``;
    a conv tail cuts the rank's ``x`` channels with all of ``B`` and
    ``C`` (ROADMAP §3). The batch-1 sequence cut over the data axes, the
    sequence cut over ``model`` where the KV heads do not divide over it
    (both ``layers.ContextSplit``, ``layers.cache_axis``), the KV heads
    and the MLA latent's last dimension over ``model``
    (``layers.latent_ways``) are the specs'."""
    baxes = batch_axes(axis_sizes)
    bsize = _axis_size(axis_sizes, baxes)
    msize = axis_sizes["model"]

    def spec(name, leaf):
        shape = tuple(leaf.shape)
        n = len(shape)
        dims = [None] * n
        if n >= 1 and shape[0] % bsize == 0:
            dims[0] = _entry(baxes)
        elif n >= 2 and shape[1] % bsize == 0:
            dims[1] = _entry(baxes)
        if n >= 3 and shape[2] % msize == 0:
            dims[2] = "model"
        elif n >= 2 and dims[1] is None and shape[1] % msize == 0:
            dims[1] = "model"
        return tuple(dims)
    return _map_named(spec, caches)
