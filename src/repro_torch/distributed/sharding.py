"""Sharding rules as data: parameter path -> partition spec.

Port of the reference's ``distributed/sharding.py`` (MaxText-style
logical axes) for the port's layouts. The port runs on one card, so
nothing here places a tensor: the rules are kept as data, for the
dry-run's records and for a mesh of more than one card (ROADMAP queue 1
item 16), with no DTensor until then. A spec is a tuple with one entry
per dimension: an axis name, a tuple of axis names (the batch axes of a
multi-pod mesh), or ``None`` (replicated); ``tuple()`` of the
reference's ``PartitionSpec`` for the same leaf gives the same tuple.
Every function takes the mesh as a mapping of axis sizes
(``launch.mesh.Mesh.shape``).

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
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.layers import ModelContext

Spec = Tuple[Any, ...]
AxisSizes = Mapping[str, int]

#: the reference's ``ModelContext`` fields the port has no counterpart
#: for, and the ROADMAP item that brings each
REFERENCE_ONLY_CONTEXT = {
    # expert parallelism (the reference's ``routed_ep``) exists only
    # across cards
    "moe_impl": "ROADMAP queue 1 item 16 (more than one card)",
    "capacity_factor": "ROADMAP queue 1 item 16 (more than one card)",
    "seq_shard_residual": "ROADMAP queue 1 item 16 (more than one card)",
    "no_tp": "ROADMAP queue 1 item 16 (more than one card)",
    "mesh": "ROADMAP queue 1 item 16 (more than one card)",
    "model_axis": "ROADMAP queue 1 item 16 (more than one card)",
    "data_axes": "ROADMAP queue 1 item 16 (more than one card)",
}


def check_context_fields(kw: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` for a reference-only or unknown
    ``ModelContext`` field."""
    known = {f.name for f in dataclasses.fields(ModelContext)}
    for key in kw:
        if key in REFERENCE_ONLY_CONTEXT:
            raise ValueError(
                f"context field {key!r} belongs to the reference only; "
                f"{REFERENCE_ONLY_CONTEXT[key]} brings it")
        if key not in known:
            raise ValueError(f"unknown context field {key!r}; the port's "
                             f"ModelContext has {sorted(known)}")


def make_context(axis_sizes: Optional[AxisSizes], **kw) -> ModelContext:
    """The port's ``ModelContext`` for a mesh of ``axis_sizes``. One card
    needs no mesh fields; a reference-only or unknown field raises
    ``ValueError``."""
    check_context_fields(kw)
    return ModelContext(**kw)


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


def param_specs(params, axis_sizes: AxisSizes):
    """A spec tree matching the parameter tree (tensors of any device,
    ``meta`` included): the reference's rule per leaf name, per layer."""
    return _map_named(
        lambda name, leaf: _spec_for_leaf(name, tuple(leaf.shape),
                                          axis_sizes), params)


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
    ``[B, S, KV, D]``, or a Mamba2 layer's ``(conv tail [B, K-1, C],
    state [B, h, p, n])``. The batch over the data axes; for batch 1
    (long-context decode) dim 1 (the cache sequence) over them instead.
    Dim 2 (KV heads) over ``model`` when divisible, else dim 1. The
    reference's rule for its stacked ``[repeat, B, ...]`` caches,
    without the leading repeat axis."""
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
