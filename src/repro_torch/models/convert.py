"""Import the reference package's LM and ViT parameters, and its LM
training state, into the port's layout, and export the port's LM
parameters (or gradients) to the reference's. On a mesh,
``local_tp_params`` (``local_tp_state`` for a training state) then keeps
each rank's block: over the model axis its heads, FFN hidden units and
vocabulary rows (``distributed.tensor_parallel``: every leaf whose rule
has ``"model"``, MLA's, Mamba2's, cross-attention's and the MTP layer's
included) and its experts (``local_expert_params``), over the data axis
its FSDP block of each leaf the reference cuts there
(``distributed.fsdp``).

The reference keeps each stage's super-block of layers stacked along a
leading repeat axis (``stage{s}/layer{j}/{attn,ffn}/<name>`` of shape
``[R, ...]``), a shared layer once and unstacked
(``stage{s}_shared/layer{j}/...``), with ``embed [Vp, d]``, ``unembed
[d, Vp]`` and ``final_ln [d]`` at the top: the dense, SSM and audio
families have one stage of one layer, the MoE family a stage of leading
dense layers (``stage0``) and one of MoE layers (``stage1``), the hybrid
family a stage of six Mamba2 layers and one shared attention layer, the
VLM family super-blocks of self-attention layers and a cross-attention
layer (whose 0-d ``gate`` is stacked to ``[R]``). With MTP the
reference keeps the MTP module unstacked under ``mtp`` (``proj``,
``ln_h``, ``ln_e``, ``attn/*``, ``ffn/*``), and so does the port. The
port keeps one dict per layer (``params["layers"][i]``), the stages'
repeats in order and each repeat's layers in order, and a shared layer
under the reference's ``stage{s}_shared/layer{j}``. The ViT keeps the
reference's nested dict as it is. The leaves
come in as numpy arrays (``np.asarray`` of a JAX array gives one), so
the port never imports JAX.

A bfloat16 leaf arrives as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses; it crosses bit for bit as uint16 and is
viewed as ``torch.bfloat16`` on the other side.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import moe as MOE
from repro_torch.models.model import Params, layer_specs
from repro_torch.tree import flatten_with_names, unflatten_like


def to_tensor(a: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """One parameter leaf (numpy or array-like) -> a tensor with the same
    dtype and bits."""
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _to_tensors(tree: Mapping[str, Any],
                device: Optional[torch.device]) -> dict:
    """A nested dict of numpy leaves as one of tensors (``to_tensor``)."""
    return {k: _to_tensors(v, device) if isinstance(v, Mapping)
            else to_tensor(v, device) for k, v in tree.items()}


def import_reference_params(tree: Mapping[str, Any], cfg: ModelConfig, *,
                            device: Optional[torch.device] = None) -> Params:
    """The reference's parameter pytree -> the port's parameters, so that
    both compute the same function; every stage of ``cfg``'s plan, each
    leaf with its dtype and bits. Any tree of the parameters' structure
    converts the same way: AdamW's ``mu`` and ``nu``, the compression's
    error buffer, gradients."""
    layer_specs(cfg)                                # raises if not ported
    out: Params = {"embed": to_tensor(tree["embed"], device),
                   "unembed": to_tensor(tree["unembed"], device),
                   "final_ln": to_tensor(tree["final_ln"], device),
                   "layers": []}
    for si, stage in enumerate(cfg.plan()):
        stacked = tree[f"stage{si}"]
        for r in range(stage.repeat):
            out["layers"] += [
                {part: {name: to_tensor(np.asarray(leaf)[r], device)
                        for name, leaf in leaves.items()}
                 for part, leaves in stacked[f"layer{j}"].items()}
                for j, spec in enumerate(stage.layers) if not spec.shared]
        shared = {f"layer{j}": _to_tensors(
            tree[f"stage{si}_shared"][f"layer{j}"], device)
            for j, spec in enumerate(stage.layers) if spec.shared}
        if shared:
            out[f"stage{si}_shared"] = shared
    if "mtp" in tree:
        out["mtp"] = _to_tensors(tree["mtp"], device)
    return out


def local_expert_params(params: Params, ctx) -> Params:
    """``params`` (the port's LM layout) with each MoE layer's experts cut
    to this rank's ``E/M`` (``moe.local_experts``), the step after
    ``import_reference_params`` on a mesh: every rank then holds the
    numbers that the reference's device at the same mesh position holds.
    Every other leaf is the same tensor."""
    def layer(p):
        return {part: MOE.local_experts(leaves, ctx)
                if part == "ffn" and "router" in leaves else leaves
                for part, leaves in p.items()}
    out = dict(params, layers=[layer(p) for p in params["layers"]])
    for key, shared in params.items():
        if key.endswith("_shared"):
            out[key] = {name: layer(p) for name, p in shared.items()}
    return out


def local_tp_params(params: Params, cfg: ModelConfig, ctx) -> Params:
    """``params`` (the port's LM layout, every leaf whole) -> this rank's
    block on ``ctx``'s mesh (``tensor_parallel.layout``): over the model
    axis each split leaf cut to this rank's ``1/M`` along its split
    dimension (the heads' columns of ``wq``/``wk``/``wv`` and rows of
    ``wo`` in self-, cross- and the MTP layer's attention, or their
    contiguous column and row blocks where the KV heads do not divide
    over the axis, MLA's
    ``wq_b``/``wk_b``/``wv_b`` columns and ``wo`` rows, Mamba2's
    contiguous blocks of ``in_proj`` columns and conv channels and its
    ``out_proj`` rows, the FFN's and shared experts' hidden units, the
    vocabulary rows of ``embed`` and columns of ``unembed``) and, under
    expert parallelism, each MoE layer's experts as
    ``local_expert_params`` cuts them; over the data axis each leaf whose rule has ``"data"``
    cut to this rank's ``1/D`` along that dimension (FSDP,
    ``distributed.fsdp``). One call gives rank ``(d, m)`` of a ``D x M``
    mesh the block that the reference's device at ``(d, m)`` holds.
    Every other leaf is the same tensor; a cut leaf that is not whole
    raises ``ValueError``."""
    return local_tp_keep(cfg, ctx)("", params)


def local_tp_keep(cfg: ModelConfig, ctx):
    """``keep(name, part)`` for ``model.init(..., keep=)``: ``part`` (a
    leaf or a subtree of the port's LM layout, whole, at ``name`` in the
    parameter tree; ``""``: the whole tree) -> this rank's block of it,
    as ``local_tp_params`` cuts it, so that a rank makes its block from
    a seed without holding the whole model."""
    cuts = TP.layout(cfg, ctx)
    if not cuts:
        return lambda name, part: part
    D = TP.data_ways(ctx)
    model = (ctx.mesh.get_local_rank(ctx.model_axis), ctx.tp_size)
    data = (ctx.mesh.get_local_rank("data") if D > 1 else 0, D)

    def cut(name, t):
        return TP.local_block(t, cuts[name], model, data) if name in cuts \
            else t

    def keep(name, part):
        if isinstance(part, torch.Tensor):
            return cut(name, part)
        pre = f"{name}/" if name else ""
        return unflatten_like(part, {
            n: cut(pre + n, t) for n, t in flatten_with_names(part).items()})
    return keep


def local_tp_state(state: Mapping[str, Any], cfg: ModelConfig, ctx
                   ) -> dict:
    """A training state (``train_step.make_train_state``'s, whole) ->
    this rank's: the parameters, both moments and the error buffer cut on
    both axes by ``local_tp_params``; ``step`` as it is."""
    out = dict(state)
    out["params"] = local_tp_params(state["params"], cfg, ctx)
    out["opt"] = {k: local_tp_params(v, cfg, ctx)
                  for k, v in state["opt"].items()}
    if "err" in state:
        out["err"] = local_tp_params(state["err"], cfg, ctx)
    return out


def import_reference_train_state(state: Mapping[str, Any],
                                 cfg: ModelConfig, *,
                                 device: Optional[torch.device] = None
                                 ) -> dict:
    """The reference's training state (``train.train_step``:
    ``{"params", "opt": {"mu", "nu"}, "step", "err"?}``, numpy leaves)
    -> the port's, each parameter-shaped tree in the list-of-layers
    layout and ``step`` an int32 0-d tensor."""
    out = {"params": import_reference_params(state["params"], cfg,
                                             device=device),
           "opt": {k: import_reference_params(state["opt"][k], cfg,
                                              device=device)
                   for k in ("mu", "nu")},
           "step": to_tensor(state["step"], device)}
    if "err" in state:
        out["err"] = import_reference_params(state["err"], cfg,
                                             device=device)
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy; bfloat16 widens exactly to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def export_reference_params(params: Params, cfg: ModelConfig) -> dict:
    """The port's LM parameters, or any tree of their structure
    (gradients, moments), in the reference's layout: each stage of
    ``cfg``'s plan as ``stage{s}/layer{j}`` leaves stacked along a
    leading repeat axis and its shared layers as ``stage{s}_shared``,
    numpy leaves (``to_numpy``)."""
    out = {"embed": to_numpy(params["embed"]),
           "unembed": to_numpy(params["unembed"]),
           "final_ln": to_numpy(params["final_ln"])}
    own = iter(params["layers"])
    for si, stage in enumerate(cfg.plan()):
        per = [j for j, spec in enumerate(stage.layers) if not spec.shared]
        repeats = [[next(own) for _ in per] for _ in range(stage.repeat)]
        out[f"stage{si}"] = {f"layer{j}": {
            part: {name: np.stack([to_numpy(r[i][part][name])
                                   for r in repeats])
                   for name in leaves}
            for part, leaves in repeats[0][i].items()}
            for i, j in enumerate(per)}
        shared = {f"layer{j}": _to_numpy_tree(
            params[f"stage{si}_shared"][f"layer{j}"])
            for j, spec in enumerate(stage.layers) if spec.shared}
        if shared:
            out[f"stage{si}_shared"] = shared
    if "mtp" in params:
        out["mtp"] = _to_numpy_tree(params["mtp"])
    return out


def _to_numpy_tree(tree: Mapping[str, Any]) -> dict:
    """A nested dict of tensors as one of numpy arrays (``to_numpy``)."""
    return {k: _to_numpy_tree(v) if isinstance(v, Mapping) else to_numpy(v)
            for k, v in tree.items()}


def import_reference_vit_params(tree: Mapping[str, Any], cfg, *,
                                device: Optional[torch.device] = None
                                ) -> Params:
    """The reference's ViT parameter pytree (``repro.models.vision``,
    numpy leaves) -> the port's, leaf by leaf: the same nested dict
    (``patch_proj``, ``pos``, ``final_ln``, ``head``,
    ``layer{i}/{attn,ffn}/<name>``). ``cfg`` is the port's
    ``ViTConfig``; a missing or extra top-level key raises."""
    want = {"patch_proj", "pos", "final_ln", "head"} | {
        f"layer{i}" for i in range(cfg.num_layers)}
    if set(tree) != want:
        raise ValueError(f"ViT tree keys {sorted(tree)}, want "
                         f"{sorted(want)}")
    out: Params = {}
    for name, leaf in tree.items():
        if name.startswith("layer"):
            out[name] = {part: {k: to_tensor(a, device)
                                for k, a in leaf[part].items()}
                         for part in ("attn", "ffn")}
        else:
            out[name] = to_tensor(leaf, device)
    return out
