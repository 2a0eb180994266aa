"""Import the reference package's LM and ViT parameters, and its LM
training state, into the port's layout, and export the port's LM
parameters (or gradients) to the reference's.

The reference keeps each stage's layers stacked along a leading repeat
axis (``stage0/layer0/{attn,ffn}/<name>`` of shape ``[R, ...]``) with
``embed [Vp, d]``, ``unembed [d, Vp]`` and ``final_ln [d]`` at the top.
The port keeps one dict per layer (``params["layers"][i]``). The ViT
keeps the reference's nested dict as it is. The leaves
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
from repro_torch.models.model import Params, layer_specs


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


def import_reference_params(tree: Mapping[str, Any], cfg: ModelConfig, *,
                            device: Optional[torch.device] = None) -> Params:
    """The reference's parameter pytree -> the port's parameters, so that
    both compute the same function. Dense family only. Any tree of the
    parameters' structure converts the same way: AdamW's ``mu`` and
    ``nu``, the compression's error buffer, gradients."""
    specs = layer_specs(cfg)
    stage = tree["stage0"]["layer0"]
    layers = []
    for i in range(len(specs)):
        layers.append({
            part: {name: to_tensor(np.asarray(leaf)[i], device)
                   for name, leaf in stage[part].items()}
            for part in ("attn", "ffn")})
    return {"embed": to_tensor(tree["embed"], device),
            "unembed": to_tensor(tree["unembed"], device),
            "final_ln": to_tensor(tree["final_ln"], device),
            "layers": layers}


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


def export_reference_params(params: Params) -> dict:
    """The port's LM parameters, or any tree of their structure
    (gradients, moments), in the reference's layout: ``stage0/layer0``
    leaves stacked along a leading layer axis, numpy leaves
    (``to_numpy``)."""
    layers = params["layers"]
    stage = {part: {name: np.stack([to_numpy(layer[part][name])
                                    for layer in layers])
                    for name in layers[0][part]}
             for part in ("attn", "ffn")}
    return {"embed": to_numpy(params["embed"]),
            "unembed": to_numpy(params["unembed"]),
            "final_ln": to_numpy(params["final_ln"]),
            "stage0": {"layer0": stage}}


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
