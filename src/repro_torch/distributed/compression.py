"""Gradient compression: int8 quantization with error feedback.

Port of the reference's ``distributed/compression.py`` over nested
dicts and lists of tensors (``repro_torch.tree``). Each gradient tensor
is quantized to int8 with one scale and dequantized again, and the
quantization residual is carried in an error-feedback buffer (EF-SGD),
so the compression is unbiased over time. On one card there is no
all-reduce to shrink; the values a step applies are those the
reference's data-parallel step would apply.

The int8 bits are the reference's:

* the reference stacks each layer of a stage's block into one leaf
  (``stage{s}/layer{j}``), so one scale covers that parameter of every
  repeat; here a list in the tree (the model's ``layers``) holds the
  repeats, and the leaves at the same place in the elements of one
  stack share one scale. ``layer_stacks`` (``model.layer_stacks``)
  names each element's stack; the elements of any other list are one
  stack;
* the same float32 divide by the scale, and ``torch.round`` rounds half
  to even as ``jnp.round`` does.

On a mesh each rank holds its block of the cut leaves
(``tensor_parallel.layout``: over the model axis the tensor-parallel
leaves and each MoE layer's experts, over the ``data`` axis the FSDP
leaves); their scale is the maximum over the whole leaf, as the
reference computes it on the global gradient: the maxima of the stacks
that hold a cut leaf are reduced over both axes
(``data_parallel.whole_max``). The error buffer stays the rank's block.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import data_parallel
from repro_torch.distributed.tensor_parallel import cuts_of


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax.float(), min=1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127,
                       127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values in [-127, 127], float32 scale = max|x| / 127)."""
    scale = _scale(x.abs().max())
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _stacks(names, layer_stacks: Sequence[str]) -> Dict[str, List[str]]:
    """Leaf names grouped by their name with ``layers/[i]`` replaced by
    element i's stack (``layer_stacks``) and every list index
    wildcarded: the leaves of one reference (stacked) tensor."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        key = re.sub(r"^layers/\[(\d+)\]",
                     lambda m: f"layers/{layer_stacks[int(m[1])]}", name)
        groups.setdefault(re.sub(r"\[\d+\]", "[*]", key), []).append(name)
    return groups


@torch.no_grad()
def compress_grads_with_feedback(grads, error_buf,
                                 layer_stacks: Sequence[str], ctx=None,
                                 split=None):
    """(compressed-then-dequantized grads in their own dtypes, new error
    buffer in its dtype); ``layer_stacks``: the reference's stack of
    each element of the trees' ``layers`` (module docstring); ``ctx``, a
    context on a mesh, makes the scales of the leaves that ``split``
    cuts (``tensor_parallel.layout``) the whole leaves'."""
    flat_g = tree.flatten_with_names(grads)
    flat_e = tree.flatten_with_names(error_buf)
    stacks = list(_stacks(flat_g, layer_stacks).values())

    def g32(names):
        return [flat_g[n].float() + flat_e[n].float() for n in names]

    def amax(ts):
        return torch.stack([t.abs().max() for t in ts]).max()
    # a cut leaf's stack: its maximum over the axes first
    parts = set(cuts_of(flat_g, split or {})) \
        if data_parallel.model_groups(ctx) or \
        data_parallel.fsdp_groups(ctx) else set()
    cut = [i for i, names in enumerate(stacks) if parts & set(names)]
    whole = dict(zip(cut, data_parallel.whole_max(
        [amax(g32(stacks[i])) for i in cut], ctx)))
    new_g, new_e = {}, {}
    for i, names in enumerate(stacks):
        ts = g32(names)
        scale = _scale(whole[i] if i in whole else amax(ts))
        for n, t in zip(names, ts):
            deq = dequantize_int8(_quantize(t, scale), scale)
            new_g[n] = deq.to(flat_g[n].dtype)
            new_e[n] = (t - deq).to(flat_e[n].dtype)
    return (tree.unflatten_like(grads, new_g),
            tree.unflatten_like(grads, new_e))


@torch.no_grad()
def init_error_buffer(params, dtype: str = "bfloat16"):
    """Zeros of each parameter's shape in ``dtype``, on its device."""
    dt = getattr(torch, dtype)
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
