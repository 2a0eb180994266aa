"""Gradient compression: int8 quantization with error feedback.

Port of the reference's ``distributed/compression.py`` over nested
dicts and lists of tensors (``repro_torch.tree``). Each gradient tensor
is quantized to int8 with one scale and dequantized again, and the
quantization residual is carried in an error-feedback buffer (EF-SGD),
so the compression is unbiased over time. On one card there is no
all-reduce to shrink; the values a step applies are those the
reference's data-parallel step would apply.

The int8 bits are the reference's:

* the reference stacks a stage's layers into one leaf, so one scale
  covers a parameter of every layer; here a list in the tree (the
  model's ``layers``) is that stacked axis, and the leaves at the same
  place in each element share one scale;
* the same float32 divide by the scale, and ``torch.round`` rounds half
  to even as ``jnp.round`` does.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

from repro_torch import tree


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


def _stacks(names) -> Dict[str, List[str]]:
    """Leaf names grouped by their name with every list index wildcarded:
    the leaves of one reference (stacked) tensor."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        groups.setdefault(re.sub(r"\[\d+\]", "[*]", name), []).append(name)
    return groups


@torch.no_grad()
def compress_grads_with_feedback(grads, error_buf):
    """(compressed-then-dequantized grads in their own dtypes, new error
    buffer in its dtype)."""
    flat_g = tree.flatten_with_names(grads)
    flat_e = tree.flatten_with_names(error_buf)
    new_g, new_e = {}, {}
    for names in _stacks(flat_g).values():
        g32 = [flat_g[n].float() + flat_e[n].float() for n in names]
        scale = _scale(torch.stack([t.abs().max() for t in g32]).max())
        for n, t in zip(names, g32):
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
