"""Serving layer: prefill / decode step builders and a generate loop.

Port of the reference's ``serve/engine.py``. The steps run eagerly (the
reference jits them); ``generate`` runs on ``current_device()`` — the
card unless the caller asked for the CPU — and refuses parameters that
live elsewhere.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import current_device
from repro_torch.models import model
from repro_torch.models.layers import ModelContext


def make_prefill_step(cfg: ModelConfig, ctx: ModelContext,
                      cache_len: int) -> Callable:
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, cfg, ctx, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: ModelContext) -> Callable:
    def decode_step(params, caches, token, pos):
        return model.decode_step(params, caches, token, pos, cfg, ctx)
    return decode_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(params, prompt: torch.Tensor, cfg: ModelConfig,
             ctx: ModelContext, *, max_new_tokens: int,
             cache_len: Optional[int] = None, greedy: bool = True,
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Batched generation: prefill, then one decode step per new token.

    prompt: [B, S] token ids -> [B, max_new_tokens] ids of prompt's dtype.
    Greedy picks the first index of the largest logit (as ``jnp.argmax``);
    otherwise each token is drawn from softmax(logits) with ``generator``.
    With ``timings`` given, the device is synchronised after the prefill
    and after the last decode step, and the host-clock seconds of each
    are stored under ``"prefill_s"`` and ``"decode_s"``."""
    dev = current_device()
    if params["embed"].device != dev:
        raise ValueError(f"parameters are on {params['embed'].device}, the "
                         f"port runs on {dev}")
    prompt = prompt.to(dev)
    B, S = prompt.shape
    cache_len = cache_len or (S + max_new_tokens)
    prefill_fn = make_prefill_step(cfg, ctx, cache_len)
    decode_fn = make_decode_step(cfg, ctx)

    def pick(logits):
        if greedy or generator is None:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float(), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return tok[:, None].to(prompt.dtype)

    t0 = time.perf_counter()
    caches, logits = prefill_fn(params, prompt)
    tok = pick(logits)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    out = []
    for i in range(max_new_tokens):
        out.append(tok)
        if i == max_new_tokens - 1:
            break
        caches, logits = decode_fn(params, caches, tok, S + i)
        tok = pick(logits)
    if timings is not None:
        _sync(dev)
        timings["decode_s"] = time.perf_counter() - t1
    return torch.cat(out, dim=1)
