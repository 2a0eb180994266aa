"""Public wrappers around the CUDA kernels: the four decode kernels and
the LM prefill's flash attention, which has two kernels (one per dtype
route, see ``flash_kernel_for``).

A wrapper checks its inputs, then:

* for tensors on the CPU, runs the plain PyTorch version (``ref``) —
  that is how the CPU tests reach the code around the kernels;
* for tensors on a CUDA device, launches the hand-written kernel on the
  current stream and raises if the launch fails. There is no fallback:
  a CUDA tensor reaches the kernel or the call raises.

Every kernel launch adds one to ``LAUNCHES[<kernel>]``, and nothing
else does, so a run can show that its main path went through the
kernels. No rows are padded to a tile size: the kernels mask the ragged
edge themselves.

``flash_attention`` is differentiable: when grad is enabled and an
input requires grad, the call goes through ``_FlashAttention``, whose
forward is the same one launch (or, on the CPU, the plain version) and
whose backward is the attention gradient in float32 tensor math
(``_flash_attention_grad``), as XLA derives it for the reference's
attention. No backward kernel is launched.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

#: launches per kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {name: 0 for name in build.SIGNATURES}
_launches_lock = threading.Lock()

_IDCT64_T = np.ascontiguousarray(ref.IDCT64.T)   # [k, j] = M[j, k]
_matrix_on: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} must have shape {shape} (None = any), "
                         f"got {tuple(t.shape)}")


def _on_card(*tensors: torch.Tensor) -> bool:
    """True: launch the kernel; False: every tensor is on the CPU."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _aligned16(**tensors: torch.Tensor) -> None:
    """The kernels read their rows in 16-byte vectors."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the CUDA "
                             f"kernel (a row slice of a contiguous [N, 64] "
                             f"tensor, or a fresh tensor, is)")


def _idct_t(device: torch.device) -> torch.Tensor:
    m = _matrix_on.get(device)
    if m is None:
        m = torch.from_numpy(_IDCT64_T).to(device)
        _matrix_on[device] = m
    return m


def _launch(name: str, device: torch.device, *args) -> None:
    fn = build.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    with _launches_lock:
        LAUNCHES[name] += 1


def idct8x8(x: torch.Tensor) -> torch.Tensor:
    """[N, 64] f32 dequantized coefficients -> [N, 64] spatial rows."""
    _check("x", x, torch.float32, (None, 64))
    if not _on_card(x):
        return ref.idct8x8(x)
    _aligned16(x=x)
    out = torch.empty_like(x)
    if x.shape[0]:
        _launch("idct8x8", x.device, x.data_ptr(),
                _idct_t(x.device).data_ptr(), out.data_ptr(), x.shape[0])
    return out


def dequant_idct(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, 64] raw coefficients + [64] quant row -> clamped pixel rows."""
    _check("x", x, torch.float32, (None, 64))
    _check("q", q, torch.float32, (64,))
    if not _on_card(x, q):
        return ref.dequant_idct(x, q)
    _aligned16(x=x, q=q)
    out = torch.empty_like(x)
    if x.shape[0]:
        _launch("dequant_idct", x.device, x.data_ptr(), q.data_ptr(),
                _idct_t(x.device).data_ptr(), out.data_ptr(), x.shape[0])
    return out


def decode_batch(x: torch.Tensor, qidx: torch.Tensor,
                 qtables: torch.Tensor) -> torch.Tensor:
    """Batched fused dequant+IDCT: [N, 64] rows + [N] int32 per-row
    table index + [T, 64] quant tables -> [N, 64] clamped pixel rows (one
    launch for a whole micro-batch; rows from different images interleave
    freely). On the card a row whose index is outside [0, T) comes out
    NaN; on the CPU any such index, -1 included, raises IndexError
    (torch indexing would wrap a negative one to a table)."""
    _check("x", x, torch.float32, (None, 64))
    n = x.shape[0]
    _check("qidx", qidx, torch.int32, (n,))
    _check("qtables", qtables, torch.float32, (None, 64))
    if not _on_card(x, qidx, qtables):
        t = qtables.shape[0]
        if n and (int(qidx.min()) < 0 or int(qidx.max()) >= t):
            raise IndexError(f"table index outside [0, {t}): "
                             f"{int(qidx.min())}..{int(qidx.max())}")
        return ref.decode_batch(x, qidx, qtables)
    _aligned16(x=x, qtables=qtables)
    out = torch.empty_like(x)
    if n:
        _launch("decode_batch", x.device, x.data_ptr(), qidx.data_ptr(),
                qtables.data_ptr(), qtables.shape[0],
                _idct_t(x.device).data_ptr(), out.data_ptr(), n)
    return out


def ycbcr2rgb(y: torch.Tensor, cb: torch.Tensor,
              cr: torch.Tensor) -> torch.Tensor:
    """[H, W] f32 planes -> [H, W, 3] f32 RGB (no clamp)."""
    shape = tuple(y.shape)
    for name, p in (("y", y), ("cb", cb), ("cr", cr)):
        _check(name, p, torch.float32, shape)
    if not _on_card(y, cb, cr):
        return torch.stack(ref.ycbcr2rgb(y, cb, cr), dim=-1)
    out = torch.empty(shape + (3,), dtype=torch.float32, device=y.device)
    if y.numel():
        _launch("ycbcr2rgb", y.device, y.data_ptr(), cb.data_ptr(),
                cr.data_ptr(), out.data_ptr(), y.numel())
    return out


#: head dims the FFMA flash kernel is instantiated for (float32 at all of
#: them, bfloat16 at those the wgmma kernel does not take)
FLASH_HEAD_DIMS = (16, 32, 48, 64, 80, 128)
#: head dims the bf16 wgmma flash kernel is instantiated for
WGMMA_HEAD_DIMS = (64, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The one kernel that computes flash attention on the card for this
    dtype and head dim: bfloat16 at D in ``WGMMA_HEAD_DIMS`` goes to
    ``flash_attention_wgmma`` (tensor cores); float32, and bfloat16 at the
    other D of ``FLASH_HEAD_DIMS``, to ``flash_attention`` (FP32 FFMA,
    exact float32 products)."""
    if dtype not in _FLASH_DTYPES:
        raise TypeError(f"no flash kernel for {dtype}")
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {FLASH_HEAD_DIMS}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "flash_attention_wgmma"
    return "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention over a whole sequence: q [B, S, H, D], k and v
    [B, S, KV, D] (KV divides H; query head h uses KV head h // (H // KV))
    -> [B, S, H, D] in q's dtype. float32 or bfloat16, the same for all
    three; D in ``FLASH_HEAD_DIMS``; scale 1/sqrt(D).

    On the card the call launches exactly one kernel, chosen by
    ``flash_kernel_for(dtype, D)``: bfloat16 at D = 64 or 128 runs
    ``flash_attention_wgmma``, everything else (float32 at D 16, 32, 48,
    64, 80 and 128; bfloat16 at D 16, 32, 48 and 80) ``flash_attention``.
    When grad is enabled and an input requires grad, the result carries
    a ``grad_fn`` whose backward is ``_flash_attention_grad``."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a torch.Tensor, got {type(q)}")
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    _check("k", k, q.dtype, (B, S, None, D))
    KV = k.shape[2]
    _check("v", v, q.dtype, (B, S, KV, D))
    if KV == 0 or H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} query heads")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {FLASH_HEAD_DIMS}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_forward(q, k, v, causal)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    if not _on_card(q, k, v):
        return ref.flash_attention(q, k, v, causal)
    _aligned16(q=q, k=k, v=v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    out = torch.empty_like(q)
    if out.numel():
        name = flash_kernel_for(q.dtype, D)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, KV, D, int(causal))
        if name == "flash_attention":
            args += (_FLASH_DTYPES[q.dtype],)
        _launch(name, q.device, *args)
    return out


def _flash_attention_grad(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, dout: torch.Tensor,
                          causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """dq, dk, dv of softmax(q k^T / sqrt(D)) v for the output gradient
    ``dout``, in float32 and cast back to the inputs' dtype. P is
    recomputed (causal mask at -1e30, as the forward); with dP = dO V^T:

        dV = P^T dO,  dS = P * (dP - rowsum(dO * O)),
        dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),

    where rowsum(dO * O) is taken as rowsum(P * dP), the same sum with
    O = P V in float32 (not the output rounded to a bf16 q's dtype).
    Query heads that share a KV head sum their dK and dV."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, KV, H // KV, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)                          # [B,KV,r,Sq,Sk]
    dp = torch.einsum("bqgrd,bkgd->bgrqk", do, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, do)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is the wrapper's
    one launch (the plain version on the CPU), the backward
    ``_flash_attention_grad``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _flash_attention_grad(q, k, v, dout, ctx.causal)
        return dq, dk, dv, None
