"""Kernel microbenches of the port: each hand-written CUDA kernel against
its plain PyTorch version (``kernels.ref``), at the reference's shapes and
seeds (``benchmarks/kernels_bench.py``, which times jnp references and
Pallas interpret mode instead).

On the card every kernel row goes through ``kernels.ops``, so it launches
the CUDA kernel, and is timed with CUDA events (``common.time_us``: the
best of 5 repeats, each one eager call, wrapper and launch included). Its
derived column carries ``max_abs_err`` against the plain version on the
card, ``bound_us`` (the bytes one call must move, each input read once and
each output written once, at ``common.hw.H100_SXM``'s HBM rate) and the
fraction of that bound the call reached. The plain versions get rows of
their own, named ``ref_torch``.

On the CPU (``--device cpu``) the same rows run the wrappers' CPU route,
which is the plain version, and are labelled ``plain``; a host time gets
no fraction of the card's bound.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.views.common import time_us
from repro_torch.common.hw import H100_SXM
from repro_torch.device import current_device
from repro_torch.kernels import ops, ref

F32 = 4
IDCT_BYTES = 64 * 64 * F32          # the IDCT matrix every row kernel reads


def bound_us(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``, in us."""
    return nbytes / H100_SXM.hbm_bandwidth * 1e6


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _route(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "plain"


def _kernel_derived(dev, out, want, nbytes, us) -> str:
    err = float((out - want).abs().max())
    b = bound_us(nbytes)
    frac = f"{b / us:.3f}" if dev.type == "cuda" else "n/a(host)"
    return f"max_abs_err={err:.3e} bound_us={b:.3f} frac_of_bound={frac}"


def _pair(name, shape, dev, kernel, plain, extra_bytes, args):
    """The kernel's row and its plain version's row on the same inputs."""
    out = kernel(*args)
    want = plain(*args)
    us = time_us(lambda: kernel(*args))
    nbytes = _nbytes(*args, out) + extra_bytes
    return [(f"kernel.{name}.{_route(dev)}[{shape}]", us,
             _kernel_derived(dev, out, want, nbytes, us)),
            (f"kernel.{name}.ref_torch[{shape}]",
             time_us(lambda: plain(*args)), "plain version (kernels.ref)")]


def _ycbcr2rgb_plain(y, cb, cr):
    return torch.stack(ref.ycbcr2rgb(y, cb, cr), dim=-1)


def row_inputs(quick: bool = True):
    """The reference's row-kernel inputs (seed 0), as numpy: x [n, 64]
    f32 coefficients (n 1024, or 8192 with ``quick=False``), q [64] f32
    quant row, y [256, 128] f32 plane (used for all three planes)."""
    n = 1024 if quick else 8192
    rng = np.random.RandomState(0)
    x = rng.randn(n, 64).astype(np.float32) * 50
    q = rng.randint(1, 99, size=64).astype(np.float32)
    y = rng.uniform(0, 255, (256, 128)).astype(np.float32)
    return x, q, y


def run(quick: bool = True):
    dev = current_device()
    x, q, y = (torch.from_numpy(a).to(dev) for a in row_inputs(quick))
    n = x.shape[0]
    rows = []
    rows += _pair("idct8x8", f"{n}x64", dev, ops.idct8x8, ref.idct8x8,
                  IDCT_BYTES, (x,))
    rows += _pair("dequant_idct", f"{n}x64", dev, ops.dequant_idct,
                  ref.dequant_idct, IDCT_BYTES, (x, q))
    rows += _pair("ycbcr2rgb", "256x128", dev, ops.ycbcr2rgb,
                  _ycbcr2rgb_plain, 0, (y, y, y))
    rows.extend(batched_vs_serial(quick=quick))
    return rows


def batched_inputs(quick: bool = True):
    """The reference's batched-vs-serial inputs (seed 1): ``batch`` images
    of ``blocks`` rows each, one quant table per image. Returns numpy
    (x [batch*blocks, 64] f32, qtables [batch, 64] f32, qidx [batch*blocks]
    i32, batch, blocks)."""
    batch = 8
    blocks = 256 if quick else 2048          # blocks per image
    rng = np.random.RandomState(1)
    x = (rng.randint(-200, 200, size=(batch * blocks, 64))
         .astype(np.float32))
    qt = rng.randint(1, 99, size=(batch, 64)).astype(np.float32)
    qi = np.repeat(np.arange(batch, dtype=np.int32), blocks)
    return x, qt, qi, batch, blocks


def serial_dequant_idct(dequant_idct, x, qtables, batch, blocks):
    """The serial per-image loop the service used to run: one
    ``dequant_idct`` call (one launch on the card) per image; returns
    the per-image outputs."""
    return [dequant_idct(x[b * blocks:(b + 1) * blocks], qtables[b])
            for b in range(batch)]


def batched_vs_serial(quick: bool = True):
    """The reference's tentpole comparison on the port: one
    ``decode_batch`` call over a whole micro-batch's rows (per-row
    quant-table gather) against the serial per-image ``dequant_idct``
    loop. On the card the serial loop's events span its 8 host launches
    and the host gaps between them, which is the point of the comparison
    (the loop is not graph-captured)."""
    dev = current_device()
    route = _route(dev)
    x_np, qt_np, qi_np, batch, blocks = batched_inputs(quick)
    x = torch.from_numpy(x_np).to(dev)
    qt = torch.from_numpy(qt_np).to(dev)
    qi = torch.from_numpy(qi_np).to(dev)
    shape = f"{batch}x{blocks}x64"

    out = ops.decode_batch(x, qi, qt)
    want = ref.decode_batch(x, qi, qt)
    serial = torch.cat(serial_dequant_idct(ops.dequant_idct, x, qt,
                                           batch, blocks))
    t_b = time_us(lambda: ops.decode_batch(x, qi, qt))
    t_s = time_us(lambda: serial_dequant_idct(ops.dequant_idct, x, qt,
                                              batch, blocks))
    t_ref = time_us(lambda: ref.decode_batch(x, qi, qt))
    ratio = t_s / t_b if t_b else float("inf")
    batched_vs = float((out - serial).abs().max())
    nbytes = _nbytes(x, qi, qt, out) + IDCT_BYTES
    return [
        (f"kernel.decode_batch.batched.{route}[{shape}]", t_b,
         "one launch, per-row qtable gather; "
         + _kernel_derived(dev, out, want, nbytes, t_b)),
        (f"kernel.decode_batch.serial_loop.{route}[{shape}]", t_s,
         f"{batch} per-image dequant_idct launches; the timing spans the "
         f"host gaps between them; max_abs_diff_vs_batched="
         f"{batched_vs:.3e}"),
        (f"kernel.decode_batch.ref_torch[{shape}]", t_ref,
         "plain version (kernels.ref)"),
        (f"kernel.decode_batch.speedup.{route}", ratio,
         f"batched_vs_serial_ratio={ratio:.2f}"),
    ]
