"""Post-entropy decode stages: dequant -> IDCT -> upsample -> color -> RGB.

Two halves, as in the reference's ``repro/jpeg/pipeline.py``:

* the numpy half — a copy of the reference's, used by the numpy decode
  paths and by every host-side assembly step (``assemble_image``);
* the torch half — the port of the reference's jnp half: the same
  stages on tensors on ``current_device()``. The IDCT product here is a
  plain ``torch.matmul`` (the reference leaves it to XLA outside any
  kernel); the hand-written kernels live in ``repro_torch.kernels``.

``import_reference_state`` carries a reference-parsed image (spec and
coefficient grids) into the port's own types, so tests can put the same
entropy-decoded coefficients through both transforms.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import current_device
from repro_torch.jpeg import tables as T
from repro_torch.jpeg.parser import Component, DecodeSpec
from repro_torch.kernels import ref
from repro_torch.obs import trace

_IDCT64 = T.idct64_matrix().astype(np.float32)    # [64, 64] kron(C.T, C.T)


# ------------------------------------------------------------------ numpy
def idct_blocks_np(coefs: np.ndarray) -> np.ndarray:
    """[by, bx, 8, 8] dequantized -> spatial blocks (separable matrix IDCT)."""
    c = T.dct_matrix().astype(np.float64)
    return np.einsum("ik,...kl,jl->...ij", c.T, coefs.astype(np.float64), c.T)


def idct_blocks_np_fast(coefs: np.ndarray) -> np.ndarray:
    """Kronecker 64x64 single-GEMM IDCT (batched across blocks)."""
    by, bx = coefs.shape[:2]
    flat = coefs.reshape(-1, 64).astype(np.float32)
    return (flat @ _IDCT64.T).reshape(by, bx, 8, 8)


def idct_blocks_np_sparse(coefs: np.ndarray) -> np.ndarray:
    """DC-shortcut IDCT (beyond-paper live optimization, §Perf):

    At photographic quantization levels a large fraction of blocks carry
    only a DC coefficient; their IDCT is the constant DC/8. GEMM only the
    blocks with AC energy (libjpeg applies the same idea per-row)."""
    by, bx = coefs.shape[:2]
    flat = coefs.reshape(-1, 64).astype(np.float32)
    has_ac = np.any(flat[:, 1:] != 0.0, axis=1)
    out = np.empty_like(flat)
    out[:] = (flat[:, :1] / 8.0)               # DC-only blocks: constant
    if has_ac.any():
        out[has_ac] = flat[has_ac] @ _IDCT64.T
    return out.reshape(by, bx, 8, 8)


def assemble_plane_np(blocks: np.ndarray) -> np.ndarray:
    by, bx = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def upsample_np(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    if fh == 1 and fv == 1:
        return plane
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def ycbcr_to_rgb_np(y, cb, cr) -> np.ndarray:
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return np.stack([r, g, b], axis=-1)


def ycck_to_rgb_np(y, cb, cr, k) -> np.ndarray:
    inv = ycbcr_to_rgb_np(y, cb, cr)           # = 255 - CMY
    cmy = 255.0 - inv
    kk = k[..., None]
    rgb = (255.0 - np.clip(cmy, 0, 255)) * (255.0 - np.clip(kk, 0, 255)) \
        / 255.0
    return rgb


def finalize_np(rgb: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.clip(np.round(rgb[:h, :w]), 0, 255).astype(np.uint8)


def assemble_image(spec: DecodeSpec, planes: Sequence[np.ndarray],
                   ycbcr_fn=None) -> np.ndarray:
    """The shared plane-assembly tail every host-side decode path ends
    with: upsample each component plane to the max sampling factor, crop
    to the common extent, dispatch the 1/3/4-component colorspace
    conversion (gray / YCbCr / Adobe-YCCK), finalize to RGB u8 [H, W, 3].

    ``planes`` are the per-component level-shifted spatial planes, one
    per ``spec.components`` entry, pre-upsample. ``ycbcr_fn`` overrides
    the 3-component conversion (the CUDA paths pass their kernel
    wrapper); 1- and 4-component handling is engine-independent.

    The ``jpeg.assemble`` stage span lives here (not at call sites) so
    every host-side path — numpy, fft, cuda — gets the same
    attribution for free.
    """
    with trace.span("jpeg.assemble"):
        hmax = max(c.h for c in spec.components)
        vmax = max(c.v for c in spec.components)
        planes = [upsample_np(p, hmax // c.h, vmax // c.v)
                  for p, c in zip(planes, spec.components)]
        hh = min(p.shape[0] for p in planes)
        ww = min(p.shape[1] for p in planes)
        planes = [p[:hh, :ww] for p in planes]
        if len(planes) == 1:
            rgb = np.repeat(planes[0][..., None], 3, axis=-1)
        elif len(planes) == 3:
            rgb = (ycbcr_fn or ycbcr_to_rgb_np)(*planes)
        else:
            rgb = ycck_to_rgb_np(*planes)
        return finalize_np(np.asarray(rgb, np.float64), spec.height,
                           spec.width)



def transform_np(spec: DecodeSpec, coef: Dict[int, np.ndarray],
                 fast_idct: bool = True, int_idct: bool = False,
                 sparse_idct: bool = False) -> np.ndarray:
    planes = []
    with trace.span("jpeg.dequant_idct"):
        for c in spec.components:
            q = spec.qtables[c.tq].astype(np.float64)
            deq = coef[c.cid] * q[None, None]
            if sparse_idct:
                blocks = idct_blocks_np_sparse(deq)
            elif int_idct:
                # libjpeg-islow-style scaled integer IDCT (13-bit fixed
                # point)
                m = np.round(_IDCT64 * (1 << 13)).astype(np.int64)
                flat = deq.reshape(-1, 64).astype(np.int64)
                blocks = ((flat @ m.T) >> 13).reshape(
                    deq.shape).astype(np.float64)
            elif fast_idct:
                blocks = idct_blocks_np_fast(deq)
            else:
                blocks = idct_blocks_np(deq)
            planes.append(assemble_plane_np(blocks) + 128.0)
    return assemble_image(spec, planes)


# ------------------------------------------------------------------ torch
def dequant_torch(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    return coefs.to(torch.float32) * qtable.to(torch.float32)


def idct_blocks_torch(deq: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] -> spatial via the Kronecker [64, 64] GEMM."""
    flat = deq.reshape(-1, 64)
    return (flat @ ref.idct_matrix(flat).T).reshape(deq.shape)


def idct_blocks_torch_separable(deq: torch.Tensor) -> torch.Tensor:
    c = torch.from_numpy(T.dct_matrix().astype(np.float32)).to(deq.device)
    return torch.einsum("ik,...kl,jl->...ij", c.T, deq, c.T)


def assemble_plane_torch(blocks: torch.Tensor) -> torch.Tensor:
    """[by, bx, 8, 8] -> [by*8, bx*8]; a leading batch dim is kept."""
    *lead, by, bx = blocks.shape[:-2]
    return blocks.transpose(-3, -2).reshape(*lead, by * 8, bx * 8)


def upsample_torch(plane: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """Nearest-neighbour upsample of the last two dims (np.repeat
    semantics)."""
    if fh == 1 and fv == 1:
        return plane
    return plane.repeat_interleave(fv, dim=-2).repeat_interleave(fh, dim=-1)


def ycbcr_to_rgb_torch(y, cb, cr) -> torch.Tensor:
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return torch.stack([r, g, b], dim=-1)


def ycck_to_rgb_torch(y, cb, cr, k) -> torch.Tensor:
    inv = ycbcr_to_rgb_torch(y, cb, cr)
    cmy = 255.0 - inv
    kk = k[..., None]
    return (255.0 - torch.clamp(cmy, 0, 255)) * \
        (255.0 - torch.clamp(kk, 0, 255)) / 255.0


def finalize_torch(rgb: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Round half to even (as np.round / jnp.round), clamp, to uint8."""
    return torch.clamp(torch.round(rgb[..., :h, :w, :]), 0, 255).to(
        torch.uint8)


def _planes_to_rgb(planes: List[torch.Tensor]) -> torch.Tensor:
    """Crop upsampled planes to their common extent and convert the
    1/3/4-component colorspace to float32 RGB [..., H, W, 3]."""
    hh = min(p.shape[-2] for p in planes)
    ww = min(p.shape[-1] for p in planes)
    planes = [p[..., :hh, :ww] for p in planes]
    if len(planes) == 1:
        return planes[0][..., None].repeat_interleave(3, dim=-1)
    if len(planes) == 3:
        return ycbcr_to_rgb_torch(*planes)
    return ycck_to_rgb_torch(*planes)


def _factors(spec: DecodeSpec) -> Tuple[Tuple[int, int], ...]:
    hmax = max(c.h for c in spec.components)
    vmax = max(c.v for c in spec.components)
    return tuple((hmax // c.h, vmax // c.v) for c in spec.components)


def _component_planes(coefs, qtables, factors, separable: bool
                      ) -> List[torch.Tensor]:
    planes = []
    for coef, qt, (fh, fv) in zip(coefs, qtables, factors):
        deq = dequant_torch(coef, qt)
        blocks = (idct_blocks_torch_separable(deq) if separable
                  else idct_blocks_torch(deq))
        planes.append(upsample_torch(assemble_plane_torch(blocks) + 128.0,
                                     fh, fv))
    return planes


def transform_torch(spec: DecodeSpec, coef: Dict[int, np.ndarray],
                    staged: bool = False,
                    separable: bool = False) -> np.ndarray:
    """One image's transform on ``current_device()`` -> RGB u8 [H, W, 3].

    ``staged=False`` (the fused paths) times the whole device transform
    as one ``jpeg.transform`` span, like the reference's jitted form;
    ``staged=True`` (``torch-basic``) times dequant+IDCT and assembly as
    separate stage spans, like the reference's eager form."""
    dev = current_device()
    coefs = [torch.as_tensor(coef[c.cid], dtype=torch.float32, device=dev)
             for c in spec.components]
    qts = [torch.as_tensor(spec.qtables[c.tq], dtype=torch.float32,
                           device=dev) for c in spec.components]
    factors = _factors(spec)
    if not staged:
        with trace.span("jpeg.transform"):
            planes = _component_planes(coefs, qts, factors, separable)
            out = finalize_torch(_planes_to_rgb(planes), spec.height,
                                 spec.width)
            return out.cpu().numpy()
    with trace.span("jpeg.dequant_idct"):
        planes = _component_planes(coefs, qts, factors, separable)
    with trace.span("jpeg.assemble"):
        out = finalize_torch(_planes_to_rgb(planes), spec.height,
                             spec.width)
        return out.cpu().numpy()


# -------------------------------------------------- batched transforms
# Observability hook: incremented once per batched transform. The tests
# assert a full same-structure group costs ONE transform, not B.
TRANSFORM_BATCH_CALLS = 0


def batch_layout(specs: Sequence[DecodeSpec],
                 coefs: Sequence[Dict[int, np.ndarray]]):
    """Stack per-image coefficient grids into bucket-padded batch arrays.

    All specs must share component count and sampling structure (the
    bucket invariants). Grids inside a bucket may differ by up to the
    bucket granularity; smaller members are zero-padded — zero blocks
    IDCT to flat gray that the per-image crop discards.

    -> (stacked [B, by, bx, 8, 8] f32 per component,
        stacked [B, 8, 8] f32 qtables per component)
    """
    base = specs[0]
    n_comp = len(base.components)
    for s in specs[1:]:
        if len(s.components) != n_comp or \
                [(c.h, c.v) for c in s.components] != \
                [(c.h, c.v) for c in base.components]:
            raise ValueError("batch members must share sampling structure")
    stacked, qstacked = [], []
    for k in range(n_comp):
        grids = [coefs[b][specs[b].components[k].cid] for b in range(len(specs))]
        by = max(g.shape[0] for g in grids)
        bx = max(g.shape[1] for g in grids)
        out = np.zeros((len(specs), by, bx, 8, 8), np.float32)
        for b, g in enumerate(grids):
            out[b, :g.shape[0], :g.shape[1]] = g
        stacked.append(out)
        qstacked.append(np.stack(
            [s.qtables[s.components[k].tq].astype(np.float32)
             for s in specs]))
    return stacked, qstacked


def transform_batch(specs: Sequence[DecodeSpec],
                    coefs: Sequence[Dict[int, np.ndarray]],
                    separable: bool = False) -> List[np.ndarray]:
    """Decode a same-structure batch with one batched transform on
    ``current_device()``.

    The per-image results are byte-identical to ``transform_torch`` on
    each member as long as the device's matmul gives a row the same
    result whatever the row count: every other stage is pointwise per
    image. Rounds in float32, as the reference's batched transform does.
    """
    global TRANSFORM_BATCH_CALLS
    stacked, qstacked = batch_layout(specs, coefs)
    factors = _factors(specs[0])
    TRANSFORM_BATCH_CALLS += 1
    dev = current_device()
    with trace.span("jpeg.transform", batch=len(specs)):
        coef_t = [torch.from_numpy(s).to(dev) for s in stacked]
        # [B, 8, 8] -> [B, 1, 1, 8, 8] against [B, by, bx, 8, 8]
        q_t = [torch.from_numpy(q).to(dev)[:, None, None] for q in qstacked]
        planes = _component_planes(coef_t, q_t, factors, separable)
        rgb = _planes_to_rgb(planes)
        out = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
        out = out.cpu().numpy()
    return [out[b, :s.height, :s.width] for b, s in enumerate(specs)]


# ------------------------------------------------ reference state import
def import_reference_state(spec, coef: Dict[int, np.ndarray]
                           ) -> Tuple[DecodeSpec, Dict[int, np.ndarray]]:
    """Carry a reference-parsed image into the port's own types.

    The decode path has no learned weights: its constant state is the
    IDCT matrix, which the port rebuilds from its own ``tables``. What
    varies per image is the parsed spec and the coefficient grids. This
    reads the plain fields of any ``DecodeSpec``-shaped object (height,
    width, per-component ``cid/h/v/tq``, quant tables, Adobe transform)
    and its ``{cid: [by, bx, 8, 8]}`` coefficients, and returns the
    port's ``DecodeSpec`` (no entropy-coded data: the transform does not
    read it) with copied coefficient arrays."""
    port = DecodeSpec(
        height=int(spec.height), width=int(spec.width),
        components=[Component(cid=int(c.cid), h=int(c.h), v=int(c.v),
                              tq=int(c.tq)) for c in spec.components],
        qtables={int(k): np.array(v) for k, v in spec.qtables.items()},
        htables={}, scan_data=b"",
        adobe_transform=spec.adobe_transform)
    return port, {int(k): np.array(v) for k, v in coef.items()}
