"""The port's built-in decode paths, registered into ``repro_torch.codecs``.

Every path is bytes -> RGB uint8 [H, W, 3] over the same codec substrate
(host parse and serial Huffman entropy decode), differing in transform
engine and robustness policy (strict paths reject the rare Adobe-YCCK
mode and progressive streams => skip accounting):

  name          engine  notes                                     strict
  numpy-ref     numpy   separable float IDCT (oracle)             no
  numpy-fast    numpy   Kronecker 64x64 GEMM IDCT                 no
  numpy-int     numpy   13-bit fixed-point IDCT (libjpeg-ish)     no
  numpy-sparse  numpy   DC-shortcut sparse IDCT                   no
  fft-idct      numpy   IDCT via FFT                              no
  strict-fast   numpy   numpy-fast + strict policy                yes
  torch-basic   torch   per-stage spans (reference: jnp-basic)    no
  torch-fused   torch   one transform span (jnp-fused)            no
  torch-batch   torch   one batched transform per group           no
  strict-torch  torch   torch-fused + strict policy               yes
  cuda-idct     cuda    CUDA IDCT kernel (pallas-idct)            no
  cuda-fused    cuda    CUDA dequant+IDCT + colour kernels        no
  cuda-batch    cuda    ONE decode_batch launch per group         no
  strict-cuda   cuda    cuda-idct + strict policy                 yes

The ``torch-*`` and ``cuda-*`` paths run on ``current_device()`` (the
card unless the caller asked for the CPU; on the CPU the ``cuda-*``
paths run each kernel's plain PyTorch version). Paths with a
``batch_fn`` register ``batchable=True``: a micro-batch runs one
transform per same-structure group. ``fork_safe`` holds only for the
numpy engine, since a CUDA context does not survive ``fork()``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.codecs import Capabilities, register_decoder
from repro_torch.device import current_device
from repro_torch.jpeg import huffman, pipeline
from repro_torch.jpeg import parser as P
from repro_torch.kernels import ops
from repro_torch.obs import trace


def _entropy(data: bytes, strict: bool):
    with trace.span("jpeg.parse"):
        spec = P.parse(data)
        if strict:
            P.check_strict(spec)
    # huffman.decode_coefficients emits the jpeg.entropy span itself
    # (it carries the serial/parallel mode + fallback args)
    coef = huffman.decode_coefficients(spec)
    return spec, coef


def _entropy_batch(datas: List[bytes], strict: bool) -> List:
    """Host-side serial entropy decode; per-item exceptions captured."""
    items: List = []
    for d in datas:
        try:
            items.append(_entropy(d, strict))
        except Exception as e:
            items.append(e)
    return items


def _structure_groups(items: List) -> Dict[tuple, List[int]]:
    """Index groups sharing component count + sampling structure (the
    invariants a stacked [B, ...] transform needs)."""
    groups: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        if isinstance(it, BaseException):
            continue
        spec = it[0]
        key = (len(spec.components),
               tuple((c.h, c.v) for c in spec.components))
        groups.setdefault(key, []).append(i)
    return groups


def _batched(transform_group) -> Callable[[List[bytes]], List]:
    """Serial host entropy, then ``transform_group(specs, coefs)`` once
    per same-structure group; a bad item or group fails only itself."""
    def decode_batch(datas: List[bytes], strict: bool = False) -> List:
        items = _entropy_batch(datas, strict)
        out = list(items)                  # exceptions stay in place
        for idxs in _structure_groups(items).values():
            specs = [items[i][0] for i in idxs]
            coefs = [items[i][1] for i in idxs]
            try:
                imgs = transform_group(specs, coefs)
            except Exception as e:         # a bad group fails only its members
                imgs = [e] * len(idxs)
            for i, img in zip(idxs, imgs):
                out[i] = img
        return out
    return decode_batch


def _one_of_batch(batch_fn) -> Callable[[bytes], np.ndarray]:
    """Single-image front for a batched implementation (B=1 batch)."""
    def fn(data: bytes) -> np.ndarray:
        res = batch_fn([data])[0]
        if isinstance(res, BaseException):
            raise res
        return res
    return fn


# ------------------------------------------------------------ numpy family
def _numpy_ref(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    return pipeline.transform_np(spec, coef, fast_idct=False)


def _numpy_fast(data: bytes, strict: bool = False) -> np.ndarray:
    spec, coef = _entropy(data, strict)
    return pipeline.transform_np(spec, coef, fast_idct=True)


def _numpy_int(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    return pipeline.transform_np(spec, coef, int_idct=True)


def _numpy_sparse(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    return pipeline.transform_np(spec, coef, sparse_idct=True)


def _fft_idct(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    # IDCT-II via FFT (type-III DCT through complex FFT), scipy-free
    import numpy.fft as fft

    def idct1(x, axis):
        n = x.shape[axis]
        k = np.arange(n).reshape([-1 if i == axis % x.ndim else 1
                                  for i in range(x.ndim)])
        w = np.exp(1j * np.pi * k / (2 * n))
        xw = x * w * np.sqrt(2 * n)
        xw0 = np.take(x, [0], axis=axis) * (np.sqrt(n) - np.sqrt(2 * n))
        xw = xw + xw0 * (k == 0)
        full = fft.ifft(xw, n=n, axis=axis)
        v = np.real(full)
        idx = np.empty(n, dtype=np.int64)
        idx[::2] = np.arange((n + 1) // 2)
        idx[1::2] = np.arange(n - 1, n // 2 - 1, -1)
        return np.take(v, idx, axis=axis)

    planes = []
    with trace.span("jpeg.dequant_idct"):
        for c in spec.components:
            q = spec.qtables[c.tq].astype(np.float64)
            deq = coef[c.cid] * q[None, None]
            blocks = idct1(idct1(deq, axis=2), axis=3)
            planes.append(pipeline.assemble_plane_np(blocks) + 128.0)
    return pipeline.assemble_image(spec, planes)


# ------------------------------------------------------------ torch family
def _torch_basic(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    return pipeline.transform_torch(spec, coef, staged=True)


def _torch_fused(data: bytes, strict: bool = False) -> np.ndarray:
    spec, coef = _entropy(data, strict)
    return pipeline.transform_torch(spec, coef)


_torch_decode_batch = _batched(pipeline.transform_batch)


# ------------------------------------------------------------ cuda family
def _to_device(a: np.ndarray, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
        current_device())


def _ycbcr_kernel(y, cb, cr) -> np.ndarray:
    return ops.ycbcr2rgb(_to_device(y), _to_device(cb),
                         _to_device(cr)).cpu().numpy()


def _cuda_idct(data: bytes, strict: bool = False) -> np.ndarray:
    spec, coef = _entropy(data, strict)
    planes = []
    with trace.span("jpeg.dequant_idct"):
        for c in spec.components:
            q = spec.qtables[c.tq].astype(np.float32)
            deq = (coef[c.cid] * q[None, None]).astype(np.float32)
            by, bx = deq.shape[:2]
            blocks = ops.idct8x8(_to_device(deq.reshape(-1, 64)))
            planes.append(pipeline.assemble_plane_np(
                blocks.cpu().numpy().reshape(by, bx, 8, 8)) + 128.0)
    return pipeline.assemble_image(spec, planes)


def _cuda_fused(data: bytes) -> np.ndarray:
    spec, coef = _entropy(data, False)
    planes = []
    with trace.span("jpeg.dequant_idct"):
        for c in spec.components:
            q = spec.qtables[c.tq].astype(np.float32)
            by, bx = coef[c.cid].shape[:2]
            blocks = ops.dequant_idct(
                _to_device(coef[c.cid].reshape(-1, 64)),
                _to_device(q.reshape(64)))
            planes.append(pipeline.assemble_plane_np(
                blocks.cpu().numpy().reshape(by, bx, 8, 8)))
    return pipeline.assemble_image(spec, planes, ycbcr_fn=_ycbcr_kernel)


def _cuda_transform_group(specs, coefs) -> List[np.ndarray]:
    """One batched-kernel launch for a whole same-structure group: every
    block row of every (image, component) pair is concatenated into one
    [sum(blocks), 64] array with a per-row quant-table index — the
    per-row gather is what lets rows of different images (and different
    quality levels) share a single launch. Plane assembly stays on the
    host; colour conversion runs the ycbcr2rgb kernel per image."""
    rows, ridx, qtabs, spans = [], [], [], []
    for spec, coef in zip(specs, coefs):
        for c in spec.components:
            grid = coef[c.cid]
            by, bx = grid.shape[:2]
            r = grid.reshape(-1, 64)
            ridx.append(np.full(len(r), len(qtabs), np.int32))
            qtabs.append(spec.qtables[c.tq].astype(np.float32).reshape(64))
            spans.append((len(r), by, bx))
            rows.append(r)
    with trace.span("jpeg.dequant_idct", batch=len(specs)):
        pix = ops.decode_batch(
            _to_device(np.concatenate(rows)),
            _to_device(np.concatenate(ridx), np.int32),
            _to_device(np.stack(qtabs))).cpu().numpy()
    imgs, pos, si = [], 0, 0
    for spec in specs:
        planes = []
        for _ in spec.components:
            nr, by, bx = spans[si]
            si += 1
            blocks = pix[pos:pos + nr].reshape(by, bx, 8, 8)
            pos += nr
            planes.append(pipeline.assemble_plane_np(blocks))
        imgs.append(pipeline.assemble_image(spec, planes,
                                            ycbcr_fn=_ycbcr_kernel))
    return imgs


_cuda_decode_batch = _batched(_cuda_transform_group)


# ------------------------------------------------------------ registration
def _register(name, fn, *, engine="numpy", strict=False, batch_fn=None,
              description=""):
    # every built-in path funnels entropy decode through huffman, so all
    # of them honor the interval-parallel entropy_workers knob AND
    # inherit progressive (SOF2) decode — except the strict paths, whose
    # policy refuses progressive before entropy decode (check_strict)
    register_decoder(
        name, fn,
        caps=Capabilities(engine=engine, strict=strict,
                          fork_safe=(engine == "numpy"),
                          batchable=batch_fn is not None,
                          parallel_entropy=True,
                          progressive=not strict),
        batch_fn=batch_fn, description=description)


_register("numpy-ref", _numpy_ref,
          description="separable float IDCT, reference oracle")
_register("numpy-fast", lambda d: _numpy_fast(d, False),
          description="Kronecker 64x64 GEMM IDCT")
_register("numpy-int", _numpy_int, description="13-bit fixed-point IDCT")
_register("numpy-sparse", _numpy_sparse,
          description="DC-shortcut sparse IDCT")
_register("fft-idct", _fft_idct, description="IDCT via FFT (skimage-style)")
_register("strict-fast", lambda d: _numpy_fast(d, True), strict=True,
          description="numpy-fast + strict JPEG-mode policy")
_register("torch-basic", _torch_basic, engine="torch",
          description="torch transform, per-stage spans")
_register("torch-fused", lambda d: _torch_fused(d, False), engine="torch",
          batch_fn=_torch_decode_batch,
          description="torch whole-image transform")
_register("torch-batch", _one_of_batch(_torch_decode_batch), engine="torch",
          batch_fn=_torch_decode_batch,
          description="torch batched: one transform per structure group")
_register("strict-torch", lambda d: _torch_fused(d, True), engine="torch",
          strict=True, description="torch-fused + strict JPEG-mode policy")
_register("cuda-idct", lambda d: _cuda_idct(d, False), engine="cuda",
          description="CUDA IDCT kernel")
_register("cuda-fused", _cuda_fused, engine="cuda",
          batch_fn=_cuda_decode_batch,
          description="CUDA dequant+IDCT and colour kernels")
_register("cuda-batch", _one_of_batch(_cuda_decode_batch), engine="cuda",
          batch_fn=_cuda_decode_batch,
          description="CUDA batched kernel, per-row quant-table gather")
_register("strict-cuda", lambda d: _cuda_idct(d, True), engine="cuda",
          strict=True, description="cuda-idct + strict JPEG-mode policy")
