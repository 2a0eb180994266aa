#!/usr/bin/env python3
"""What bounds the float32 flash-attention kernel at its main shapes.

    PYTHONPATH=src python3 tools/probe_flash.py

Builds ``csrc/flash_attention.cu`` twice, as it ships and with
``-DREPRO_FLASH_PROBE_NO_MATH`` (every warp skips its QK^T, softmax and
PV, so what remains is the launch, the TMA loads, the barriers and the
stores), and times both on float32 inputs by ``chip_smoke.cuda_ms``
(CUDA-graph replay of 20 calls) at the ViT-100m training shape, the
`small` ViT's and the LM prefill's. The difference is the arithmetic's
share of the kernel. Needs one NVIDIA card and nvcc; prints the card's
name and power limit.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (B, S, H, KV, D), causal
SHAPES = [((16, 64, 12, 12, 64), False),     # ViT-100m attention
          ((16, 64, 4, 4, 48), False),       # the `small` ViT's
          ((4, 2048, 28, 4, 128), True)]     # qwen2-7b prefill, float32


def _build(tmp, name, extra):
    from repro_torch.kernels import build
    lib = os.path.join(tmp, f"lib{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", lib,
                    str(build.CSRC / "flash_attention.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).repro_flash_attention
    fn.argtypes = build.SIGNATURES["flash_attention"]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    from chip_smoke import bound_ms, cuda_ms, flash_work, smi_line
    if not torch.cuda.is_available():
        print("probe_flash: no CUDA card visible", file=sys.stderr)
        return 2
    print("card:", smi_line())
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"kernel": _build(tmp, "full", []),
               "no arithmetic": _build(tmp, "probe",
                                       ["-DREPRO_FLASH_PROBE_NO_MATH"])}
        for shape, causal in SHAPES:
            B, S, H, KV, D = shape
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda")
                       for n in (H, KV, KV))
            out = torch.empty_like(q)

            def call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, S, H, KV, D, int(causal), 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")

            ms = {}
            for name in ("kernel", "no arithmetic", "no arithmetic",
                         "kernel"):           # A B B A
                t = cuda_ms(lambda: call(fns[name]))
                ms[name] = min(ms.get(name, t), t)
            b_ms, b_by = bound_ms(*flash_work(*shape, causal, 4))
            print(f"{shape} causal={causal}: kernel {ms['kernel']} ms, "
                  f"without its arithmetic {ms['no arithmetic']} ms "
                  f"({ms['no arithmetic'] / ms['kernel']} of it); bound "
                  f"{b_ms} ms ({b_by})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
