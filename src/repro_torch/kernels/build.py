"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles on its
own into ``build/repro_torch/<hash>/lib<name>.so`` at the checkout's
root (``.gitignore`` lists ``build/``). ``<hash>`` covers every source
and header in ``csrc/`` plus the compiler flags, so an edited kernel
never loads a stale library. ``load_all`` starts one ``nvcc`` per
source, all at once, and waits for them together.

No PyTorch headers are involved (a build that includes them takes
minutes); pointers and the stream cross as ``c_void_p``. The driver API
that ``flash_attention_wgmma.cu`` needs for its TMA tensor maps
(``cuTensorMapEncodeTiled``) is reached through the runtime's
``cudaGetDriverEntryPoint``, so nothing links against ``libcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each kernel's entry point (all return a cudaError_t).
SIGNATURES: Dict[str, List] = {
    "decode_batch": [_P, _P, _P, _I, _P, _P, _L, _P],
    "dequant_idct": [_P, _P, _P, _P, _L, _P],
    "idct8x8": [_P, _P, _P, _L, _P],
    "ycbcr2rgb": [_P, _P, _P, _P, _L, _P],
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: what the last build printed, per kernel (ptxas register/smem lines)
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or "
                       "under /usr/local/cuda)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: pathlib.Path) -> None:
    """Compile every missing library in parallel; raise on any failure."""
    global BUILD_SECONDS
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        # build under a private name, then rename: concurrent builders
        # (test workers, a second process) never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, lib)
    if procs:
        BUILD_SECONDS = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library."""
    with _lock:
        if len(_loaded) == len(SIGNATURES):
            return dict(_loaded)
        out_dir = BUILD_ROOT / source_hash()
        _build_all(out_dir)
        for name, argtypes in SIGNATURES.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            fn = getattr(lib, f"repro_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return dict(_loaded)


def kernel(name: str):
    """The ctypes entry point ``repro_<name>`` of one kernel."""
    lib = _loaded.get(name) or load_all()[name]
    return getattr(lib, f"repro_{name}")
