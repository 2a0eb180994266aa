#!/usr/bin/env python3
"""Shared-memory load cost on the card, by the addresses a warp reads.

    PYTHONPATH=src python3 tools/probe_shared_loads.py

Each pattern is one warp instruction that the row-IDCT kernels issue in
their inner loops (``csrc/decode_batch.cu``, ``csrc/dct_rows.cuh``). A
block of 16 warps on every SM repeats it (``ld.volatile.shared``, so
nothing is hoisted) and ``clock64`` gives the SM cycles per warp
instruction: the time the shared-memory pipe is held, which bounds how
many loads a kernel can issue beside its FFMAs (an SM issues 4 warp
FFMAs a cycle). Needs one NVIDIA card and nvcc; prints the card's name
and power limit.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// offset in floats of the float4 (or float) lane `lane` reads
template <int P>
__device__ int offset(int lane) {
  switch (P) {
    case 0: return 0;                      // one address
    case 1: return (lane / 8) * 68;        // 4 rows, 68 floats apart
    case 2: return (lane % 8) * 4;         // 8 consecutive float4
    case 3: return (lane % 16) * 4;        // 16 consecutive float4
    case 4: return lane * 4;               // 32 consecutive float4
    case 5: return lane;                   // 32 consecutive floats
    default: return (lane / 16) * 260;     // 2 floats, 4 rows of 65 apart
  }
}

// the pattern is a template argument, so the loop holds the loads and
// one xor each, nothing else
template <int P>
__global__ void probe(int iters, long long* cycles, int* sink) {
  __shared__ __align__(16) float sm[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sm[i] = i;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const uint32_t base = static_cast<uint32_t>(
      __cvta_generic_to_shared(sm + offset<P>(lane)));
  int acc = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint32_t addr = base + u * 256;     // same banks
      float a, b, c, d;
      if (P >= 5) {
        asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(a)
                     : "r"(addr));
        d = a;
      } else {
        asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(a), "=f"(b), "=f"(c), "=f"(d) : "r"(addr));
      }
      acc ^= __float_as_int(u & 1 ? a : d);
    }
  }
  const long long t1 = clock64();
  __syncthreads();
  if (lane == 0)
    atomicMax(reinterpret_cast<unsigned long long*>(cycles + blockIdx.x),
              static_cast<unsigned long long>(t1 - t0));
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int run(int pattern, int blocks, int threads, int iters,
                   void* cycles, void* sink) {
  long long* c = static_cast<long long*>(cycles);
  int* s = static_cast<int*>(sink);
  switch (pattern) {
    case 0: probe<0><<<blocks, threads>>>(iters, c, s); break;
    case 1: probe<1><<<blocks, threads>>>(iters, c, s); break;
    case 2: probe<2><<<blocks, threads>>>(iters, c, s); break;
    case 3: probe<3><<<blocks, threads>>>(iters, c, s); break;
    case 4: probe<4><<<blocks, threads>>>(iters, c, s); break;
    case 5: probe<5><<<blocks, threads>>>(iters, c, s); break;
    default: probe<6><<<blocks, threads>>>(iters, c, s); break;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""

PATTERNS = [
    ("LDS.128, one address", 1),
    ("LDS.128, 4 rows 68 floats apart (decode_batch row load)", 4),
    ("LDS.128, 8 consecutive float4 (decode_batch M^T load)", 8),
    ("LDS.128, 16 consecutive float4 (dct_rows M^T load)", 16),
    ("LDS.128, 32 consecutive float4", 32),
    ("LDS.32, 32 consecutive floats", 32),
    ("LDS.32, 2 floats 260 apart (dct_rows row load)", 2),
]
WARPS, ITERS = 16, 2000


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("probe_shared_loads: no CUDA card visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print("card:", smi.splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "probe.cu"), \
            os.path.join(tmp, "libprobe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        src], check=True, capture_output=True)
        lib = ctypes.CDLL(lib_path)
    fn = lib.run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    sink = torch.zeros(sms * 32 * WARPS, dtype=torch.int32, device="cuda")
    for pattern, (name, distinct) in enumerate(PATTERNS):
        for iters in (10, ITERS):            # warm-up, then measured
            cycles.zero_()
            err = fn(pattern, sms, 32 * WARPS, iters, cycles.data_ptr(),
                     sink.data_ptr())
            if err:
                print(f"probe_shared_loads: cudaError {err}",
                      file=sys.stderr)
                return 1
        per = cycles.max().item() / (8 * ITERS * WARPS)
        print(f"{name}: {distinct} distinct addresses per warp, "
              f"{per} SM cycles per warp instruction")
    return 0


if __name__ == "__main__":
    sys.exit(main())
