// YCbCr -> RGB, written straight into the interleaved [H, W, 3] output.
//
// Replaces the TPU kernel _color_kernel
// (src/repro/kernels/ycbcr2rgb.py:19, pallas_call at :37):
//     R = Y + 1.402 (Cr - 128)
//     G = Y - 0.344136 (Cb - 128) - 0.714136 (Cr - 128)
//     B = Y + 1.772 (Cb - 128)
// with float32 constants and no clamp (rounding and clamping stay in the
// host's finalize step). The TPU kernel's [R, 128] lane layout and
// padding are the TPU's; here one thread takes one pixel and the ragged
// end is masked.
//
// Bound on an H100: 12 B read and 12 B written per pixel against 9 FLOPs:
// memory-bound by far. Neighbouring threads read neighbouring floats of
// each plane and write one contiguous 12-byte run each, so a warp's loads
// and stores are coalesced. Every operation is an explicitly rounded
// intrinsic in the reference's order, so nothing is contracted into an
// FMA and the result matches the plain float32 version exactly.
#include <cuda_runtime.h>

namespace {

__global__ void ycbcr2rgb_kernel(const float* __restrict__ y,
                                 const float* __restrict__ cb,
                                 const float* __restrict__ cr,
                                 float* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float yy = y[i];
  const float b = __fsub_rn(cb[i], 128.0f);
  const float r = __fsub_rn(cr[i], 128.0f);
  out[3 * i + 0] = __fadd_rn(yy, __fmul_rn(1.402f, r));
  out[3 * i + 1] = __fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136f, b)),
                             __fmul_rn(0.714136f, r));
  out[3 * i + 2] = __fadd_rn(yy, __fmul_rn(1.772f, b));
}

}  // namespace

extern "C" int repro_ycbcr2rgb(const void* y, const void* cb, const void* cr,
                               void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  ycbcr2rgb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(cb),
      static_cast<const float*>(cr), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
