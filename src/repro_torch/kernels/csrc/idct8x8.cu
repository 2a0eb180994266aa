// 8x8 IDCT of dequantized coefficient rows, no level shift, no clamp.
//
// Replaces the TPU kernel _idct_kernel
// (src/repro/kernels/idct8x8.py:24, pallas_call at :37):
//     out = x @ M.T
// x: [N, 64] f32 dequantized rows.
//
// Bound on an H100: 512 B and 8,192 FLOPs per row, bytes and FP32 FLOPs
// within 25% of each other. Same device code as dequant_idct without the
// quant row and the epilogue; the design is in dct_rows.cuh.
#include "dct_rows.cuh"

extern "C" int repro_idct8x8(const void* x, const void* m_t, void* out,
                             long long n, void* stream) {
  return repro_torch::launch_dct_rows<repro_torch::Quant::kNone, false>(
      static_cast<const float*>(x), nullptr,
      static_cast<const float*>(m_t), static_cast<float*>(out), n,
      static_cast<cudaStream_t>(stream));
}
