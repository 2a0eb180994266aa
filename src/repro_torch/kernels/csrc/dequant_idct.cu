// Fused dequant + 8x8 IDCT + level shift + clamp with one quant table.
//
// Replaces the TPU kernel _dequant_idct_kernel
// (src/repro/kernels/dequant_idct.py:19, pallas_call at :32):
//     out = clip((x * q) @ M.T + 128, 0, 255)
// x: [N, 64] f32 raw coefficient rows; q: [64] f32.
//
// Bound on an H100: 512 B and 8,256 FLOPs per row, bytes and FP32 FLOPs
// within 25% of each other. The design is in dct_rows.cuh. decode_batch
// (decode_batch.cu) has another design but the same arithmetic, so with
// table t it equals this kernel with that table bit for bit.
#include "dct_rows.cuh"

extern "C" int repro_dequant_idct(const void* x, const void* q,
                                  const void* m_t, void* out, long long n,
                                  void* stream) {
  return repro_torch::launch_dct_rows<repro_torch::Quant::kOne, true>(
      static_cast<const float*>(x), static_cast<const float*>(q),
      static_cast<const float*>(m_t), static_cast<float*>(out), n,
      static_cast<cudaStream_t>(stream));
}
