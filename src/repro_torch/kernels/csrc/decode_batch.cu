// Batched fused dequant + 8x8 IDCT + level shift + clamp, one launch for
// a whole micro-batch.
//
// Replaces the TPU kernel _decode_batch_kernel
// (src/repro/kernels/decode_batch.py:27, pallas_call at :50):
//     out = clip((x * qtab[qidx]) @ M.T + 128, 0, 255)
// x: [N, 64] f32 raw coefficient rows of every (image, component) of a
// same-structure group; qidx: [N] i32 row -> table; qtab: [T, 64] f32,
// one table per (image, component), so T is 3 x batch for colour images
// (768 tables, 196 KB, at a batch of 256 — too many to stage in shared
// memory, so the gather reads global memory, where they stay cached).
//
// Bound on an H100: ~516 B and 8,256 FLOPs per row; bytes and FP32 FLOPs
// are within 25% of each other. The design is in dct_rows.cuh.
#include "dct_rows.cuh"

extern "C" int repro_decode_batch(const void* x, const void* qidx,
                                  const void* qtab, int n_tables,
                                  const void* m_t, void* out, long long n,
                                  void* stream) {
  return repro_torch::launch_dct_rows<repro_torch::Quant::kGather, true>(
      static_cast<const float*>(x), static_cast<const int*>(qidx),
      static_cast<const float*>(qtab), n_tables,
      static_cast<const float*>(m_t), static_cast<float*>(out), n,
      static_cast<cudaStream_t>(stream));
}
