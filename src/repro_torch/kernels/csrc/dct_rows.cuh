// Shared body of two row-IDCT kernels: dequant_idct and idct8x8. Each
// computes, for every row r of an [N, 64] float32 input,
//
//     out[r, j] = epilogue( sum_k deq[r, k] * M[j, k] )
//
// where M is the [64, 64] Kronecker IDCT matrix, deq[r, :] is x[r, :]
// times a quant row (none, or one table for all rows), and the epilogue
// is either nothing or +128 and a clamp to [0, 255]. decode_batch, the
// per-row-table form, has its own Hopper design in decode_batch.cu.
//
// What bounds it on an H100: per row it reads 256 B, writes 256 B and
// does 64 x 64 FMAs = 8,192 FLOPs (+64 for the dequant). At 3.35 TB/s
// and 67 TFLOP/s (FP32, no tensor cores) the two bounds are within 25%
// of each other, so neither can be ignored.
//
// Design, right and simple first:
//  * One block of 256 threads owns 64 rows. It stages M^T (16 KB) and its
//    64 dequantized rows (16.6 KB, rows padded to 65 floats so the 4-row
//    column reads of one warp fall in distinct banks) in shared memory.
//  * Each thread computes a 4 x 4 tile of the output: per k, 4 scalar
//    shared loads, one float4 load of M^T and 16 FFMAs.
//  * Plain FP32 FFMA, no tensor cores: TF32 would round the inputs to 10
//    mantissa bits, which costs several pixel levels.
//  * Every output element is one fmaf chain over k = 0..63 in that fixed
//    order, computed by one thread, with no split-K and no atomics. A
//    row's result therefore depends only on that row's data, never on N
//    or on where the row sits. decode_batch.cu keeps the same arithmetic
//    (__fmul_rn dequant, the same chain, the same epilogue) in another
//    design, so decode_batch with table t equals dequant_idct with that
//    table bit for bit across the two designs.
//  * The ragged last block is masked: rows >= N load zeros and store
//    nothing, so callers never pad to a tile size.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRowsPerBlock = 64;
constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 tile each
constexpr int kRowStride = 65;     // padded shared row: no bank conflicts

enum class Quant { kNone, kOne };

__device__ __forceinline__ float shift_clamp(float v) {
  v = __fadd_rn(v, 128.0f);
  // comparisons, not fminf/fmaxf: NaN must survive as in torch.clamp
  return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
}

template <Quant Q, bool kShiftClamp>
__global__ void __launch_bounds__(kThreads)
dct_rows_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ m_t, float* __restrict__ out,
                long long n) {
  __shared__ float xs[kRowsPerBlock * kRowStride];
  __shared__ __align__(16) float mts[64 * 64];   // mts[k*64 + j] = M[j][k]

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;

  const float4* m4 = reinterpret_cast<const float4*>(m_t);
  float4* mts4 = reinterpret_cast<float4*>(mts);
  for (int i = tid; i < 64 * 64 / 4; i += kThreads) mts4[i] = m4[i];

  for (int i = tid; i < kRowsPerBlock * 16; i += kThreads) {
    const int r = i >> 4;
    const int c4 = i & 15;
    const long long row = row0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n) {
      v = reinterpret_cast<const float4*>(x + row * 64)[c4];
      if (Q == Quant::kOne) {
        const float4 qv = reinterpret_cast<const float4*>(q)[c4];
        v.x = __fmul_rn(v.x, qv.x);
        v.y = __fmul_rn(v.y, qv.y);
        v.z = __fmul_rn(v.z, qv.z);
        v.w = __fmul_rn(v.w, qv.w);
      }
    }
    float* dst = xs + r * kRowStride + c4 * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();

  const int tx = tid & 15;          // output columns 4*tx .. 4*tx+3
  const int ty = tid >> 4;          // block rows 4*ty .. 4*ty+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * kRowStride + k];
    const float4 b = mts4[k * 16 + tx];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty * 4 + i;
    if (row >= n) continue;
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (kShiftClamp) {
      o.x = shift_clamp(o.x);
      o.y = shift_clamp(o.y);
      o.z = shift_clamp(o.z);
      o.w = shift_clamp(o.w);
    }
    reinterpret_cast<float4*>(out + row * 64)[tx] = o;
  }
}

template <Quant Q, bool kShiftClamp>
int launch_dct_rows(const float* x, const float* q, const float* m_t,
                    float* out, long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  dct_rows_kernel<Q, kShiftClamp>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, q, m_t, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
