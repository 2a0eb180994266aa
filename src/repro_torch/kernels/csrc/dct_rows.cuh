// Shared body of the three row-IDCT kernels: decode_batch, dequant_idct
// and idct8x8. Each computes, for every row r of an [N, 64] float32
// input,
//
//     out[r, j] = epilogue( sum_k deq[r, k] * M[j, k] )
//
// where M is the [64, 64] Kronecker IDCT matrix, deq[r, :] is x[r, :]
// times a quant row (none, one table for all rows, or the table that
// qidx[r] picks), and the epilogue is either nothing or +128 and a clamp
// to [0, 255].
//
// What bounds it on an H100: per row it reads 256 B (+4 B index), writes
// 256 B and does 64 x 64 FMAs = 8,192 FLOPs (+64 for the dequant). At
// 3.35 TB/s and 67 TFLOP/s (FP32, no tensor cores) the two bounds are
// within 25% of each other, so neither can be ignored.
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
//    or on where the row sits: batched output equals serial output bit
//    for bit, and decode_batch with one table equals dequant_idct.
//  * The quant table is gathered directly, qtab[qidx[r]], from global
//    memory (L1/L2 resident; T can be hundreds of tables, so it is not
//    staged in shared memory). The TPU kernel's one-hot GEMM existed only
//    because Mosaic wanted it.
//  * The ragged last block is masked: rows >= N load zeros and store
//    nothing, so callers never pad to a tile size.
//  * An out-of-range qidx cannot read out of bounds: its row comes out
//    NaN (the clamp below propagates NaN, as torch.clamp does).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kRowsPerBlock = 64;
constexpr int kThreads = 256;      // 16 x 16 threads, a 4 x 4 tile each
constexpr int kRowStride = 65;     // padded shared row: no bank conflicts

enum class Quant { kNone, kOne, kGather };

__device__ __forceinline__ float shift_clamp(float v) {
  v = __fadd_rn(v, 128.0f);
  // comparisons, not fminf/fmaxf: NaN must survive as in torch.clamp
  return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
}

template <Quant Q, bool kShiftClamp>
__global__ void __launch_bounds__(kThreads)
dct_rows_kernel(const float* __restrict__ x, const int* __restrict__ qidx,
                const float* __restrict__ qtab, int n_tables,
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
      if (Q != Quant::kNone) {
        int t = 0;
        if (Q == Quant::kGather) t = qidx[row];
        if (t < 0 || t >= n_tables) {
          const float nan = __int_as_float(0x7fffffff);
          v = make_float4(nan, nan, nan, nan);
        } else {
          const float4 q = reinterpret_cast<const float4*>(
              qtab + static_cast<long long>(t) * 64)[c4];
          v.x = __fmul_rn(v.x, q.x);
          v.y = __fmul_rn(v.y, q.y);
          v.z = __fmul_rn(v.z, q.z);
          v.w = __fmul_rn(v.w, q.w);
        }
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
int launch_dct_rows(const float* x, const int* qidx, const float* qtab,
                    int n_tables, const float* m_t, float* out, long long n,
                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  dct_rows_kernel<Q, kShiftClamp>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, qidx, qtab, n_tables, m_t, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
