// Flash attention forward for the LM's prefill: causal (or full)
// self-attention over the whole prompt, with grouped-query heads.
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:30, pallas_call at :63) together
// with its wrapper's GQA repeat (src/repro/kernels/ops.py:68-89):
//     out = softmax(q k^T / sqrt(D), causal mask -1e30) v
// q: [B, S, H, D], k and v: [B, S, KV, D], out: [B, S, H, D], all
// contiguous, float32 or bfloat16 (out has q's dtype). Query head h reads
// KV head h / (H / KV) directly, the mapping of ops.py:78-80 and
// models/layers.py:202; the repeated K/V are never materialised.
//
// Numerics: scores, the running max and sum and the accumulator are
// float32; mask value -1e30, scale 1/sqrt(D). Before the PV product the
// unnormalised probabilities p = exp(s - m) are rounded to v's dtype, as
// the jnp loop does (models/layers.py:237); the running sum adds the
// float32 p, and the accumulator is divided by it at the end. For float32
// inputs the rounding is the identity. Every product is a plain FP32 FMA:
// no TF32, no tensor cores.
//
// Which calls reach it: float32 at D in {16, 32, 64, 128}, and bf16 at
// D in {16, 32} (kernels/ops.py, flash_kernel_for). bf16 at D = 64 or 128
// runs on the tensor cores in flash_attention_wgmma.cu.
//
// What bounds it on an H100: at the prefill's shape (B=4, S=2048, H=28,
// KV=4, D=128, causal) the causal work is ~1.2e11 FLOPs against ~268 MB
// of float32 q, k, v and out: operation-bound at the FP32 pipes' 67
// TFLOP/s, which it runs on so that float32 products stay exact (no
// TF32).
//
// Design, right and simple first:
//  * The TPU kernel keeps a whole (S, D) K and V slab in VMEM. At S=2048
//    that is 1 MB in bf16, far over the 227 KB of shared memory a block
//    may use. So one block of 128 threads owns a 64-row query tile of one
//    (batch, head) and loops over 64-row KV tiles with an online softmax
//    (running max, running sum, rescaled float32 accumulator).
//  * With causal=True the loop stops at the last KV tile that touches the
//    diagonal: tiles wholly above it are never loaded.
//  * No padding to a tile size: query rows >= S load zeros and store
//    nothing; key rows >= S load zeros and score -inf, so they add exactly
//    nothing (S = 1, 7 or 100 all work).
//  * Q, K and V tiles are staged in shared memory as float32 (~117 KB of
//    dynamic shared memory). Q and K rows are padded to D + 4 floats so
//    that the float4 reads of one quarter-warp fall in distinct banks.
//  * Thread (ty, tx) = (tid / 8, tid % 8) computes scores for rows
//    4 ty .. 4 ty + 3 and columns tx + 8 j; the eight threads of a row
//    group are neighbouring lanes, so row max and row sum are three xor
//    shuffles. The same thread accumulates the output of those rows for
//    dimensions 4 tx + 32 j .. + 3 (float4 reads of V, no conflicts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;           // 16 row groups x 8 lanes
constexpr int kPStride = kBlockK + 4;   // padded row of the P tile
constexpr float kMasked = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;        // elements per 16-byte load
  __device__ static void load16(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static float round(float p) { return p; }
  __device__ static void store4(float* dst, float a, float b, float c,
                                float d) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load16(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float p) {
    return __bfloat162float(__float2bfloat16(p));
  }
  __device__ static void store4(__nv_bfloat16* dst, float a, float b,
                                float c, float d) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst);
    o[0] = __floats2bfloat162_rn(a, b);
    o[1] = __floats2bfloat162_rn(c, d);
  }
};

// rows [row0, row0 + kRows) of one head, zero past `rows`, as float32 into
// dst with row stride `stride`; src_head points at row 0 of the head and
// consecutive rows are `row_step` elements apart.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src_head,
                                          long long row_step, int row0,
                                          int rows) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < rows) {
      Elem<T>::load16(src_head + (row0 + r) * row_step + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      *reinterpret_cast<float4*>(dst + r * stride + c + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, bool causal, float scale) {
  constexpr int kQKStride = D + 4;
  constexpr int kNJ = (D + 31) / 32;    // float4 column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // [kBlockQ][D + 4]
  float* ks = qs + kBlockQ * kQKStride;             // [kBlockK][D + 4]
  float* vs = ks + kBlockK * kQKStride;             // [kBlockK][D]
  float* ps = vs + kBlockK * D;                     // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);

  const long long q_step = static_cast<long long>(H) * D;
  const long long kv_step = static_cast<long long>(KV) * D;
  const T* q_head = q + (static_cast<long long>(b) * S * H + h) * D;
  const T* k_head = k + (static_cast<long long>(b) * S * KV + g) * D;
  const T* v_head = v + (static_cast<long long>(b) * S * KV + g) * D;
  T* o_head = out + (static_cast<long long>(b) * S * H + h) * D;

  load_tile<T, D, kBlockQ>(qs, kQKStride, q_head, q_step, q0, S);

  float m[4], l[4], acc[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  const int last_row = min(q0 + kBlockQ, S) - 1;
  const int n_tiles = causal ? last_row / kBlockK + 1
                             : (S + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                  // the previous tile's P and V are read
    load_tile<T, D, kBlockK>(ks, kQKStride, k_head, kv_step, k0, S);
    load_tile<T, D, kBlockK>(vs, D, v_head, kv_step, k0, S);
    __syncthreads();

    // scores of rows 4 ty + i, columns tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (4 * ty + i) * kQKStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 8 * j) * kQKStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (col >= S) {
          x = -INFINITY;              // past the end: contributes nothing
        } else if (causal && col > row) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(4 * ty + i) * kPStride + tx + 8 * j] = Elem<T>::round(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    __syncthreads();

    // acc[rows 4 ty + i][dims 4 tx + 32 j ..] += P V
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (4 * ty + i) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int dim = 4 * tx + 32 * j;
          if (dim >= D) continue;
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (c + cc) * D + dim);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x
                          : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][j][0] = fmaf(p, vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(p, vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(p, vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(p, vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int dim = 4 * tx + 32 * j;
      if (dim >= D) continue;
      Elem<T>::store4(o_head + row * q_step + dim, acc[i][j][0] * inv,
                      acc[i][j][1] * inv, acc[i][j][2] * inv,
                      acc[i][j][3] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, bool causal,
                   cudaStream_t stream) {
  constexpr int kQKStride = D + 4;
  constexpr size_t kSmem =
      sizeof(float) * ((kBlockQ + kBlockK) * kQKStride + kBlockK * D +
                       kBlockQ * kPStride);
  auto* fn = flash_attention_kernel<T, D>;
  // The shared-memory opt-in holds for the current device only: set it once
  // per device and instantiation, at the first (uncaptured) launch there,
  // so that a CUDA graph capture of later launches records the launch alone.
  // Two threads racing here both set the same value, which is harmless.
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  fn<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KV, int D, bool causal,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, KV, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (D in {16, 32, 64, 128}), 1 = bfloat16 (D in {16,
// 32}). The wrapper (kernels/ops.py) checks shapes, dtypes, contiguity,
// 16-byte alignment, the route and H % KV == 0 before it calls this.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int D, int causal,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(q, k, v, out, B, S, H, KV, D, causal != 0, st);
  } else if (dtype == 1 && D == 16) {
    err = launch<__nv_bfloat16, 16>(q, k, v, out, B, S, H, KV, causal != 0,
                                    st);
  } else if (dtype == 1 && D == 32) {
    err = launch<__nv_bfloat16, 32>(q, k, v, out, B, S, H, KV, causal != 0,
                                    st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
