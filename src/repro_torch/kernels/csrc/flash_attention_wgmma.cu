// Flash attention forward for the LM's bf16 prefill, written for Hopper:
// both products on bf16 `wgmma` with float32 accumulators, K and V
// tiles brought in by TMA behind `mbarrier`s.
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:30, pallas_call at :63) together
// with its wrapper's GQA repeat (src/repro/kernels/ops.py:68-89):
//     out = softmax(q k^T / sqrt(D), causal mask -1e30) v
// q: [B, S, H, D], k and v: [B, S, KV, D], out: [B, S, H, D], all
// contiguous bfloat16, D in {64, 128}. Query head h reads KV head
// h / (H / KV) directly; the repeated K/V are never materialised. The
// wrapper (kernels/ops.py, flash_kernel_for) sends bf16 at these head
// dims here; float32, and bf16 at D = 16, 32, 48 or 80 (a 64-column
// swizzle row needs D a multiple of 64), stay on the FFMA kernel in
// flash_attention.cu.
//
// Numerics: products of bf16 values are exact in float32, so the two
// wgmma products with float32 accumulation differ from the plain loop
// only in the order of the sums. Scores are scaled by log2(e)/sqrt(D) and
// exponentiated with exp2f. Key columns >= S score -inf; causal columns
// above the diagonal score -1e30, checked by index (TMA fills the rows
// past S with zeros, which would score 0). The unnormalised p = exp(s - m)
// is rounded to bf16 for the PV product, as the jnp loop on the
// reference's serving path does (src/repro/models/layers.py:237); the
// running sum adds the float32 p, and the output is divided by it once,
// at the end. The Pallas kernel instead normalises p before it rounds
// (flash_attention.py:45); the two agree within the bf16 tolerance.
//
// What bounds it on an H100: at the prefill's shape (B=4, S=2048, H=28,
// KV=4, D=128, causal) the work is ~1.2e11 FLOPs against ~134 MB of q, k,
// v and out, so it is operation-bound (0.12 ms at 989 TFLOP/s bf16) by
// ~40x over its bytes. The FFMA kernel ran on the FP32 pipes at 23.8
// TFLOP/s; this one runs both products on the tensor cores, and its
// design is about keeping them fed while the softmax runs beside them.
//
// Design (FlashAttention-3's structure for Hopper):
//  * A work item is a 128-row query tile of one (batch, head). The grid
//    is persistent: one block per SM takes items in turn, heaviest causal
//    tile first and, within a tile, with the heads of one KV head
//    adjacent so that their K/V tiles are read from L2. The next item's Q
//    and first K/V tiles load while the current one ends, so a block pays
//    its start-up once.
//  * A block is three warpgroups: two consumers of 64 rows each, and a
//    producer, one thread of which issues every TMA load. `setmaxnreg`
//    gives the producer warpgroup 40 registers a thread and the consumers
//    232, which holds the S and O accumulators and P without spills.
//  * Tiles stay bf16 in shared memory in TMA's 128-byte swizzle: a row
//    tile is D / 64 boxes of [128 rows][64 columns]. Two Q buffers (the
//    current item's and the next one's, 32 KB each at D=128) and a
//    2-stage K/V ring (2 x 64 KB) make ~193 KB of dynamic shared memory.
//    `full` barriers say a buffer has landed (TMA's transaction count);
//    `empty` barriers say it may be refilled: one arrival per consumer
//    warp for K and V apart, one per consumer once the output stored
//    through a Q buffer has been read out.
//  * S = Q K^T is m64n128k16 wgmma over D/16 steps, A = Q and B = K both
//    K-major from shared memory. O += P V is m64nDk16 over 8 steps, A = P
//    in registers: the S accumulator converted to packed bf16 already has
//    the A-fragment layout, so no shuffle is needed; B = V from shared
//    memory is MN-major (V is [kv, d]), read through the descriptor's
//    transpose bit.
//  * Each consumer issues S_j = Q K_j^T together with O += P_{j-1}
//    V_{j-1}, and the two consumers take turns to issue (ping-pong named
//    barriers), so one's softmax runs while the other's products do.
//  * Barrier waits spin in PTX with no watchdog (mbarrier.cuh): a branch
//    to __trap() in the consumers' code makes ptxas keep them at the
//    launch's 168 registers instead of 240, and serialize their wgmma
//    (C7512).
//  * The online softmax works on the accumulator fragments: each row
//    lives in the 4 lanes that share lane / 4, so the row max is two xor
//    shuffles; each thread keeps a partial row sum, reduced the same way
//    once, at the end. exp2 is one MUFU instruction (flush to zero).
//  * TMA loads use 4-D tensor maps over (D, heads, S, B), so the ragged
//    end of one sequence is zero-filled instead of read from the next
//    batch element, and the O store (through shared memory, by TMA) is
//    clipped at S.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mbarrier.cuh"
#include "tma.cuh"

namespace {

constexpr int kBlockM = 128;       // query rows per block
constexpr int kBlockN = 128;       // key rows per K/V tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kQBuffers = 2;       // Q tiles: the current item's and the next
constexpr int kThreads = 384;      // two consumer warpgroups + a producer
constexpr int kConsumerWarps = 8;
// setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536 registers per SM
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kStoreBarrier = 1;   // named barriers 1, 2: the O store
constexpr int kTurnBarrier = 3;    // 3, 4: the ping-pong turns
constexpr int kSwizzleCols = 64;   // bf16 columns in one 128-byte row
constexpr int kChunkBytes = kBlockN * 128;   // one [128 rows][64 cols] box
constexpr float kMasked = -1e30f;

template <int D>
struct Layout {
  static_assert(D % kSwizzleCols == 0, "D must be a multiple of 64");
  static_assert(kBlockM == kBlockN, "Q and K/V tiles share one box shape");
  static constexpr int kChunks = D / kSwizzleCols;
  static constexpr int kTileBytes = kChunks * kChunkBytes;   // Q, K or V
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBuffers * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // barriers: q_full and q_empty per Q buffer, then k_full, v_full,
  // k_empty and v_empty per stage; 1 KB to align the base
  static constexpr int kSmem =
      kBar + 8 * (2 * kQBuffers + 4 * kStages) + 1024;
};

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor for a tile in TMA's 128-byte swizzle
// (layout type 1). Offsets in bytes; the tile bases are 1024-aligned, so
// the base-offset field stays 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of wgmma outputs above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S[64 x 128] (+)= Q[64 x 16] K[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x D] += P[64 x 16] V[16 x D]: P in registers, V MN-major in shared
// memory (transpose bit set for B).
template <int D>
struct WgmmaPV;

template <>
struct WgmmaPV<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
          F8(d, 48), F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaPV<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef F8

// 2^x in one MUFU instruction; a result below 2^-126 flushes to 0 (exp2f
// without flush-to-zero adds a compare and two multiplies per element)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One consumer warp's release of a K or V stage: its wgmma reads are done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// S = Q K^T for this warpgroup's 64 rows against one 128-row K tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
    wgmma_qk(s, smem_desc(q_rows + off, 16, 1024),
             smem_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V over one 128-row V tile; P's k-step t is pa[4 t .. 4 t + 3].
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int t = 0; t < kBlockN / 16; ++t)
    WgmmaPV<D>::run(o, &pa[4 * t],
                    smem_desc(v_tile + t * 16 * 128, kChunkBytes, 1024));
  wgmma_commit();
}

// The online softmax over one S tile, in place: s becomes p = exp(s - m)
// (scaled scores, log2 units), m_* the new row max of the raw scores and
// l_* this thread's partial row sums; returns the factors by which the
// output accumulated so far must be rescaled. s[4 c + e] is row
// (e & 2 ? hi : lo), column 8 c + col_pair + (e & 1) of the tile.
struct RowState {
  float m_lo, m_hi, l_lo, l_hi;
};

__device__ __forceinline__ float2 softmax_tile(float (&s)[64], RowState& st,
                                               bool mask, int k0, int S,
                                               bool causal, int row_lo,
                                               int col_pair,
                                               float scale_log2) {
  if (mask) {     // the diagonal tile, or the ragged end: mask by index
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + 8 * (i / 4) + col_pair + (i & 1);
      const int row = (i & 2) ? row_hi : row_lo;
      if (col >= S) {
        s[i] = -INFINITY;
      } else if (causal && col > row) {
        s[i] = kMasked;
      }
    }
  }
  float mx_lo = st.m_lo, mx_hi = st.m_hi;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i & 2) {
      mx_hi = fmaxf(mx_hi, s[i]);
    } else {
      mx_lo = fmaxf(mx_lo, s[i]);
    }
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  // 0 on the first tile, where the old max is -inf
  const float2 corr = make_float2(exp2_ftz((st.m_lo - mx_lo) * scale_log2),
                                  exp2_ftz((st.m_hi - mx_hi) * scale_log2));
  st.m_lo = mx_lo;
  st.m_hi = mx_hi;
  const float off_lo = -mx_lo * scale_log2, off_hi = -mx_hi * scale_log2;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p =
        exp2_ftz(fmaf(s[i], scale_log2, (i & 2) ? off_hi : off_lo));
    s[i] = p;
    if (i & 2) {
      sum_hi += p;
    } else {
      sum_lo += p;
    }
  }
  st.l_lo = st.l_lo * corr.x + sum_lo;
  st.l_hi = st.l_hi * corr.y + sum_hi;
  return corr;
}

// P as the A fragments of the 8 k-steps of PV: step t covers columns
// 16 t .. 16 t + 15 of the tile, which are s[8 t .. 8 t + 7]
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// One work item: a 128-row query tile of one (batch, head), numbered
// heaviest causal tile first and, within a tile, (b, h) with the heads of
// one KV head adjacent, so that their K/V tiles are read from L2.
struct Item {
  int b, h, g, q0, n_tiles;
};

__device__ __forceinline__ Item item_at(int i, int B, int S, int H, int KV,
                                        int n_qtiles, int causal) {
  Item w;
  const int per_tile = H * B;
  const int mt = n_qtiles - 1 - i / per_tile;
  const int bh = i % per_tile;
  w.b = bh / H;
  w.h = bh % H;
  w.g = w.h / (H / KV);
  w.q0 = mt * kBlockM;
  w.n_tiles = causal ? (min(w.q0 + kBlockM, S) - 1) / kBlockN + 1
                     : (S + kBlockN - 1) / kBlockN;
  return w;
}

// A ring position: which stage, and the parity of its current use.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int n) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_o,
                             int B, int S, int H, int KV, int n_qtiles,
                             int causal, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles so
  // that the descriptors' base-offset field is 0
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;         // + buffer * kTileBytes
  const uint32_t sk = base + L::kK;         // + stage * kTileBytes
  const uint32_t sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;   // + 8 * buffer
  const uint32_t q_empty = q_full + 8 * kQBuffers;
  const uint32_t k_full = q_empty + 8 * kQBuffers;   // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;     // 0, 1: consumers of 64 rows; 2: loads
  // a persistent grid: block c takes items c, c + gridDim.x, ...
  const int n_items = n_qtiles * H * B;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kQBuffers; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);      // one arrival per consumer
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps Q and the K/V ring loaded, one item
    // ahead where the buffers allow
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 256) {
      auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar,
                      int head, int row, int b) {
        mbar_expect_tx(bar, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(dst + c * kChunkBytes, map, bar, c * kSwizzleCols, head,
                   row, b);
      };
      // the first wait on each empty barrier (parity 1) passes at once
      Ring qr, kv;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item w = item_at(i, B, S, H, KV, n_qtiles, causal);
        // the buffer's previous item has stored its output from it
        mbar_wait(q_empty + 8 * qr.stage, qr.phase ^ 1);
        load(&tm_q, sq + qr.stage * L::kTileBytes, q_full + 8 * qr.stage,
             w.h, w.q0, w.b);
        qr.advance(kQBuffers);
        for (int j = 0; j < w.n_tiles; ++j) {
          // a stage is refilled once all consumer warps released it
          mbar_wait(k_empty + 8 * kv.stage, kv.phase ^ 1);
          load(&tm_k, sk + kv.stage * L::kTileBytes, k_full + 8 * kv.stage,
               w.g, j * kBlockN, w.b);
          mbar_wait(v_empty + 8 * kv.stage, kv.phase ^ 1);
          load(&tm_v, sv + kv.stage * L::kTileBytes, v_full + 8 * kv.stage,
               w.g, j * kBlockN, w.b);
          kv.advance(kStages);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int col_pair = 2 * (lane % 4);
    // Ping-pong: the two warpgroups take turns to issue their wgmma, so
    // that one's softmax runs while the other's products do. A turn is
    // bar.sync on the own barrier, then bar.arrive on the other's;
    // warpgroup 1 opens warpgroup 0's first turn and skips its own last
    // arrival of the block, so every arrival is matched.
    const int my_turn = kTurnBarrier + wg;
    const int other_turn = kTurnBarrier + 1 - wg;
    if (wg == 1) bar_arrive(other_turn, 2 * 128);

    Ring qr, kv;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item w = item_at(i, B, S, H, KV, n_qtiles, causal);
      const bool last_item = i + static_cast<int>(gridDim.x) >= n_items;
      // this thread's rows (r and r + 8 of its warp's 16)
      const int row_lo = w.q0 + 64 * wg + 16 * warp + lane / 4;
      // this warpgroup's rows of the item's Q buffer
      const uint32_t q_rows = sq + qr.stage * L::kTileBytes + wg * 64 * 128;

      float s[64];
      uint32_t pa[32];
      float o[D / 2];
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] = 0.0f;
      RowState st = {-INFINITY, -INFINITY, 0.0f, 0.0f};

      mbar_wait(q_full + 8 * qr.stage, qr.phase);
      mbar_wait(k_full + 8 * kv.stage, kv.phase);
      __syncwarp();
      bar_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_qk<D>(s, q_rows, sk + kv.stage * L::kTileBytes);
      bar_arrive(other_turn, 2 * 128);
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty + 8 * kv.stage, lane);
      softmax_tile(s, st, w.n_tiles == 1, 0, S, causal, row_lo, col_pair,
                   scale_log2);
      pack_p(s, pa);

      // Tile j: S_j = Q K_j^T is issued with O += P_{j-1} V_{j-1}.
      // (ptxas places the wait for PV at the start of the softmax of
      // S_j, so the softmax overlaps the other warpgroup's products, not
      // its own PV.)
      for (int j = 1; j < w.n_tiles; ++j) {
        Ring prev = kv;
        kv.advance(kStages);
        mbar_wait(k_full + 8 * kv.stage, kv.phase);
        mbar_wait(v_full + 8 * prev.stage, prev.phase);
        __syncwarp();
        bar_sync(my_turn, 2 * 128);
        wgmma_fence();
        issue_qk<D>(s, q_rows, sk + kv.stage * L::kTileBytes);
        issue_pv<D>(o, pa, sv + prev.stage * L::kTileBytes);
        bar_arrive(other_turn, 2 * 128);
        wgmma_wait<1>();
        fence_regs(s);
        release(k_empty + 8 * kv.stage, lane);
        const float2 corr =
            softmax_tile(s, st, j == w.n_tiles - 1, j * kBlockN, S, causal,
                         row_lo, col_pair, scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(v_empty + 8 * prev.stage, lane);
#pragma unroll
        for (int k = 0; k < D / 2; ++k) o[k] *= (k & 2) ? corr.y : corr.x;
        pack_p(s, pa);
      }

      mbar_wait(v_full + 8 * kv.stage, kv.phase);
      __syncwarp();
      bar_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_pv<D>(o, pa, sv + kv.stage * L::kTileBytes);
      if (wg == 0 || !last_item) bar_arrive(other_turn, 2 * 128);
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty + 8 * kv.stage, lane);
      kv.advance(kStages);

      // normalise, and store this warpgroup's 64 rows through its own Q
      // rows (its last QK^T has completed) in the 128-byte swizzle, then
      // by TMA; the Q buffer is free once the store has read it
      float l_lo = st.l_lo, l_hi = st.l_hi;
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      const float inv_lo = 1.0f / l_lo;
      const float inv_hi = 1.0f / l_hi;
      uint8_t* const o_rows = smem_raw + (q_rows - raw);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + lane / 4 + 8 * half;   // row in the 64
          const float inv = half ? inv_hi : inv_lo;
          const int off = (c / 8) * kChunkBytes + r * 128 +
                          (((c % 8) ^ (r % 8)) * 16) + col_pair * 2;
          *reinterpret_cast<uint32_t*>(o_rows + off) = pack_bf16(
              o[4 * c + 2 * half] * inv, o[4 * c + 2 * half + 1] * inv);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(kStoreBarrier + wg, 128);
      if (tid % 128 == 0) {
        if (w.q0 + 64 * wg < S) {
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c)
            tma_store(&tm_o, q_rows + c * kChunkBytes, c * kSwizzleCols,
                      w.h, w.q0 + 64 * wg, w.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(q_empty + 8 * qr.stage);
      }
      qr.advance(kQBuffers);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, bool causal,
                   cudaStream_t stream) {
  constexpr int kSmem = Layout<D>::kSmem;
  auto* fn = flash_attention_wgmma_kernel<D>;
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
                               kSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // encoded at each call: the tensors' addresses change
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  // bf16 boxes of [rows][64 columns] of one head, 128-byte swizzle
  const auto map = [&](CUtensorMap* m, const void* ptr, int heads,
                       int rows) {
    return encode_map(encode, m, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      B, S, heads, D, kSwizzleCols, rows,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  };
  if (!map(&tm_q, q, H, kBlockM) || !map(&tm_k, k, KV, kBlockN) ||
      !map(&tm_v, v, KV, kBlockN) || !map(&tm_o, out, H, kBlockM / 2))
    return cudaErrorInvalidValue;
  const int n_qtiles = (S + kBlockM - 1) / kBlockM;
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_items = static_cast<long long>(n_qtiles) * H * B;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  fn<<<grid, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, B, S, H, KV, n_qtiles, causal ? 1 : 0,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. The wrapper (kernels/ops.py) checks shapes, dtypes,
// contiguity, 16-byte alignment, D in {64, 128} and H % KV == 0 before it
// calls this.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int S, int H, int KV, int D,
                                           int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch<64>(q, k, v, out, B, S, H, KV, causal != 0, st);
      break;
    case 128:
      err = launch<128>(q, k, v, out, B, S, H, KV, causal != 0, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
