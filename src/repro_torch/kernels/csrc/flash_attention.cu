// Flash attention forward on the FP32 pipes, written for Hopper: causal
// (or full) self-attention over a whole sequence, with grouped-query
// heads. The LM's float32 prefill and the ViT's float32 training forward
// run on it.
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
// float32; mask value -1e30, scale 1/sqrt(D); key rows >= S score -inf,
// checked by index (TMA fills them with zeros, which would score 0).
// Before the PV product the unnormalised probabilities p = exp(s - m) are
// rounded to v's dtype, as the jnp loop does (models/layers.py:237); the
// running sum adds the float32 p, and the accumulator is divided by it at
// the end. For float32 inputs the rounding is the identity. Every product
// is a plain FP32 FMA: no TF32 and no tensor cores. TF32 keeps about 10
// mantissa bits, which would break the 2e-5 float32 tolerance its callers
// hold it to, and a 3xTF32 emulation would change both this contract and
// the bound, so neither is used.
//
// Which calls reach it: float32 at D in {16, 32, 48, 64, 80, 128}, and
// bf16 at D in {16, 32, 48, 80} (kernels/ops.py, flash_kernel_for). bf16
// at D = 64 or 128 runs on the tensor cores in flash_attention_wgmma.cu.
//
// What bounds it on an H100: at the LM prefill's float32 shape (B=4,
// S=2048, H=28, KV=4, D=128, causal) ~1.2e11 FLOPs against ~268 MB:
// operation-bound, 1.80 ms at the FP32 pipes' 67 TFLOP/s; the design
// below runs it at about half that rate, and its time is the FFMAs' (a
// build without the arithmetic, tools/probe_flash.py, takes about a tenth
// of it). At the ViT's training shape (B=16, S=64, H=KV=12, D=64, full)
// 0.2 GFLOP against 12.6 MB: byte-bound, 0.0038 ms at 3.35 TB/s; there
// the launch, the loads from L2 and the stores alone take about half the
// kernel's time, and 384 short items keep each SM busy for three in a
// row at most, so latency and not a pipe bounds it.
//
// Design:
//  * Work items are tiles of kM query rows of one (batch, head); the grid
//    is persistent (blocks = resident slots, read once per device), and a
//    block takes items c, c + grid, ... numbered heaviest causal tile
//    first and, within a tile, with the query heads of one KV head
//    adjacent, so that their K/V tiles come from L2. Three shapes of
//    block (launch, below): D = 128 takes 8 warps of 16 rows (kM = 128,
//    one block per SM, 255 registers a thread); other D take 4 warps of
//    16 rows (kM = 64, two blocks per SM); a sequence of at most 64 keys
//    (one K/V tile: the ViT's) takes 4 warps of 8 rows (kM = 32, four
//    blocks per SM), so that the ViT's 192 heads make 384 items and 1,536
//    warps, with half the serial FFMA chain per thread.
//  * Q, K and V come in by TMA (tma.cuh), 4-D tensor maps over (D, heads,
//    S, B) in boxes of [rows][16 columns]: rows past S are zeros, never
//    the next sequence's. A kStages ring of 64-key K and V tiles sits
//    behind `full` mbarriers (mbarrier.cuh). There is no producer warp (a
//    ninth warp would cap every thread at 168 registers: three warps on
//    one scheduler): the last warp to release a stage (a count in shared
//    memory) issues its refill, kStages tiles ahead in the block's
//    sequence and across items, so tile j + 1 lands while tile j is
//    computed and no thread waits for an empty stage. The next item's Q
//    is issued by the last warp past its last QK^T of the current one.
//  * Q has a barrier per box, and so has K where an item is one tile:
//    the ViT's QK^T starts on the first 16 columns while the rest land.
//    A ring of several tiles keeps one barrier per tile: eight waits a
//    tile cost the prefill more than the early start gains.
//  * The boxes keep TMA's swizzle with a span of one 64-byte row (32 in
//    bf16): 16-byte unit u of row r lands at u ^ x(r). The unit a lane
//    reads is known at compile time for its Q rows and the V rows, and
//    is one of four precomputed addresses for its K rows, so the swizzle
//    costs no instruction in the loops, and the K rows of one load (16
//    rows, one column) fall in distinct banks twice over.
//  * A warp owns 2 kR query rows and all 64 keys of a tile: lane (ly, lx)
//    = (lane / 16, lane % 16) holds the scores of rows 2 i + ly (i < kR)
//    and keys lx + 16 c (c < 4), and the output of the same rows for dims
//    (lx + 16 k) * kVec + e (D / 16 a lane). Row max and row sum stay
//    inside the warp (xor shuffles over lx); the sum's shuffles run once,
//    at the end.
//  * With kR = 8, QK^T per four d: 8 Q reads (2 distinct addresses a
//    warp, broadcast) and 4 K reads (16 distinct) for 128 FFMAs; PV per
//    four keys: 8 P reads (2 distinct) and D / 16 V reads for 32 D / 16
//    FFMAs. By the H100's shared-load costs (tools/probe_shared_loads.py:
//    an LDS.128 holds the pipe 2 cycles with at most 4 distinct float4
//    and 4 cycles above), QK^T needs 32 pipe cycles per 32 SM cycles of
//    FFMA issue and PV at D = 128 48 per 64 (a 4 x 8 lane tile needs 40
//    per 32): shared loads do not cap the FFMAs below their peak. kR = 4
//    needs 24 per 16 (a cap of two thirds), the price of twice the warps
//    where latency, not the pipe, is the bound.
//  * Loops run one 16-column box (QK^T) or eight keys (PV, whose swizzle
//    repeats every eight rows) per trip: fully unrolled, a tile's code
//    (~10,000 instructions at D 128) outgrows the instruction cache.
//  * P goes through a buffer of the warp's own (row pitch 64 words,
//    columns xor 16 on odd rows: stores and float4 reads conflict-free),
//    so the softmax needs __syncwarp, never a block barrier.
//  * Causal: a warp skips a K/V tile whose first key is past its last
//    row (it still waits for and releases the tile), so the diagonal
//    tile's masked half is computed only within the row strips that
//    cross it; the mask is applied by index on the tiles computed.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mbarrier.cuh"
#include "tma.cuh"

namespace {

constexpr int kBlockN = 64;     // key rows per K/V tile
constexpr int kBoxCols = 16;    // head-dim columns per TMA box
constexpr float kMasked = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  // N consecutive elements at p (shared memory) as float32
  template <int N>
  __device__ static void load(const uint8_t* p, float* out) {
    if constexpr (N == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (N == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    } else {
      out[0] = *reinterpret_cast<const float*>(p);
    }
  }
  __device__ static float round(float p) { return p; }
  template <int N>
  __device__ static void store(float* dst, const float* v) {
    if constexpr (N == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (N == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      *dst = v[0];
    }
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  template <int N>
  __device__ static void load(const uint8_t* p, float* out) {
    if constexpr (N == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      out[0] = lo(w.x); out[1] = hi(w.x); out[2] = lo(w.y); out[3] = hi(w.y);
    } else if constexpr (N == 2) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
      out[0] = lo(w); out[1] = hi(w);
    } else {
      out[0] = lo(*reinterpret_cast<const uint16_t*>(p));
    }
  }
  __device__ static float round(float p) {
    return __bfloat162float(__float2bfloat16(p));
  }
  template <int N>
  __device__ static void store(__nv_bfloat16* dst, const float* v) {
    if constexpr (N == 4) {
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst);
      o[0] = __floats2bfloat162_rn(v[0], v[1]);
      o[1] = __floats2bfloat162_rn(v[2], v[3]);
    } else if constexpr (N == 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(v[0], v[1]);
    } else {
      *dst = __float2bfloat16(v[0]);
    }
  }
};

// A box row as TMA writes it: 16 elements, kRowBytes, swizzled with a
// span of one row: the 16-byte unit u of row r lands at unit u ^ x(r).
template <typename T>
struct Swz {
  static constexpr int kRowBytes = kBoxCols * static_cast<int>(sizeof(T));
  static constexpr int kUnits = kRowBytes / 16;
  __host__ __device__ static constexpr int x(int row) {
    return ((row * kRowBytes) >> 7) & (kUnits - 1);
  }
};

template <typename T, int D, int kR, int kWarps, int kStages>
struct Cfg {
  static_assert(D % kBoxCols == 0, "D must be a multiple of 16");
  static constexpr int kRowBytes = Swz<T>::kRowBytes;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kWarpRows = 2 * kR;          // query rows per warp
  static constexpr int kM = kWarpRows * kWarps;     // query rows per item
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kKVBox = kBlockN * kRowBytes;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr int kPWarp = kWarpRows * kBlockN * 4;
  // byte offsets from the 1 KB-aligned base
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kP = kV + kStages * kKVTile;
  static constexpr int kBar = kP + kWarps * kPWarp;
  // K has a barrier per box where an item is one tile (one stage), so
  // that its QK^T starts on the first box; otherwise one per tile
  static constexpr int kKBars = kStages == 1 ? kBoxes : 1;
  // mbarriers: q_full per box, k_full per stage (and box), v_full per
  // stage; then the release counts of K and V per stage; 1 KB to align
  // the base
  static constexpr int kCount = kBar + 8 * (kBoxes + kStages * kKBars + kStages);
  static constexpr int kSmem = kCount + 8 * kStages + 1024;
  static constexpr int kThreads = 32 * kWarps;
  static_assert(kQBox % 1024 == 0 && kKVBox % 1024 == 0,
                "every box starts where the swizzle pattern does");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  // output: a lane holds dims (lx + 16 k) * kVec + e, k < kNVec, e < kVec
  static constexpr int kVec = D % 64 == 0 ? 4 : (D % 32 == 0 ? 2 : 1);
  static constexpr int kNVec = D / (16 * kVec);
  static constexpr int kDims = kNVec * kVec;   // D / 16
};

// One work item: kM query rows of one (batch, head), numbered heaviest
// causal tile first and, within a tile, (b, h) with the query heads of
// one KV head adjacent.
struct Item {
  int b, h, g, q0, n_tiles;
};

template <int kM>
__device__ __forceinline__ Item item_at(int i, int B, int S, int H, int KV,
                                        int n_qtiles, int causal) {
  Item w;
  const int per_tile = H * B;
  const int mt = n_qtiles - 1 - i / per_tile;
  const int bh = i % per_tile;
  w.b = bh / H;
  w.h = bh % H;
  w.g = w.h / (H / KV);
  w.q0 = mt * kM;
  w.n_tiles = causal ? (min(w.q0 + kM, S) - 1) / kBlockN + 1
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

// s[i][c] = q[row 2 i + ly] . k[key lx + 16 c] over all D, from the
// swizzled tiles. q_lane points at the lane's row ly of the warp's 16 in
// box 0 of Q; k_lane at row lx of box 0 of K, whose swizzle is x(lx) for
// all four of the lane's keys. One box (16 columns) per trip, so the
// loop's code stays small. With kWaitEach it waits for each box on its
// barrier (q_bar, k_bar: box 0's; k_step 0 where K has one barrier)
// before reading it; otherwise the caller
// has waited for all of them, which lets the loads run ahead.
template <typename T, int D, int kR, int kQBox, int kKVBox, bool kWaitEach>
__device__ __forceinline__ void scores(const uint8_t* q_lane,
                                       const uint8_t* k_lane, int lx,
                                       uint32_t q_bar, uint32_t q_par,
                                       uint32_t k_bar, int k_step,
                                       uint32_t k_par,
                                       float (&s)[kR][4]) {
  using Z = Swz<T>;
  constexpr int kE = static_cast<int>(sizeof(T));
  const uint8_t* k_unit[Z::kUnits];
#pragma unroll
  for (int u = 0; u < Z::kUnits; ++u)
    k_unit[u] = k_lane + ((u ^ Z::x(lx)) << 4);
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 1
  for (int box = 0; box < D / kBoxCols; ++box) {
    const uint8_t* const qb = q_lane + box * kQBox;
    const int kb = box * kKVBox;
    if constexpr (kWaitEach) {
      // each box of Q and K has its own barrier: the product starts on
      // box 0 while the others land
      mbar_wait(q_bar + 8 * box, q_par);
      mbar_wait(k_bar + k_step * box, k_par);
    }
#pragma unroll
    for (int d = 0; d < kBoxCols; d += 4) {
      const int byte = d * kE;            // in the unswizzled row
      const int u = byte >> 4;
      float qv[kR][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        Elem<T>::template load<4>(qb + 2 * i * Z::kRowBytes +
                                      ((u ^ Z::x(2 * i)) << 4) + (byte & 15),
                                  qv[i]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Elem<T>::template load<4>(
            k_unit[u] + kb + 16 * c * Z::kRowBytes + (byte & 15), kv[c]);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][c] = fmaf(qv[i][e], kv[c][e], s[i][c]);
    }
  }
}

// The tiles a block consumes, in order: its items c, c + grid, ..., and
// within each its K/V tiles. Every warp walks the sequence, kStages tiles
// ahead of the tile it computes, to know what refills a stage it frees.
struct Cursor {
  int it, t;
  Item w;
};

template <typename T, int D, int kR, int kWarps, int kStages,
          int kMinBlocks>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       T* __restrict__ out, int B, int S, int H, int KV,
                       int n_qtiles, int causal, float scale) {
  using C = Cfg<T, D, kR, kWarps, kStages>;
  constexpr int kWarpRows = C::kWarpRows;
  using Z = Swz<T>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 512 bytes: align the tiles to 1 KB
  uint8_t* const base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  const uint32_t q_full = sbase + C::kBar;          // + 8 * box
  const uint32_t k_full = q_full + 8 * C::kBoxes;   // + 8 (stage kKBars + box)
  const uint32_t v_full = k_full + 8 * kStages * C::kKBars;   // + 8 stage
  // how many warps have released each stage's K (V), over all its uses
  int* const k_count = reinterpret_cast<int*>(base + C::kCount);
  int* const v_count = k_count + kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_items = n_qtiles * H * B;
  const int grid = static_cast<int>(gridDim.x);

  const auto item = [&](int it) {
    return item_at<C::kM>(it, B, S, H, KV, n_qtiles, causal);
  };
  const auto next = [&](Cursor& c) {
    if (++c.t == c.w.n_tiles) {
      c.t = 0;
      c.it += grid;
      if (c.it < n_items) c.w = item(c.it);
    }
  };
  const auto load_q_box = [&](const Item& w, int box) {
    mbar_expect_tx(q_full + 8 * box, C::kQBox);
    tma_load(sbase + C::kQ + box * C::kQBox, &tm_q, q_full + 8 * box,
             box * kBoxCols, w.h, w.q0, w.b);
  };
  // box `box` of K of the tile at c into `stage` (with its own barrier's
  // bytes where K has one per box; else the tile's bytes go with box 0)
  const auto load_k_box = [&](const Cursor& c, int stage, int box) {
    const uint32_t bar =
        k_full + 8 * (stage * C::kKBars + (C::kKBars > 1 ? box : 0));
    if (C::kKBars > 1) {
      mbar_expect_tx(bar, C::kKVBox);
    } else if (box == 0) {
      mbar_expect_tx(bar, C::kKVTile);
    }
    tma_load(sbase + C::kK + stage * C::kKVTile + box * C::kKVBox, &tm_k,
             bar, box * kBoxCols, c.w.g, c.t * kBlockN, c.w.b);
  };
  const auto load_q = [&](const Item& w) {
#pragma unroll 1
    for (int box = 0; box < C::kBoxes; ++box) load_q_box(w, box);
  };
  const auto load_k = [&](const Cursor& c, int stage) {
#pragma unroll 1
    for (int box = 0; box < C::kBoxes; ++box) load_k_box(c, stage, box);
  };
  const auto load_v = [&](const Cursor& c, int stage) {
    const uint32_t bar = v_full + 8 * stage;
    mbar_expect_tx(bar, C::kKVTile);
#pragma unroll 1
    for (int box = 0; box < C::kBoxes; ++box)
      tma_load(sbase + C::kV + stage * C::kKVTile + box * C::kKVBox, &tm_v,
               bar, box * kBoxCols, c.w.g, c.t * kBlockN, c.w.b);
  };
  // Called by lane 0 once its warp has read a stage: the last of the
  // kWarps warps to release it issues its refill, so no thread ever waits
  // for an empty stage. The fences order every warp's reads before the
  // copy engine's writes.
  const auto release = [&](int* count, int stage) {
    __threadfence_block();
    const int before = atomicAdd(count + stage, 1);
    const bool last = before % kWarps == kWarps - 1;
    if (last) {
      __threadfence_block();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    return last;
  };

  Cursor ahead;                          // kStages tiles ahead
  ahead.it = blockIdx.x;
  ahead.t = 0;
  if (ahead.it < n_items) ahead.w = item(ahead.it);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kBoxes + kStages * C::kKBars; ++i)
      mbar_init(q_full + 8 * i, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(v_full + 8 * s, 1);
      k_count[s] = 0;
      v_count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (ahead.it < n_items) {
      if (threadIdx.x == 0) {
        // the first tile's Q and K box by box, in the order QK^T reads
        // them
        for (int box = 0; box < C::kBoxes; ++box) {
          if (s == 0) load_q_box(ahead.w, box);
          load_k_box(ahead, s, box);
        }
        load_v(ahead, s);
      }
      next(ahead);
    }
  }
  __syncthreads();

  // lane (ly, lx) of a warp of 2 kR query rows
  constexpr int kVec = C::kVec;
  const int ly = lane / 16;
  const int lx = lane % 16;
  const uint8_t* const q_lane =
      base + C::kQ + (kWarpRows * warp + ly) * Z::kRowBytes;
  // V: the lane's first vector, dims lx * kVec .. + kVec - 1; vector k
  // is kVec * k boxes further on
  const int v_byte = ((lx * kVec) % kBoxCols) * static_cast<int>(sizeof(T));
  const int v_unit = v_byte >> 4;
  const int v_lane = ((lx * kVec) / kBoxCols) * C::kKVBox + (v_byte & 15);
  // P[r][c] of the warp at word 64 r + (c ^ 16 (r & 1)); the lane's rows
  // have r & 1 = ly
  uint8_t* const p_lane = base + C::kP + warp * C::kPWarp + ly * 256;
  const int p_flip = 64 * ly;          // bytes: columns xor 16

  Ring kv;
  uint32_t q_phase = 0;
  for (int it = blockIdx.x; it < n_items; it += grid) {
    const Item w = item(it);
    const int r0 = w.q0 + kWarpRows * warp;    // the warp's first row
    const int r_last = min(r0 + kWarpRows, S) - 1;
    float acc[kR][C::kDims], m[kR], l[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;                     // this lane's keys only
#pragma unroll
      for (int dd = 0; dd < C::kDims; ++dd) acc[i][dd] = 0.0f;
    }

    const uint32_t q_par = q_phase;
    q_phase ^= 1;
    for (int t = 0; t < w.n_tiles; ++t) {
      const int k0 = t * kBlockN;
      // skip a tile no row of the warp attends to (it is still waited
      // for and released, so every stage's releases stay in step)
#ifdef REPRO_FLASH_PROBE_NO_MATH
      const bool active = false;   // tools/probe_flash.py: no arithmetic
#else
      const bool active = r0 < S && (!causal || k0 <= r_last);
#endif
      const uint8_t* const kt = base + C::kK + kv.stage * C::kKVTile;
      const uint8_t* const vt = base + C::kV + kv.stage * C::kKVTile;
      float s[kR][4];
      const uint32_t k_bar = k_full + 8 * kv.stage * C::kKBars;
      if (C::kKBars > 1 && active) {
        // an item of one tile: its QK^T starts on the first box of Q and
        // K while the others land
        scores<T, D, kR, C::kQBox, C::kKVBox, true>(
            q_lane, kt + lx * Z::kRowBytes, lx, q_full, q_par, k_bar, 8,
            kv.phase, s);
      } else {
        if (t == 0)
          for (int box = 0; box < C::kBoxes; ++box)
            mbar_wait(q_full + 8 * box, q_par);
        for (int b = 0; b < C::kKBars; ++b) mbar_wait(k_bar + 8 * b, kv.phase);
        if (active)
          scores<T, D, kR, C::kQBox, C::kKVBox, false>(
              q_lane, kt + lx * Z::kRowBytes, lx, q_full, q_par, k_bar, 0,
              kv.phase, s);
      }
      __syncwarp();
      if (lane == 0 && release(k_count, kv.stage)) {
        // every warp is past its last QK^T of this item
        if (t == w.n_tiles - 1 && it + grid < n_items) load_q(item(it + grid));
        if (ahead.it < n_items) load_k(ahead, kv.stage);
      }

      if (active) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int row = r0 + 2 * i + ly;
          float x[4];
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = k0 + lx + 16 * c;
            float v = s[i][c] * scale;
            if (col >= S) {
              v = -INFINITY;          // past the end: contributes nothing
            } else if (causal && col > row) {
              v = kMasked;
            }
            x[c] = v;
            mx = fmaxf(mx, v);
          }
#pragma unroll
          for (int o = 1; o < 16; o *= 2)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[i], mx);
          const float corr = expf(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = expf(x[c] - m_new);
            sum += p;
            // column lx + 16 c of row 2 i + ly, xor 16 on odd rows
            *reinterpret_cast<float*>(p_lane + 2 * i * 256 + 4 * lx +
                                      64 * (c ^ ly)) = Elem<T>::round(p);
          }
          l[i] = l[i] * corr + sum;
          m[i] = m_new;
#pragma unroll
          for (int dd = 0; dd < C::kDims; ++dd) acc[i][dd] *= corr;
        }
      }

      mbar_wait(v_full + 8 * kv.stage, kv.phase);
      __syncwarp();                     // the warp's P is written
      if (active) {
        const uint8_t* v_row[Z::kUnits];
#pragma unroll
        for (int x = 0; x < Z::kUnits; ++x)
          v_row[x] = vt + v_lane + ((v_unit ^ x) << 4);
        // eight keys per trip: the swizzle of key j repeats every 8
#pragma unroll 1
        for (int jc = 0; jc < kBlockN; jc += 8) {
          const uint8_t* const pc = p_lane + ((4 * jc) ^ p_flip);
          const int vc = jc * Z::kRowBytes;
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 4) {
            float p[kR][4];
#pragma unroll
            for (int i = 0; i < kR; ++i)
              Elem<float>::template load<4>(pc + 2 * i * 256 + 4 * j0, p[i]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = j0 + jj;
              float vv[C::kNVec][kVec];
#pragma unroll
              for (int k = 0; k < C::kNVec; ++k)
                Elem<T>::template load<kVec>(v_row[Z::x(j)] + vc +
                                                 kVec * k * C::kKVBox +
                                                 j * Z::kRowBytes,
                                             vv[k]);
#pragma unroll
              for (int i = 0; i < kR; ++i)
#pragma unroll
                for (int k = 0; k < C::kNVec; ++k)
#pragma unroll
                  for (int e = 0; e < kVec; ++e)
                    acc[i][k * kVec + e] =
                        fmaf(p[i][jj], vv[k][e], acc[i][k * kVec + e]);
            }
          }
        }
      }
      __syncwarp();                     // P and V are read
      if (lane == 0 && release(v_count, kv.stage) && ahead.it < n_items)
        load_v(ahead, kv.stage);
      if (ahead.it < n_items) next(ahead);
      kv.advance(kStages);
    }

#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float li = l[i];
#pragma unroll
      for (int o = 1; o < 16; o *= 2)
        li += __shfl_xor_sync(0xffffffffu, li, o);
      const int row = r0 + 2 * i + ly;
      if (row >= S) continue;
      const float inv = 1.0f / li;
      T* dst = out + ((static_cast<long long>(w.b) * S + row) * H + w.h) * D;
#pragma unroll
      for (int k = 0; k < C::kNVec; ++k) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = acc[i][k * kVec + e] * inv;
        Elem<T>::template store<kVec>(dst + (lx + 16 * k) * kVec, o);
      }
    }
  }
}

template <typename T, int D, int kR, int kWarps, int kStages>
cudaError_t launch_cfg(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int KV, bool causal,
                       cudaStream_t stream) {
  using C = Cfg<T, D, kR, kWarps, kStages>;
  // warps of 16 rows: eight per SM (255 registers each); of 8 rows:
  // sixteen (128 registers)
  constexpr int kMinBlocks = (kR == 8 ? 8 : 16) / kWarps;
  auto* fn = flash_attention_kernel<T, D, kR, kWarps, kStages, kMinBlocks>;
  // The shared-memory opt-in and the resident blocks hold for the current
  // device: read them once per device and shape of block, at the first
  // (uncaptured) launch there, so that a CUDA graph capture of later
  // launches records the launch alone. Two threads racing here both store
  // the same value, which is harmless.
  constexpr int kMaxDevices = 64;
  static std::atomic<int> slots[kMaxDevices];    // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n_slots = slots[dev].load(std::memory_order_acquire);
  if (n_slots == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        C::kThreads, C::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    n_slots = per_sm * sms;
    slots[dev].store(n_slots, std::memory_order_release);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // encoded at each call: the tensors' addresses change
  CUtensorMap tm_q, tm_k, tm_v;
  const auto map = [&](CUtensorMap* m, const void* ptr, int heads,
                       int rows) {
    return encode_map(encode, m, ptr, Elem<T>::kType,
                      static_cast<int>(sizeof(T)), B, S, heads, D, kBoxCols,
                      rows, Elem<T>::kSwizzle);
  };
  if (!map(&tm_q, q, H, C::kM) || !map(&tm_k, k, KV, kBlockN) ||
      !map(&tm_v, v, KV, kBlockN))
    return cudaErrorInvalidValue;
  const int n_qtiles = (S + C::kM - 1) / C::kM;
  const long long n_items = static_cast<long long>(n_qtiles) * H * B;
  if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_items < n_slots ? n_items : n_slots);
  fn<<<grid, C::kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), B, S, H, KV, n_qtiles,
      causal ? 1 : 0, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// The block's shape by head dim and sequence length (the header's
// "Design").
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, bool causal,
                   cudaStream_t stream) {
  if constexpr (D == 128) {
    return launch_cfg<T, D, 8, 8, 2>(q, k, v, out, B, S, H, KV, causal,
                                     stream);
  } else {
    if (S <= kBlockN)
      return launch_cfg<T, D, 4, 4, 1>(q, k, v, out, B, S, H, KV, causal,
                                       stream);
    return launch_cfg<T, D, 8, 4, 2>(q, k, v, out, B, S, H, KV, causal,
                                     stream);
  }
}

}  // namespace

// dtype: 0 = float32 (D in {16, 32, 48, 64, 80, 128}), 1 = bfloat16 (D in
// {16, 32, 48, 80}). The wrapper (kernels/ops.py) checks shapes, dtypes,
// contiguity, 16-byte alignment, the route and H % KV == 0 before it
// calls this.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int H, int KV, int D, int causal,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 16: err = launch<float, 16>(q, k, v, out, B, S, H, KV, c, st); break;
      case 32: err = launch<float, 32>(q, k, v, out, B, S, H, KV, c, st); break;
      case 48: err = launch<float, 48>(q, k, v, out, B, S, H, KV, c, st); break;
      case 64: err = launch<float, 64>(q, k, v, out, B, S, H, KV, c, st); break;
      case 80: err = launch<float, 80>(q, k, v, out, B, S, H, KV, c, st); break;
      case 128:
        err = launch<float, 128>(q, k, v, out, B, S, H, KV, c, st);
        break;
      default: break;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: err = launch<bf16, 16>(q, k, v, out, B, S, H, KV, c, st); break;
      case 32: err = launch<bf16, 32>(q, k, v, out, B, S, H, KV, c, st); break;
      case 48: err = launch<bf16, 48>(q, k, v, out, B, S, H, KV, c, st); break;
      case 80: err = launch<bf16, 80>(q, k, v, out, B, S, H, KV, c, st); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}
