// Batched fused dequant + 8x8 IDCT + level shift + clamp, one launch for
// a whole micro-batch, written for Hopper.
//
// Replaces the TPU kernel _decode_batch_kernel
// (src/repro/kernels/decode_batch.py:27, pallas_call at :50):
//     out = clip((x * qtab[qidx]) @ M.T + 128, 0, 255)
// x: [N, 64] f32 raw coefficient rows of every (image, component) of a
// same-structure group; qidx: [N] i32 row -> table; qtab: [T, 64] f32,
// one table per (image, component), so T is 3 x batch for colour images
// (768 tables, 196 KB, at a batch of 256: too many to stage in shared
// memory, so the gather reads global memory, where they stay cached).
//
// Arithmetic, the same as dct_rows.cuh's (dequant_idct, idct8x8), so the
// output is bit-identical to it: deq = __fmul_rn(x, qtab[qidx[r]]); one
// fmaf chain over k = 0..63 in that order from 0.0f, by one thread, with
// no split-K; __fadd_rn(+128), then a comparison clamp that lets NaN
// through. A row's result depends only on that row, never on N or on its
// position, and decode_batch with table t equals dequant_idct with
// qtab[t], although the two kernels share no code. A qidx outside [0, T)
// gives a NaN row and is never used to read. No TF32 and no separable
// IDCT: either would change the bits.
//
// What bounds it on an H100: per row it reads 256 B of x and 4 B of qidx
// and writes 256 B; 207,054 rows (the smoke batch) are 106.8 MB, 0.0319
// ms at 3.35 TB/s. The FLOP floor of the 64-term chain (8,256 FLOPs a
// row, 1.71 GFLOP) is 0.0255 ms at 67 TFLOP/s. The two are close, so the
// kernel must stream device memory and keep the FP32 pipe busy at once:
// the copies run behind the math.
//
// Design:
//  * Persistent grid: min(tiles, blocks per SM x SMs) blocks (one per SM:
//    151,808 B of dynamic shared memory), the SM count and occupancy read
//    once per device. A block stages M^T (16 KB) once and walks its
//    16-row tiles with a grid stride.
//  * A 16-stage ring of tiles (4 KB each) filled by 1-D cp.async.bulk
//    copies (L2 evict-first: x is read once) behind `full` mbarriers
//    (complete_tx::bytes; no tensor map). One thread of a seventeenth,
//    producer warp issues every copy, in tile order; the ragged last tile
//    copies rows_left x 256 B, always a multiple of 16.
//  * Sixteen consumer warps; local tile j goes to warp j % 16, which
//    consumes it alone, so no consumer waits for another. A warp
//    dequantizes its tile in one pass from the ring stage into its own
//    compute buffer, rows padded to 68 floats, and frees the stage through
//    its `empty` mbarrier. The pass does the 64 FMULs of a row once; in
//    the inner loop each of the 8 lanes that share a row would repeat
//    them, and it cannot read past a bad index. Rows of one (image,
//    component) are contiguous, so almost every tile reads one table: the
//    warp then loads its float4 of that table once, not once per row.
//    The next tile's qidx (plain loads: the tail's 4-byte slice need not
//    be a multiple of 16 B) and table row are loaded one tile ahead.
//  * Inner loop: each lane owns 4 rows (lane / 8 + 4i) x 8 columns
//    (4 (lane % 8) + {0..3} and 32 + 4 (lane % 8) + {0..3}). Per four k
//    it does 4 float4 loads of its rows and 8 float4 loads of M^T for 128
//    FFMAs. Per warp instruction, a row load reads 4 rows at one k, 68
//    floats apart: 4 distinct float4 in 4 distinct bank quads, each
//    broadcast to 8 lanes. An M^T load reads 8 consecutive float4 (128 B,
//    all 32 banks once), each broadcast to 4 lanes. No load conflicts, so
//    each is one wavefront of unique data: 12 per 128 FFMAs. But on the
//    H100 an LDS.128 holds the shared-memory pipe 2 SM cycles when a warp
//    reads at most 4 distinct float4 and 4 cycles with 8 or more
//    (tools/probe_shared_loads.py): 4 x 2 + 8 x 4 = 40 pipe cycles per
//    128 warp FFMAs, which the SM's four schedulers issue in 32 cycles,
//    so shared loads cap the FP32 pipe at 80% (dct_rows.cuh: 8 cycles per
//    16 FFMAs, a 50% cap). An 8 x 8 lane tile needs 48 pipe cycles per
//    256 FFMAs (64 SM cycles), but at ~167 registers only 8 consumer
//    warps fit, too few to hide the latencies; 16 warps of 4 x 8 (96
//    registers) ran faster.
//  * Stores from registers, streaming (the output is not read again
//    here): a warp's float4 store writes 4 rows x 128 B contiguous, two
//    stores cover the rows' 256 B; rows >= N are masked.
//  * Barrier waits spin in PTX with no watchdog (mbarrier.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mbarrier.cuh"

namespace {

constexpr int kRowsPerLane = 4;
constexpr int kTileRows = 4 * kRowsPerLane;   // one ring stage, one warp
constexpr int kConsumerWarps = 16;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + producer warp
// A stage serves the tiles of one warp only (tile j: stage j % kStages,
// warp j % kConsumerWarps), so a warp never waits on a stage a second
// fill ahead of the one it last read: the barriers' parity stays exact.
constexpr int kStages = 16;
static_assert(kStages % kConsumerWarps == 0, "one warp per stage");
constexpr int kRowFloats = 64;
constexpr int kTileBytes = kTileRows * kRowFloats * 4;   // 4 KB
constexpr int kPad = 68;                // compute-buffer row, in floats
constexpr int kMtBytes = 64 * 64 * 4;
constexpr int kRing = kMtBytes;         // byte offsets in shared memory
constexpr int kBuf = kRing + kStages * kTileBytes;
constexpr int kBar = kBuf + kConsumerWarps * kTileRows * kPad * 4;
constexpr int kSmem = kBar + 2 * kStages * 8;    // full, then empty

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, evict-first in L2; completion is counted on
// `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n"
      "}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float shift_clamp(float v) {
  v = __fadd_rn(v, 128.0f);
  // comparisons, not fminf/fmaxf: NaN must survive as in torch.clamp
  return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The table index of row `lane` of the tile at row0, -1 past the tile or N.
__device__ __forceinline__ int tile_index(const int* __restrict__ qidx,
                                          long long row0, long long n,
                                          int lane) {
  const long long row = row0 + lane;
  return lane < kTileRows && row < n ? qidx[row] : -1;
}

// True if every row of a tile whose index is not negative (lanes past the
// tile or N hold -1) reads table t0 = lane 0's, and t0 is in range; then
// q is this lane's float4 c4 of it. A negative index in the data passes
// the vote but still gives a NaN row: the dequant checks each row. Rows
// of one (image, component) are contiguous, so almost every tile has one
// table, and its dequant needs no load per row.
__device__ __forceinline__ bool one_table(const float* __restrict__ qtab,
                                          int n_tables, int t, int c4,
                                          float4& q) {
  const int t0 = __shfl_sync(0xffffffffu, t, 0);
  const bool one = __all_sync(0xffffffffu, t < 0 || t == t0) &&
                   static_cast<unsigned>(t0) <
                       static_cast<unsigned>(n_tables);
  if (one)
    q = __ldg(reinterpret_cast<const float4*>(
                  qtab + static_cast<long long>(t0) * 64) + c4);
  return one;
}

__global__ void __launch_bounds__(kThreads, 1)
decode_batch_kernel(const float* __restrict__ x, const int* __restrict__ qidx,
                    const float* __restrict__ qtab, int n_tables,
                    const float* __restrict__ m_t, float* __restrict__ out,
                    long long n, long long n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t full = smem_u32(smem + kBar);
  const uint32_t empty = full + 8 * kStages;

  const float4* m4 = reinterpret_cast<const float4*>(m_t);
  float4* mts4 = reinterpret_cast<float4*>(smem);   // [k][j] = M[j][k]
  for (int i = tid; i < 64 * 16; i += kThreads) mts4[i] = m4[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's tiles: blockIdx.x + j * gridDim.x, j = 0 .. my_tiles - 1
  const long long stride = gridDim.x;
  const int my_tiles =
      static_cast<int>((n_tiles - blockIdx.x + stride - 1) / stride);

  if (warp == kConsumerWarps) {
    if (lane != 0) return;
    for (int j = 0; j < my_tiles; ++j) {
      const int s = j % kStages;
      // a stage is refilled once its consumer has dequantized it
      if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
      const long long row0 = (blockIdx.x + j * stride) * kTileRows;
      const long long left = n - row0;
      const uint32_t bytes = static_cast<uint32_t>(
          (left < kTileRows ? left : kTileRows) * kRowFloats * 4);
      mbar_expect_tx(full + 8 * s, bytes);
      bulk_load(smem_u32(smem + kRing + s * kTileBytes), x + row0 * 64,
                bytes, full + 8 * s);
    }
    return;
  }

  float* buf = reinterpret_cast<float*>(smem + kBuf) +
               warp * kTileRows * kPad;
  const int lr = lane / 8;    // rows lr + 4i, i < kRowsPerLane
  const int lc = lane % 8;    // columns 4 lc + {0..3}, 32 + 4 lc + {0..3}
  const int c4 = lane % 16;   // the float4 column this lane dequantizes
  const float qnan = __int_as_float(0x7fffffff);
  const long long warp_stride = kConsumerWarps * stride * kTileRows;
  // The next tile's table indices and, where one table covers the whole
  // tile, this lane's float4 of that table: plain loads from device
  // memory (x comes by bulk copy), issued one tile ahead so that their
  // latency hides behind the current tile's math.
  int t_next = -1;
  if (warp < my_tiles)
    t_next = tile_index(qidx, (blockIdx.x + warp * stride) * kTileRows, n,
                        lane);
  bool one_next = false;
  float4 q_next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (warp < my_tiles)
    one_next = one_table(qtab, n_tables, t_next, c4, q_next);

  for (int j = warp; j < my_tiles; j += kConsumerWarps) {
    const int s = j % kStages;
    const long long row0 = (blockIdx.x + j * stride) * kTileRows;
    const long long left = n - row0;
    const int rows = static_cast<int>(left < kTileRows ? left : kTileRows);
    const int t = t_next;
    const bool one = one_next;
    const float4 q = q_next;
    const bool more = j + kConsumerWarps < my_tiles;
    if (more) t_next = tile_index(qidx, row0 + warp_stride, n, lane);
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    // dequantize the stage into this warp's padded buffer (lanes 0-15 one
    // row, 16-31 the next; a row with a bad index comes out NaN and reads
    // no table), then free the stage
    const float4* stage =
        reinterpret_cast<const float4*>(smem + kRing + s * kTileBytes);
    __syncwarp();           // every lane is done with the last tile's buf
#pragma unroll
    for (int i = 0; i < kTileRows / 2; ++i) {
      const int r = 2 * i + lane / 16;
      const int tr = __shfl_sync(0xffffffffu, t, r);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows) {
        if (static_cast<unsigned>(tr) >= static_cast<unsigned>(n_tables)) {
          v = make_float4(qnan, qnan, qnan, qnan);
        } else {
          const float4 qr =
              one ? q
                  : __ldg(reinterpret_cast<const float4*>(
                              qtab + static_cast<long long>(tr) * 64) +
                          c4);
          v = stage[r * 16 + c4];
          v.x = __fmul_rn(v.x, qr.x);
          v.y = __fmul_rn(v.y, qr.y);
          v.z = __fmul_rn(v.z, qr.z);
          v.w = __fmul_rn(v.w, qr.w);
        }
      }
      *reinterpret_cast<float4*>(buf + r * kPad + 4 * c4) = v;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);

    float acc[kRowsPerLane][8];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

    const float* rows_lr = buf + lr * kPad;
#pragma unroll 2
    for (int kg = 0; kg < 16; ++kg) {
      float4 a[kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
        a[i] = *reinterpret_cast<const float4*>(rows_lr + 4 * i * kPad +
                                                4 * kg);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = mts4[(4 * kg + kk) * 16 + lc];
        const float4 b1 = mts4[(4 * kg + kk) * 16 + 8 + lc];
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
          const float v = lane_of(a[i], kk);
          acc[i][0] = fmaf(v, b0.x, acc[i][0]);
          acc[i][1] = fmaf(v, b0.y, acc[i][1]);
          acc[i][2] = fmaf(v, b0.z, acc[i][2]);
          acc[i][3] = fmaf(v, b0.w, acc[i][3]);
          acc[i][4] = fmaf(v, b1.x, acc[i][4]);
          acc[i][5] = fmaf(v, b1.y, acc[i][5]);
          acc[i][6] = fmaf(v, b1.z, acc[i][6]);
          acc[i][7] = fmaf(v, b1.w, acc[i][7]);
        }
      }
    }

    // the next tile's table, if one covers it: its index has arrived
    if (more) one_next = one_table(qtab, n_tables, t_next, c4, q_next);

    float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int r = lr + 4 * i;
      if (r >= rows) continue;
      const long long base = (row0 + r) * 16;
      __stcs(o4 + base + lc,
             make_float4(shift_clamp(acc[i][0]), shift_clamp(acc[i][1]),
                         shift_clamp(acc[i][2]), shift_clamp(acc[i][3])));
      __stcs(o4 + base + 8 + lc,
             make_float4(shift_clamp(acc[i][4]), shift_clamp(acc[i][5]),
                         shift_clamp(acc[i][6]), shift_clamp(acc[i][7])));
    }
  }
}

}  // namespace

// The wrapper (kernels/ops.py) checks dtypes, shapes, contiguity, one
// device and 16-byte alignment of x and qtab before it calls this.
extern "C" int repro_decode_batch(const void* x, const void* qidx,
                                  const void* qtab, int n_tables,
                                  const void* m_t, void* out, long long n,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  // The shared-memory opt-in holds for the current device only: set it,
  // and read the grid's size, once per device, at the first (uncaptured)
  // launch there, so that a CUDA graph capture of later launches records
  // the launch alone. Two threads racing here store the same value.
  constexpr int kMaxDevices = 64;
  static std::atomic<int> grid_cap[kMaxDevices];   // 0 until read
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int cap = grid_cap[dev].load(std::memory_order_acquire);
  if (cap == 0) {
    err = cudaFuncSetAttribute(decode_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_batch_kernel, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cap = sms * per_sm;
    grid_cap[dev].store(cap, std::memory_order_release);
  }
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  decode_batch_kernel<<<grid, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(qidx),
      static_cast<const float*>(qtab), n_tables,
      static_cast<const float*>(m_t), static_cast<float*>(out), n, tiles);
  return static_cast<int>(cudaGetLastError());
}
