// Band-engine packed gridding / degridding on Hopper's tensor cores
// (sm_90a): the "high" and "bf16" modes of K1 and K2.
//
// Replace the two Pallas TPU kernels of the packed whole-image path,
// ska_sdp_func_tpu/kernels/packed_tap.py:
//   - grid_packed_stack_pallas (:249; _grid_stack_kernel_split_high,
//     _stack_accumulate)                   ->  grid_runs_kernel
//   - degrid_stack_pallas (:839; _degrid_stack_kernel_high,
//     _window_from_stack, _degrid_math_high, _degrid_tail)
//                                          ->  degrid_runs_kernel
// The "highest" (f32) mode keeps its CUDA-core body in packed_tap.cu.
// Layout as there: block b of block_v sorted slots belongs to bucket
// (t, k0, g); window row m = (h * Sw + j) * 16 + r is re (h = 0) or im
// (h = 1) of layer k0 + j at sub-grid row 8 g + r; the per-task stack is
// f32 [T, 2, K * (lanes + 8), lanes].
//
//   grid:   contrib[m, c] = sum_p u_all[m, p] * vband[p, c],
//           u_all[m, p] = ubase[r, p] * (wk_t[j, p] * (h ? vim : vre)[p]);
//   degrid: t_T[m, p] = sum_c window[m, c] * vband_t[c, p],
//           re/im[p] = sum over the re/im rows of ubase[r, p] wk_t[j, p]
//                      t_T[m, p].
//
// Precision, as the TPU kernels': "high" splits the in-kernel operand
// (u_all, or the window) into bf16 hi + lo with the bit-level rounding of
// split_bf16 and takes hi*hi + hi*lo + lo*hi against the pre-split bf16
// stream operand; "bf16" rounds it to bf16 once against the bf16 stream
// operand. Each bf16 product is exact in f32. The tensor cores' own f32
// accumulation truncates (over a bucket's 1-8K slots it drifted 1.5-1.8e-5
// of max, bucket_dot.cu), so they sum at most 64 terms of a contraction
// (one ring stage) into fresh fragments and the CUDA cores add those
// chunk sums in f32.
//
// What bounds it on an H100. Per slot the grid reads ~600 bytes (the 128
// lanes of vband hi and lo, ubase's 16 rows, wk_t, vre, vim) and does 3 x
// 2 x 128 x 128 operations: ~900 MB and ~137 GFLOP for the main path's
// 1,394,688 slots, 0.27 ms by bytes against 0.14 ms on the bf16 tensor
// cores (2.05 ms on the f32 CUDA cores, the first design's wall). The
// degrid moves the same. So the design feeds the tensor cores at the
// memory's rate:
//   - work units are (run part, 128-lane tile), where a part is a sequence
//     of consecutive plan blocks of one bucket (a table of (first block,
//     count) rows, longest first); a persistent grid of one CTA an SM
//     walks the units with a stride of the grid. The caller cuts each
//     maximal run into parts of a sixteenth of an SM's share of the blocks
//     (at least a floor of slots; packed_tap.band_runs), so that a dense
//     uv core's long runs spread over every SM instead of one CTA walking
//     a run alone; the kernels take any table whose rows hold every block
//     once;
//   - a producer warp streams each part through a ring of stages, 64 slots
//     a stage: TMA tiles of the bf16 band planes (128-byte swizzle, the
//     layout wgmma reads) and of ubase, wk_t (and vre, vim), completing on
//     mbarriers; the consumers release a stage with one arrive a warp;
//   - two consumer warpgroups each own 64 of the 128 window rows (row
//     block q = warp: the 16 rows of one (h, j)); a warpgroup with no
//     window row (w_support <= 2) issues no product;
//   - grid: the consumers build u_all hi/lo for their rows in registers,
//     in wgmma's A-fragment layout, and issue wgmma m64n128k16 (A from
//     registers, B = vband MN-major from the stage); each part's sums stay
//     in registers and are flushed once a part with float4 atomics into
//     the zeroed stack (neighbouring octets' and slabs' windows overlap,
//     so the flush stays a reduction, right for any block order);
//   - degrid: a part's window (2 Sw x 16 rows x 128 lanes f32) is read
//     once from the stack, split once into bf16 hi/lo and kept in shared
//     memory in wgmma's K-major swizzled layout for the whole part (each
//     part writes only its own slots); per stage each warpgroup issues
//     wgmma m64n64k16 (A = window rows, B = vband_t
//     MN-major, 64 slots), and the tail weights the rows by ubase x wk_t,
//     sums them by warp shuffles and one shared-memory pass across the
//     warps, and writes each slot's re/im once (atomics only when lanes
//     span several tiles).
// Any block_v works: a stage past a part's end is masked (the grid zeroes
// those slots' u_all, the degrid writes none of them). The mbarrier, TMA,
// wgmma and tensor-map wrappers are hopper.cuh's (shared with
// bucket_dot.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kWinRows = 16;                 // rows of one (h, j)
constexpr int kLanes = 128;                  // lanes of a tile
constexpr int kChunk = 64;                   // slots of one ring stage
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kGridStages = 4;
constexpr int kDegridStages = 3;
constexpr int kBandPlane = kChunk * kLanes * 2;     // 16 KB of bf16
constexpr int kHalf = kBandPlane / 2;               // 64 lanes x 64 slots
constexpr int kUbaseBytes = kWinRows * kChunk * 4;  // ubase [16, 64] f32
constexpr int kWkBytes = 4 * kChunk * 4;            // wk_t [<= 4, 64] f32
constexpr int kVisBytes = kChunk * 4;               // vre or vim [64]
constexpr int kWindowPlane = 2 * kLanes * kLanes;   // 128 rows x 128 bf16
constexpr int kRedBytes = 2 * kConsumerWarps * kChunk * 4;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kHigh = 1, kBf16 = 2 };

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory of the grid kernel: the ring, then its barriers.
template <int MODE>
struct GridSmem {
  static constexpr int kPlanes = MODE == kHigh ? 2 : 1;
  static constexpr int kUbase = kPlanes * kBandPlane;
  static constexpr int kWk = kUbase + kUbaseBytes;
  static constexpr int kVre = kWk + kWkBytes;
  static constexpr int kVim = kVre + kVisBytes;
  static constexpr int kStage = round1k(kVim + kVisBytes);
  static constexpr int kBars = kGridStages * kStage;
  static constexpr int kBytes = kBars + 1024 + 1024;  // + alignment slack
};

// Shared memory of the degrid kernel: the window planes, the cross-warp
// sums (two buffers), the ring, its barriers.
template <int MODE>
struct DegridSmem {
  static constexpr int kPlanes = MODE == kHigh ? 2 : 1;
  static constexpr int kRed = kPlanes * kWindowPlane;
  static constexpr int kRing = kRed + kRedBytes;
  static constexpr int kUbase = kPlanes * kBandPlane;
  static constexpr int kWk = kUbase + kUbaseBytes;
  static constexpr int kStage = round1k(kWk + kWkBytes);
  static constexpr int kBars = kRing + kDegridStages * kStage;
  static constexpr int kBytes = kBars + 1024 + 1024;
};

// The tensor maps of one launch (TMA descriptors, passed by value).
struct Maps {
  CUtensorMap band_hi;   // vband [V, lanes] (grid) or vband_t [lanes, V]
  CUtensorMap band_lo;   // its lo plane ("high"; the hi map again else)
  CUtensorMap ubase;     // [16, V] f32
  CUtensorMap wk;        // [Sw, V] f32
  CUtensorMap vre;       // [V] f32 (grid only)
  CUtensorMap vim;
};

struct RunArgs {
  const int2* runs;      // [R] (first block, block count), longest first
  const int* t_idx;
  const int* k_idx;
  const int* g_idx;
  const float* stack;    // degrid input
  float* out;            // grid: the zeroed stack; degrid: [2, V]
  int64_t total;
  int num_units;         // R x tiles
  int tiles;             // lanes / 128
  int block_v;
  int w_support;
  int lanes;
  int num_layers;
  int accumulate;        // degrid: add into a zeroed out (tiles > 1)
};

// -- barriers ----------------------------------------------------------------

// The 256 consumer threads' own barrier (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// -- arithmetic --------------------------------------------------------------

// Upper half of the bit-level split (split_bf16): the upper 16 bits
// rounded to nearest-even; exactly a bf16 value.
__device__ __forceinline__ float split_hi(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring elements of the in-kernel operand in the mode's form:
// hi (the bf16 rounding for MODE == kBf16) and, at "high", lo.
template <int MODE>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if (MODE == kHigh) {
    const float h0 = split_hi(x0);
    const float h1 = split_hi(x1);
    hi = (__float_as_uint(h1) & 0xFFFF0000u) | (__float_as_uint(h0) >> 16);
    lo = bf16_pair(x0 - h0, x1 - h1);
  } else {
    hi = bf16_pair(x0, x1);
    lo = 0u;
  }
}

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), v);   // one vector atomic (sm_90)
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// The run part and lane tile of work unit u.
struct Unit {
  int first;     // first slot
  int end;       // one past its last slot
  int chunks;    // ring stages
  int col0;      // first lane of the tile
  int block;     // first plan block (its bucket indices)
};

__device__ __forceinline__ Unit unit_of(const RunArgs& a, int u) {
  const int2 run = a.runs[u / a.tiles];
  Unit w;
  w.block = run.x;
  w.first = run.x * a.block_v;
  w.end = w.first + run.y * a.block_v;
  w.chunks = (run.y * a.block_v + kChunk - 1) / kChunk;
  w.col0 = (u % a.tiles) * kLanes;
  return w;
}

// -- K1 ----------------------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
grid_runs_kernel(const __grid_constant__ Maps maps, const RunArgs a) {
  using L = GridSmem<MODE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kGridStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sw = a.w_support;

  if (tid == 0) {
    for (int s = 0; s < kGridStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: one lane keeps the ring full, unit after unit.
    if (lane == 0) {
      const uint32_t tx = L::kPlanes * kBandPlane + kUbaseBytes +
                          sw * kChunk * 4 + 2 * kVisBytes;
      uint32_t it = 0;
      for (int u = blockIdx.x; u < a.num_units; u += gridDim.x) {
        const Unit w = unit_of(a, u);
        for (int c = 0; c < w.chunks; ++c, ++it) {
          const int s = it % kGridStages;
          bar_wait(&empty[s], ((it / kGridStages) & 1) ^ 1);
          uint8_t* st = smem + s * L::kStage;
          const int p = w.first + c * kChunk;
          bar_expect_tx(&full[s], tx);
          tma_2d(st, &maps.band_hi, &full[s], w.col0, p);
          tma_2d(st + kHalf, &maps.band_hi, &full[s], w.col0 + 64, p);
          if (MODE == kHigh) {
            tma_2d(st + kBandPlane, &maps.band_lo, &full[s], w.col0, p);
            tma_2d(st + kBandPlane + kHalf, &maps.band_lo, &full[s],
                   w.col0 + 64, p);
          }
          tma_2d(st + L::kUbase, &maps.ubase, &full[s], p, 0);
          tma_2d(st + L::kWk, &maps.wk, &full[s], p, 0);
          tma_1d(st + L::kVre, &maps.vre, &full[s], p);
          tma_1d(st + L::kVim, &maps.vim, &full[s], p);
        }
      }
    }
    return;
  }

  // Consumers: warp q holds window rows 16 q .. 16 q + 15, one (h, j).
  const int q = warp;
  const bool rows_on = q < 2 * sw;
  const bool wg_on = 4 * (warp / 4) < 2 * sw;   // the warpgroup has rows
  const int h = rows_on ? q / sw : 0;
  const int j = rows_on ? q % sw : 0;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int64_t sub_pad = a.lanes + 8;
  const int64_t plane = static_cast<int64_t>(a.num_layers) * sub_pad *
                        a.lanes;
  uint32_t it = 0;
  for (int u = blockIdx.x; u < a.num_units; u += gridDim.x) {
    const Unit w = unit_of(a, u);
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
    for (int c = 0; c < w.chunks; ++c, ++it) {
      const int s = it % kGridStages;
      bar_wait(&full[s], (it / kGridStages) & 1);
      const uint8_t* st = smem + s * L::kStage;
      if (wg_on) {
        const float* ub = reinterpret_cast<const float*>(st + L::kUbase);
        const float* wk =
            reinterpret_cast<const float*>(st + L::kWk) + j * kChunk;
        const float* vv =
            reinterpret_cast<const float*>(st + (h ? L::kVim : L::kVre));
        const int left = w.end - (w.first + c * kChunk);  // valid slots
        // u_all for this thread's fragment: rows gid, gid + 8; slots
        // 16 ks + 2 tig (+1) and + 8 (register e: row + 8 (e & 1), slot
        // + 8 (e >> 1)).
        uint32_t a_hi[4][4];
        uint32_t a_lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = gid + 8 * (e & 1);
            const int p = 16 * ks + 2 * tig + 8 * (e >> 1);
            float x0 = 0.0f;
            float x1 = 0.0f;
            if (rows_on) {
              x0 = p < left ? ub[r * kChunk + p] * (wk[p] * vv[p]) : 0.0f;
              x1 = p + 1 < left
                       ? ub[r * kChunk + p + 1] * (wk[p + 1] * vv[p + 1])
                       : 0.0f;
            }
            split_pair<MODE>(x0, x1, a_hi[ks][e], a_lo[ks][e]);
          }
        }
        const uint8_t* b_hi = st;
        const uint8_t* b_lo = st + kBandPlane;
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // Slots 16 ks .. 16 ks + 15: 2048 bytes into each 64-lane half.
          const uint64_t d_hi = desc_sw128(b_hi + 2048 * ks, kHalf, 1024);
          mma_rs_n128(acc, a_hi[ks], d_hi, ks > 0);
          if (MODE == kHigh) {
            const uint64_t d_lo = desc_sw128(b_lo + 2048 * ks, kHalf, 1024);
            mma_rs_n128(acc, a_hi[ks], d_lo, 1);
            mma_rs_n128(acc, a_lo[ks], d_hi, 1);
          }
        }
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    if (!rows_on) continue;
    // Flush the part: fragment i holds row gid (i % 4 < 2) or gid + 8, lanes
    // 8 (i / 4) + 2 tig (+1). Neighbouring lanes trade halves so that each
    // holds four consecutive lanes of one row: one float4 atomic each.
    const int t = a.t_idx[w.block];
    const int k0 = a.k_idx[w.block];
    const int g8 = 8 * a.g_idx[w.block];
    const bool even = (tig & 1) == 0;
    const int r = even ? gid : gid + 8;
    float* dst = a.out + (2 * static_cast<int64_t>(t) + h) * plane +
                 ((k0 + j) * sub_pad + g8 + r) * a.lanes + w.col0 +
                 2 * (tig & ~1);
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      const float s0 = even ? sum[4 * n8 + 2] : sum[4 * n8];
      const float s1 = even ? sum[4 * n8 + 3] : sum[4 * n8 + 1];
      const float r0 = __shfl_xor_sync(kFull, s0, 1);
      const float r1 = __shfl_xor_sync(kFull, s1, 1);
      const float4 v =
          even ? make_float4(sum[4 * n8], sum[4 * n8 + 1], r0, r1)
               : make_float4(r0, r1, sum[4 * n8 + 2], sum[4 * n8 + 3]);
      atomic_add4(dst + 8 * n8, v);
    }
  }
}

// -- K2 ----------------------------------------------------------------------

// One 64-lane half kh of a stage's contraction for warpgroup wg: A = its
// 64 window rows, lanes 64 kh + 16 ks.. (32 bytes a step along the
// swizzled row); B = vband_t rows 64 kh + 16 ks.. (128 bytes a row).
template <int MODE>
__device__ __forceinline__ void degrid_products(float (&acc)[32],
                                                const uint8_t* window,
                                                const uint8_t* st, int wg,
                                                int kh) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int a_off = kh * (kLanes * 128) + wg * 64 * 128 + 32 * ks;
    const int b_off = (64 * kh + 16 * ks) * 128;
    const uint64_t da_hi = desc_sw128(window + a_off, 16, 1024);
    const uint64_t db_hi = desc_sw128(st + b_off, kHalf, 1024);
    mma_ss_n64(acc, da_hi, db_hi, ks > 0);
    if (MODE == kHigh) {
      const uint64_t da_lo =
          desc_sw128(window + kWindowPlane + a_off, 16, 1024);
      const uint64_t db_lo = desc_sw128(st + kBandPlane + b_off, kHalf, 1024);
      mma_ss_n64(acc, da_hi, db_lo, 1);
      mma_ss_n64(acc, da_lo, db_hi, 1);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
degrid_runs_kernel(const __grid_constant__ Maps maps, const RunArgs a) {
  using L = DegridSmem<MODE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::kRed);  // [2][8][64]
  uint8_t* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kDegridStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sw = a.w_support;

  if (tid == 0) {
    for (int s = 0; s < kDegridStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      const uint32_t tx =
          L::kPlanes * kBandPlane + kUbaseBytes + sw * kChunk * 4;
      uint32_t it = 0;
      for (int u = blockIdx.x; u < a.num_units; u += gridDim.x) {
        const Unit w = unit_of(a, u);
        for (int c = 0; c < w.chunks; ++c, ++it) {
          const int s = it % kDegridStages;
          bar_wait(&empty[s], ((it / kDegridStages) & 1) ^ 1);
          uint8_t* st = ring + s * L::kStage;
          const int p = w.first + c * kChunk;
          bar_expect_tx(&full[s], tx);
          tma_2d(st, &maps.band_hi, &full[s], p, w.col0);
          if (MODE == kHigh) {
            tma_2d(st + kBandPlane, &maps.band_lo, &full[s], p, w.col0);
          }
          tma_2d(st + L::kUbase, &maps.ubase, &full[s], p, 0);
          tma_2d(st + L::kWk, &maps.wk, &full[s], p, 0);
        }
      }
    }
    return;
  }

  const int q = warp;
  const int wg = warp / 4;
  const bool rows_on = q < 2 * sw;
  const bool wg_on = 4 * wg < 2 * sw;
  const int j = rows_on ? q % sw : 0;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int half_rows = sw * kWinRows;
  const int rows = 2 * half_rows;
  const int64_t sub_pad = a.lanes + 8;
  const int64_t plane = static_cast<int64_t>(a.num_layers) * sub_pad *
                        a.lanes;
  uint32_t it = 0;
  for (int u = blockIdx.x; u < a.num_units; u += gridDim.x) {
    const Unit w = unit_of(a, u);
    // The part's window, once: f32 from the stack, split into bf16 planes
    // in the K-major 128-byte swizzled layout (two 64-lane atoms of 128
    // rows; 16-byte chunk k of row m stored at chunk k ^ (m % 8)). The
    // previous unit's products all completed (wgmma waits) before the
    // last barrier of its last stage, so the planes are free.
    {
      const float* task = a.stack + 2 * static_cast<int64_t>(a.t_idx[w.block])
                                        * plane;
      const int k0 = a.k_idx[w.block];
      const int g8 = 8 * a.g_idx[w.block];
      for (int e = tid; e < kLanes * kLanes / 4; e += kConsumers) {
        const int m = e / (kLanes / 4);
        const int c = 4 * (e % (kLanes / 4));
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (m < rows) {
          const int hh = m / half_rows;
          const int jj = (m % half_rows) / kWinRows;
          const int r = m % kWinRows;
          x = *reinterpret_cast<const float4*>(
              task + hh * plane + ((k0 + jj) * sub_pad + g8 + r) * a.lanes +
              w.col0 + c);
        }
        const int off = (c / 64) * (kLanes * 128) + m * 128 +
                        ((((c % 64) / 8) ^ (m % 8)) * 16) + (c % 8) * 2;
        uint2 hi;
        uint2 lo;
        split_pair<MODE>(x.x, x.y, hi.x, lo.x);
        split_pair<MODE>(x.z, x.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(smem + off) = hi;
        if (MODE == kHigh) {
          *reinterpret_cast<uint2*>(smem + kWindowPlane + off) = lo;
        }
      }
      // Generic-proxy writes, read next by wgmma (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
    }

    for (int c = 0; c < w.chunks; ++c, ++it) {
      const int s = it % kDegridStages;
      bar_wait(&full[s], (it / kDegridStages) & 1);
      const uint8_t* st = ring + s * L::kStage;
      // acc[kh]: lanes 64 kh .. 64 kh + 63 of the contraction, summed
      // apart and added on the CUDA cores.
      float acc0[32];
      float acc1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc0[i] = 0.0f;
        acc1[i] = 0.0f;
      }
      if (wg_on) {
        wg_fence();
        degrid_products<MODE>(acc0, smem, st, wg, 0);
        degrid_products<MODE>(acc1, smem, st, wg, 1);
        wg_commit();
        wg_wait_all();
        fence_regs(acc0);
        fence_regs(acc1);
      }
      // The tail: fragment i holds row gid (i % 4 < 2) or gid + 8 and slot
      // 8 (i / 4) + 2 tig (+1). Weight each row by ubase x wk_t, sum the
      // warp's 16 rows over gid by shuffles.
      const float* ub = reinterpret_cast<const float*>(st + L::kUbase);
      const float* wk =
          reinterpret_cast<const float*>(st + L::kWk) + j * kChunk;
      float part[16];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * n8 + 2 * tig + e;
          float v = 0.0f;
          if (rows_on) {
            const float w_p = wk[p];
            const float t0 = acc0[4 * n8 + e] + acc1[4 * n8 + e];
            const float t1 = acc0[4 * n8 + 2 + e] + acc1[4 * n8 + 2 + e];
            v = (ub[gid * kChunk + p] * w_p) * t0 +
                (ub[(gid + 8) * kChunk + p] * w_p) * t1;
          }
          part[2 * n8 + e] = v;
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);   // the stage is read
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        part[i] += __shfl_xor_sync(kFull, part[i], 4);
        part[i] += __shfl_xor_sync(kFull, part[i], 8);
        part[i] += __shfl_xor_sync(kFull, part[i], 16);
      }
      float* rbuf = red + (it & 1) * kConsumerWarps * kChunk;
      if (gid == 0) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          rbuf[q * kChunk + 8 * n8 + 2 * tig] = part[2 * n8];
          rbuf[q * kChunk + 8 * n8 + 2 * tig + 1] = part[2 * n8 + 1];
        }
      }
      consumers_sync();
      // Across the warps: re from row blocks q < Sw, im from Sw .. 2 Sw.
      // (The two buffers alternate: a buffer is rewritten only after the
      // next stage's barrier, which every reader has passed.)
      const int64_t p = w.first + static_cast<int64_t>(c) * kChunk + tid;
      if (tid < kChunk && p < w.end) {
        float re = 0.0f;
        float im = 0.0f;
        for (int b = 0; b < sw; ++b) {
          re += rbuf[b * kChunk + tid];
          im += rbuf[(sw + b) * kChunk + tid];
        }
        if (a.accumulate) {
          atomicAdd(a.out + p, re);
          atomicAdd(a.out + a.total + p, im);
        } else {
          a.out[p] = re;
          a.out[a.total + p] = im;
        }
      }
    }
  }
}

// -- host ----------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int smem, const Maps& maps, const RunArgs& a,
           cudaStream_t s) {
  const int ctas = grid_size(a.num_units);
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, kThreads, smem, s>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 ("high": mode 1, "bf16": 2) over the run table [num_runs, 2]. Returns
// the cudaError_t of the launch (0 on success).
int sdp_torch_grid_packed_runs(const int* runs, int num_runs,
                               const int* t_idx, const int* k_idx,
                               const int* g_idx, const float* ubase,
                               const void* vb0, const void* vb1, int mode,
                               const float* wk_t, const float* vre,
                               const float* vim, int64_t total, int block_v,
                               int w_support, int lanes, int num_layers,
                               float* out, void* stream) {
  Maps maps;
  const void* lo = mode == kHigh ? vb1 : vb0;
  if (!make_map(&maps.band_hi, vb0, true, lanes, total, 64, kChunk, true) ||
      !make_map(&maps.band_lo, lo, true, lanes, total, 64, kChunk, true) ||
      !make_map(&maps.ubase, ubase, false, total, kWinRows, kChunk, kWinRows,
                false) ||
      !make_map(&maps.wk, wk_t, false, total, w_support, kChunk, w_support,
                false) ||
      !make_map(&maps.vre, vre, false, total, 0, kChunk, 1, false) ||
      !make_map(&maps.vim, vim, false, total, 0, kChunk, 1, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RunArgs a{reinterpret_cast<const int2*>(runs), t_idx, k_idx, g_idx,
                  nullptr, out, total, num_runs * (lanes / kLanes),
                  lanes / kLanes, block_v, w_support, lanes, num_layers, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kHigh:
      return launch(grid_runs_kernel<kHigh>, GridSmem<kHigh>::kBytes, maps,
                    a, s);
    case kBf16:
      return launch(grid_runs_kernel<kBf16>, GridSmem<kBf16>::kBytes, maps,
                    a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2 over the run table; out f32 [2, total], zeroed by the caller when
// lanes > 128 (the tiles' sums are then added).
int sdp_torch_degrid_runs(const float* stack, const int* runs, int num_runs,
                          const int* t_idx, const int* k_idx,
                          const int* g_idx, const float* ubase,
                          const void* vbt0, const void* vbt1, int mode,
                          const float* wk_t, int64_t total, int block_v,
                          int w_support, int lanes, int num_layers,
                          float* out, void* stream) {
  Maps maps;
  const void* lo = mode == kHigh ? vbt1 : vbt0;
  if (!make_map(&maps.band_hi, vbt0, true, total, lanes, kChunk, kLanes,
                true) ||
      !make_map(&maps.band_lo, lo, true, total, lanes, kChunk, kLanes,
                true) ||
      !make_map(&maps.ubase, ubase, false, total, kWinRows, kChunk, kWinRows,
                false) ||
      !make_map(&maps.wk, wk_t, false, total, w_support, kChunk, w_support,
                false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  maps.vre = maps.ubase;   // unused by the degrid
  maps.vim = maps.ubase;
  const int tiles = lanes / kLanes;
  const RunArgs a{reinterpret_cast<const int2*>(runs), t_idx, k_idx, g_idx,
                  stack, out, total, num_runs * tiles, tiles, block_v,
                  w_support, lanes, num_layers, tiles > 1 ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kHigh:
      return launch(degrid_runs_kernel<kHigh>, DegridSmem<kHigh>::kBytes,
                    maps, a, s);
    case kBf16:
      return launch(degrid_runs_kernel<kBf16>, DegridSmem<kBf16>::kBytes,
                    maps, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
