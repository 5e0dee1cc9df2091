// Band-engine packed gridding / degridding kernels for Hopper (sm_90a):
// the "highest" (f32) mode of K1 and K2.
//
// Replace the two Pallas TPU kernels of the packed whole-image path,
// ska_sdp_func_tpu/kernels/packed_tap.py, at Precision.HIGHEST:
//   - grid_packed_stack_pallas (_grid_stack_kernel_split,
//     _stack_accumulate)  ->  packed_grid_stack_kernel
//   - degrid_stack_pallas (_degrid_stack_kernel, _window_from_stack,
//     _degrid_math, _degrid_tail)  ->  packed_degrid_stack_kernel
// The "high" and "bf16" modes run on the tensor cores (packed_wgmma.cu).
//
// Layout (shared with the plain PyTorch versions in packed_tap.py): the
// sorted visibility stream of `total` slots is cut into plan blocks of
// `block_v` slots; block b belongs to one (task t, w-slab k0, u-octet g)
// bucket. A window has rows = 2 * w_support * 16 (<= 128): row
// (h * w_support + j) * 16 + r holds re (h = 0) or im (h = 1) of tower
// layer k0 + j at sub-grid row 8g + r. The per-task stack is
// f32 [T, 2, num_layers * (lanes + 8), lanes].
//
// Grid, per block:   contrib[m, c] = sum_p u_all[m, p] * vband[p, c],
//   u_all[m, p] = ubase[r, p] * (wk_t[j, p] * (h ? vim : vre)[p]),
//   added into the task's stack at its window rows.
// Degrid, per block: t_T[m, p] = sum_c window[m, c] * vband_t[c, p],
//   re/im[p] = sum over the re/im half of ubase[r, p] * wk_t[j, p] * t_T.
// f32 operands, products and sums.
//
// What bounds it on an H100. 2 * 128 * 128 flops per slot (~46 GFLOP per
// 1M-visibility whole-image call) against ~1 KB/slot of streamed f32
// bands; against the H100 SXM's published 67 TFLOP/s of f32 FMA (700 W
// limit) this is compute-bound on the CUDA cores. The design is the
// simple one: one CTA of 256 threads per (plan block, 128-wide output
// tile), a shared-memory-tiled f32 FMA product with an 8x8 register tile
// per thread, contraction staged 16 deep through shared memory. The
// grid's overlapping octets and slabs of one task combine with f32
// atomicAdd into the zeroed stack (so the f32 sum order varies from run
// to run); the degrid's blocks are independent and its re/im row sums
// are a shared-memory reduction. Its tensor-core form (three TF32
// products) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWinRows = 16;   // 8-aligned octet base + support (<= 8)
constexpr int kTile = 128;     // output tile: 128 window rows x 128 cols
constexpr int kChunk = 16;     // contraction depth staged per pass
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kOperand = kChunk * kTile;
// A and B chunk planes; the degrid epilogue reuses them for [2][16][kTile].
constexpr int kSmemFloats = 2 * kOperand;

// acc[i][j] += A[:, ty + 16 i] . B[:, tx + 16 j] over one staged chunk;
// A and B are [kChunk][kTile].
__device__ __forceinline__ void mac_chunk(const float* a, const float* b,
                                          int tx, int ty,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    float ar[8], br[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ar[i] = a[kk * kTile + ty + 16 * i];
      br[i] = b[kk * kTile + tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
packed_grid_stack_kernel(const int* __restrict__ t_idx,
                         const int* __restrict__ k_idx,
                         const int* __restrict__ g_idx,
                         const float* __restrict__ ubase,
                         const float* __restrict__ vband,
                         const float* __restrict__ wk_t,
                         const float* __restrict__ vre,
                         const float* __restrict__ vim, int64_t total,
                         int block_v, int w_support, int lanes,
                         int num_layers, float* __restrict__ out) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* a_s = smem;
  float* b_s = smem + kOperand;

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int half_rows = w_support * kWinRows;
  const int rows = 2 * half_rows;
  const int64_t p_begin = static_cast<int64_t>(b) * block_v;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < block_v; c0 += kChunk) {
    // A: the scale stack u_all[m, p], slot-fastest for coalescing.
    for (int e = tid; e < kOperand; e += kThreads) {
      const int kk = e % kChunk;
      const int m = e / kChunk;
      float u = 0.0f;
      if (m < rows && c0 + kk < block_v) {
        const int64_t p = p_begin + c0 + kk;
        const int h = m / half_rows;
        const int j = (m % half_rows) / kWinRows;
        const int r = m % kWinRows;
        const float v = h ? vim[p] : vre[p];
        u = ubase[r * total + p] * (wk_t[j * total + p] * v);
      }
      a_s[kk * kTile + m] = u;
    }
    // B: the v-band rows of this chunk's slots, lane-fastest.
    for (int e = tid; e < kOperand; e += kThreads) {
      const int n = e % kTile;
      const int kk = e / kTile;
      b_s[e] = c0 + kk < block_v
                   ? vband[(p_begin + c0 + kk) * lanes + col0 + n]
                   : 0.0f;
    }
    __syncthreads();
    mac_chunk(a_s, b_s, tx, ty, acc);
    __syncthreads();
  }

  // Flush into the task's stack at its (layer, u-octet) rows.
  const int64_t sub_pad = lanes + 8;
  const int64_t plane = static_cast<int64_t>(num_layers) * sub_pad * lanes;
  const int t = t_idx[b];
  const int k0 = k_idx[b];
  const int g8 = g_idx[b] * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty + 16 * i;
    if (m >= rows) continue;
    const int h = m / half_rows;
    const int j = (m % half_rows) / kWinRows;
    const int r = m % kWinRows;
    float* dst = out + (2 * static_cast<int64_t>(t) + h) * plane +
                 ((k0 + j) * sub_pad + g8 + r) * lanes + col0 + tx;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) atomicAdd(dst + 16 * jj, acc[i][jj]);
  }
}

__global__ void __launch_bounds__(kThreads)
packed_degrid_stack_kernel(const float* __restrict__ stack,
                           const int* __restrict__ t_idx,
                           const int* __restrict__ k_idx,
                           const int* __restrict__ g_idx,
                           const float* __restrict__ ubase,
                           const float* __restrict__ vband_t,
                           const float* __restrict__ wk_t, int64_t total,
                           int block_v, int w_support, int lanes,
                           int num_layers, float* __restrict__ out) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* a_s = smem;
  float* b_s = smem + kOperand;

  const int b = blockIdx.x;
  const int s0 = blockIdx.y * kTile;  // first slot of this tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int half_rows = w_support * kWinRows;
  const int rows = 2 * half_rows;
  const int64_t p_begin = static_cast<int64_t>(b) * block_v;
  const int64_t sub_pad = lanes + 8;
  const int64_t plane = static_cast<int64_t>(num_layers) * sub_pad * lanes;
  const float* task = stack + 2 * static_cast<int64_t>(t_idx[b]) * plane;
  const int k0 = k_idx[b];
  const int g8 = g_idx[b] * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < lanes; c0 += kChunk) {
    // A: the bucket's window, gathered from the task's stack.
    for (int e = tid; e < kOperand; e += kThreads) {
      const int kk = e % kChunk;
      const int m = e / kChunk;
      float x = 0.0f;
      if (m < rows) {
        const int h = m / half_rows;
        const int j = (m % half_rows) / kWinRows;
        const int r = m % kWinRows;
        x = task[h * plane + ((k0 + j) * sub_pad + g8 + r) * lanes + c0 +
                 kk];
      }
      a_s[kk * kTile + m] = x;
    }
    // B: vband_t rows c0..c0+15 at this tile's slots, slot-fastest.
    for (int e = tid; e < kOperand; e += kThreads) {
      const int n = e % kTile;
      const int kk = e / kTile;
      b_s[e] = s0 + n < block_v ? vband_t[(c0 + kk) * total + p_begin + s0 + n]
                                : 0.0f;
    }
    __syncthreads();
    mac_chunk(a_s, b_s, tx, ty, acc);
    __syncthreads();
  }

  // Scale by the u-tap x w-tap stack and reduce each half's rows.
  float* red = smem;  // [2][16][kTile]
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int n = tx + 16 * jj;
    float re = 0.0f;
    float im = 0.0f;
    if (s0 + n < block_v) {
      const int64_t p = p_begin + s0 + n;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        if (m >= rows) continue;
        const int mh = m % half_rows;
        const int j = mh / kWinRows;
        const int r = mh % kWinRows;
        const float uw = ubase[r * total + p] * wk_t[j * total + p];
        if (m < half_rows) {
          re += uw * acc[i][jj];
        } else {
          im += uw * acc[i][jj];
        }
      }
    }
    red[ty * kTile + n] = re;
    red[(16 + ty) * kTile + n] = im;
  }
  __syncthreads();
  if (tid < kTile && s0 + tid < block_v) {
    float re = 0.0f;
    float im = 0.0f;
    for (int y = 0; y < 16; ++y) {
      re += red[y * kTile + tid];
      im += red[(16 + y) * kTile + tid];
    }
    const int64_t p = p_begin + s0 + tid;
    out[p] = re;
    out[total + p] = im;
  }
}

}  // namespace

extern "C" {

const char* sdp_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 on success).
int sdp_torch_grid_packed_stack(const int* t_idx, const int* k_idx,
                                const int* g_idx, int num_blocks,
                                const float* ubase, const float* vband,
                                const float* wk_t, const float* vre,
                                const float* vim, int64_t total,
                                int block_v, int w_support, int lanes,
                                int num_layers, float* out, void* stream) {
  const dim3 grid(num_blocks, lanes / kTile);
  packed_grid_stack_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t_idx, k_idx, g_idx, ubase, vband, wk_t, vre, vim, total, block_v,
      w_support, lanes, num_layers, out);
  return static_cast<int>(cudaGetLastError());
}

int sdp_torch_degrid_stack(const float* stack, const int* t_idx,
                           const int* k_idx, const int* g_idx,
                           int num_blocks, const float* ubase,
                           const float* vband_t, const float* wk_t,
                           int64_t total, int block_v, int w_support,
                           int lanes, int num_layers, float* out,
                           void* stream) {
  const dim3 grid(num_blocks, (block_v + kTile - 1) / kTile);
  packed_degrid_stack_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      stack, t_idx, k_idx, g_idx, ubase, vband_t, wk_t, total, block_v,
      w_support, lanes, num_layers, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
