// Bucket-window band gridding and plane-stack degridding for Hopper
// (sm_90a), from compact per-slot taps.
//
// Replace two Pallas TPU kernels of ska_sdp_func_tpu/kernels/packed_tap.py
// (the ES-FFT gridder's packed path, grid_data/es_fft_packed.py):
//   - grid_packed_pallas (_grid_kernel, _grid_kernel_split,
//     _grid_accumulate)                      -> band_grid_kernel
//   - degrid_fused_pallas (_degrid_fused_kernel, _degrid_math,
//     _degrid_tail)                          -> band_degrid_kernel
//
// Layout (shared with the plain PyTorch versions in band_tap.py): the
// bucket-sorted stream of `total` slots is cut into plan blocks of
// `block_v` slots; block b belongs to one bucket. Slot p carries u_off[p]
// (u row of its first tap in the 16-row window), iv0[p] (lane of its
// first tap in the window), uk[p][S], vk[p][S]; the Pallas kernels stream
// these placed into dense bands (ubase [16, V], vband [V, lanes]).
//
//   grid:   out[h Sw + j][bucket][u_off + su][iv0 + sv]
//             += (uk[su] * s[h Sw + j]) * vk[sv],
//           s the scale stack, given or split as wk_t[j] * (h ? vim : vre);
//   degrid: v_h = sum_{j, su} (uk[su] * wk_t[j])
//             * sum_sv planes[h][p_idx + j][8 g + u_off + su]
//                            [128 hv + iv0 + sv] * vk[sv].
//
// Full f32 (the Pallas kernels' "highest"); lanes past the window width
// are dropped, as the Pallas band build drops them.
//
// What bounds it on an H100, and the design. The Pallas kernels multiply
// the dense bands on the MXU: 2 Sw 16 lanes MACs per slot (65,536 at the
// ES shape Sw = 8, lanes = 256), of which 2 Sw S S (1,024) are not zero,
// and stream 1 KiB of bands per slot. Here only the non-zero products are
// formed, from 72 B of taps per slot, so the work is bound by shared-memory
// atomics (grid) and gathers (degrid), not by flops or device memory.
// A whole ES window (2 Sw 16 rows x 256 lanes f32, 256 KiB at Sw = 8) does
// not fit one block's 227 KB of shared memory, so:
// Grid: one CTA of 256 threads per (group of kGroup consecutive plan
// blocks, window plane h Sw + j): a [16][lanes + 1] f32 window (16.4 KiB
// at 256 lanes; the odd row stride spreads a warp's eight u rows over the
// banks) takes the group's S x S products by shared atomics; whenever the
// bucket changes, and at the end, the window's non-zero cells are added
// to the bucket's output window with global atomicAdd (so the f32 sum
// order varies run to run) and the window is zeroed. Slots whose scale is
// zero (padding, invalid) are skipped.
// Degrid: one warp per slot; lane l takes the (j, su) pairs l, l + 32, ...
// of the Sw x S tap rows, gathers S cells of each half from the planes
// (L2-resident: consecutive slots share a bucket's window), forms its
// partial sums, and a shuffle reduction adds them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWinRows = 16;
constexpr int kThreads = 256;
constexpr int kGroup = 8;        // plan blocks per grid CTA
constexpr int kMaxS = 8;
constexpr int kMaxSw = 8;
constexpr int kMaxSmem = 227 * 1024;

struct GridArgs {
  const int* bucket_ids;
  const int* u_off;
  const int* iv0;
  const float* uk;
  const float* vk;
  const float* wk_t;    // split form: [Sw][total]
  const float* vre;
  const float* vim;
  const float* scales;  // stack form: [2 Sw][total]
  int num_blocks, block_v, support, w_support, lanes, num_buckets;
  float* out;           // [2 Sw][num_buckets][16][lanes]
};

__global__ void __launch_bounds__(kThreads)
band_grid_kernel(GridArgs a) {
  extern __shared__ float win[];  // [16][lanes + 1]
  const int S = a.support;
  const int Sw = a.w_support;
  const int lanes = a.lanes;
  const int stride = lanes + 1;
  const int plane = blockIdx.y;
  const int h = plane / Sw;
  const int j = plane % Sw;
  const int64_t total = static_cast<int64_t>(a.num_blocks) * a.block_v;
  const int b_begin = blockIdx.x * kGroup;
  const int b_end = min(a.num_blocks, b_begin + kGroup);
  const int tid = threadIdx.x;
  const float* vis = h ? a.vim : a.vre;

  for (int i = tid; i < kWinRows * stride; i += kThreads) win[i] = 0.0f;
  int cur = -1;
  for (int b = b_begin; b < b_end; ++b) {
    const int bucket = a.bucket_ids[b];  // uniform across the CTA
    if (bucket != cur) {
      __syncthreads();
      if (cur >= 0) {
        float* dst = a.out + ((static_cast<int64_t>(plane) * a.num_buckets +
                               cur) * kWinRows) * lanes;
        for (int i = tid; i < kWinRows * lanes; i += kThreads) {
          const int r = i / lanes;
          const int c = i % lanes;
          const float x = win[r * stride + c];
          if (x != 0.0f) {
            atomicAdd(dst + i, x);
            win[r * stride + c] = 0.0f;
          }
        }
        __syncthreads();
      }
      cur = bucket;
    }
    const int64_t p0 = static_cast<int64_t>(b) * a.block_v;
    for (int e = tid; e < a.block_v * S; e += kThreads) {
      const int64_t p = p0 + e / S;
      const int su = e % S;
      const float s = a.scales != nullptr
                          ? a.scales[plane * total + p]
                          : __fmul_rn(a.wk_t[j * total + p], vis[p]);
      if (s == 0.0f) continue;
      const float u = __fmul_rn(a.uk[p * S + su], s);
      const int c0 = a.iv0[p];
      float* row = win + (a.u_off[p] + su) * stride;
      for (int sv = 0; sv < S; ++sv) {
        if (c0 + sv < lanes) {
          atomicAdd(row + c0 + sv, __fmul_rn(u, a.vk[p * S + sv]));
        }
      }
    }
  }
  __syncthreads();
  if (cur >= 0) {
    float* dst = a.out + ((static_cast<int64_t>(plane) * a.num_buckets +
                           cur) * kWinRows) * lanes;
    for (int i = tid; i < kWinRows * lanes; i += kThreads) {
      const float x = win[(i / lanes) * stride + i % lanes];
      if (x != 0.0f) atomicAdd(dst + i, x);
    }
  }
}

struct DegridArgs {
  const float* planes;  // [2][P][rows_pad][lanes_pad]
  const int* p_idx;
  const int* g_idx;
  const int* hv_idx;
  const int* u_off;
  const int* iv0;
  const float* uk;
  const float* vk;
  const float* wk_t;    // [Sw][total]
  int num_planes, rows_pad, lanes_pad;
  int64_t total;
  int block_v, support, w_support, lanes_win;
  float* out;           // rows 0 (re) and 1 (im) of [8][total]
};

__global__ void __launch_bounds__(kThreads)
band_degrid_kernel(DegridArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    threadIdx.x / 32;
  if (p >= a.total) return;  // uniform across the warp
  const int S = a.support;
  const int Sw = a.w_support;
  const int b = static_cast<int>(p / a.block_v);
  const int c0 = a.iv0[p];
  const int64_t plane_elems =
      static_cast<int64_t>(a.rows_pad) * a.lanes_pad;
  const int64_t half = static_cast<int64_t>(a.num_planes) * plane_elems;
  const float* base = a.planes +
                      static_cast<int64_t>(a.p_idx[b]) * plane_elems +
                      static_cast<int64_t>(8 * a.g_idx[b] + a.u_off[p]) *
                          a.lanes_pad +
                      128 * a.hv_idx[b] + c0;
  float vk[kMaxS];
#pragma unroll
  for (int sv = 0; sv < kMaxS; ++sv) {
    vk[sv] = (sv < S && c0 + sv < a.lanes_win) ? a.vk[p * S + sv] : 0.0f;
  }
  float re = 0.0f;
  float im = 0.0f;
  for (int idx = lane; idx < Sw * S; idx += 32) {
    const int j = idx / S;
    const int su = idx % S;
    const float uw = __fmul_rn(a.uk[p * S + su], a.wk_t[j * a.total + p]);
    const float* cell = base + j * plane_elems + su * a.lanes_pad;
    float t0 = 0.0f;
    float t1 = 0.0f;
#pragma unroll
    for (int sv = 0; sv < kMaxS; ++sv) {
      if (sv < S && c0 + sv < a.lanes_win) {
        t0 = __fadd_rn(t0, __fmul_rn(cell[sv], vk[sv]));
        t1 = __fadd_rn(t1, __fmul_rn(cell[half + sv], vk[sv]));
      }
    }
    re = __fadd_rn(re, __fmul_rn(uw, t0));
    im = __fadd_rn(im, __fmul_rn(uw, t1));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
  if (lane == 0) {
    a.out[p] = re;
    a.out[a.total + p] = im;
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). The split
// scale form passes wk_t/vre/vim and a null `scales`; the stack form the
// reverse.
int sdp_torch_band_grid(const int* bucket_ids, const int* u_off,
                        const int* iv0, const float* uk, const float* vk,
                        const float* wk_t, const float* vre,
                        const float* vim, const float* scales,
                        int num_blocks, int block_v, int support,
                        int w_support, int lanes, int num_buckets,
                        float* out, void* stream) {
  if (block_v <= 0 || support < 1 || support > kMaxS || w_support < 1 ||
      w_support > kMaxSw || lanes <= 0 || num_buckets <= 0 ||
      (scales == nullptr && (wk_t == nullptr || vre == nullptr ||
                             vim == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks <= 0) return 0;
  const size_t smem = sizeof(float) * kWinRows * (lanes + 1);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      band_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const GridArgs a{bucket_ids, u_off, iv0, uk, vk, wk_t, vre, vim, scales,
                   num_blocks, block_v, support, w_support, lanes,
                   num_buckets, out};
  const dim3 grid((num_blocks + kGroup - 1) / kGroup, 2 * w_support);
  band_grid_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sdp_torch_band_degrid(const float* planes, const int* p_idx,
                          const int* g_idx, const int* hv_idx,
                          const int* u_off, const int* iv0, const float* uk,
                          const float* vk, const float* wk_t, int num_planes,
                          int rows_pad, int lanes_pad, int64_t total,
                          int block_v, int support, int w_support,
                          int lanes_win, float* out, void* stream) {
  if (block_v <= 0 || support < 1 || support > kMaxS || w_support < 1 ||
      w_support > kMaxSw || num_planes <= 0 || rows_pad <= 0 ||
      lanes_pad <= 0 || lanes_win <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total <= 0) return 0;
  const DegridArgs a{planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk, wk_t,
                     num_planes, rows_pad, lanes_pad, total, block_v,
                     support, w_support, lanes_win, out};
  constexpr int per_cta = kThreads / 32;
  const unsigned ctas = static_cast<unsigned>((total + per_cta - 1) / per_cta);
  band_degrid_kernel<<<ctas, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
