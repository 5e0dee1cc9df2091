// W-towers tap gridding / degridding kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of ska_sdp_func_tpu/kernels/pallas_tap.py
// and kernels/sparse_tap.py. pallas_tap's four entry points share two
// kernel bodies, and so do these:
//   - _grid_kernel   (grid_plane_pallas, grid_all_layers_pallas)
//                    -> tower_grid_kernel
//   - _degrid_kernel (degrid_plane_pallas, degrid_all_layers_pallas)
//                    -> tower_degrid_kernel
// and sparse_tap's _sparse_grid_kernel (grid_all_layers_sparse) is the
// SPARSE instantiation of tower_grid_kernel.
//
// Inputs are flat per-visibility taps (shared with the plain PyTorch
// versions in tower_tap.py and sparse_tap.py): iu0/iv0 [V] int32 sub-grid
// cells, uk/vk [V, S] f32 kernel taps, and the w-kernel value of each
// visibility for each of the K layers: dense, weights [V, K] f32 (zero
// outside its Sw layers); or SPARSE, k0 [V] int32 first layer (clipped to
// [0, K - Sw]) and wk [V, Sw] f32, so that layer k takes wk[v, k - k0]
// when 0 <= k - k0 < Sw and 0 otherwise. Layer planes are f32 [2K, N, N]:
// re of layers 0..K-1, then im.
//
//   grid:   out[h*K + k, iu0+a, iv0+b] += (uk[v,a] * s) * vk[v,b],
//           s = w[v,k] * (h ? vim : vre)[v], summed over v;
//   degrid: vis[v] = sum_k w[v,k] * sum_{a,b} uk[v,a] vk[v,b]
//                    * layer_k[iu0+a, iv0+b]        (re and im).
// Taps outside [0, N)^2 are dropped, as the TPU band build drops them (the
// sparse TPU kernel's rows past its padded plane run into the next layer;
// that is not copied).
//
// Precision. f32 throughout by default (the Pallas kernels'
// Precision.HIGHEST); only the order of the sums differs. BF16 is the
// TPU's single-pass bf16 dot (Precision.DEFAULT, the Pallas `fast` mode),
// rounding exactly the operands of its dots: grid, bf16(uk * s) *
// bf16(vk), with uk * s rounded once in f32 first; degrid, (bf16(uk) *
// bf16(cell)) * vk, vk and the w weight in f32. Each bf16 product is
// exact in f32 and the sums are f32. The mode is a template argument: the
// inner loops carry no branch on it.
//
// What bounds it on an H100. The TPU kernel rebuilt the scatter as dense
// [N, B] x [B, N] band products for the MXU (2 N^2 flops per visibility
// and layer, of which only S^2 = 64 are not zero). On the card the
// sparse form is the cheap one: 2 S^2 flops and a handful of bytes per
// visibility and active layer, so both kernels are bound by memory
// latency (shared-memory atomics for the grid, L1/L2 gathers for the
// degrid), not by flops or HBM bandwidth. The bf16 mode rounds in
// registers and uses no tensor cores: it costs what f32 costs.
//
// Grid design (the simple, correct one): one CTA of 256 threads per
// (block of block_v visibilities, output plane h*K + k). A CTA first
// checks whether any visibility of its block has a non-zero scale for
// its plane and exits if none does (the Pallas per-(block, layer) skip
// flags; with w-sorted input most of a block's K layers are inactive),
// and takes the bounding box of the active visibilities' taps. It then
// zeroes that box of an [N, N] f32 plane in shared memory, accumulates
// the S x S taps of every active visibility with shared-memory atomics
// (one visibility's taps per 64 threads, so a warp's atomics hit
// distinct cells), and flushes the box's non-zero cells into the output
// with one global atomicAdd each. Planes above kMaxSmemPlane bytes
// (N > 156) skip the shared plane and add straight into global memory.
// The sparse form reads 4 + 4 Sw bytes of w taps per visibility in place
// of 4 K; the TPU kernel's sequential per-visibility read-modify-writes
// become the same atomics.
// Degrid design: one warp per visibility; for each layer with a non-zero
// weight its lanes gather the S x S taps (coalesced rows of S floats
// from the L2-resident planes), and a warp shuffle reduces the sums.

#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

constexpr int kGridThreads = 256;
constexpr int kDegridThreads = 256;  // 8 warps, one visibility each
constexpr int kMaxSmemPlane = 96 * 1024;

struct TowerGridArgs {
  const float* vre;
  const float* vim;
  const int* iu0;
  const int* iv0;
  const int* k0;      // SPARSE: [V] first layer; dense: unused
  const float* uk;
  const float* vk;
  const float* w;     // dense: weights [V, K]; SPARSE: wk [V, Sw]
  int64_t total;
  int support;
  int w_support;      // SPARSE only
  int num_layers;
  int size;
  int block_v;
  float* out;
};

// The w-kernel value of visibility v on layer k.
template <bool SPARSE>
__device__ __forceinline__ float layer_weight(const TowerGridArgs& a,
                                              int64_t v, int k) {
  if (SPARSE) {
    const int first = min(max(a.k0[v], 0), a.num_layers - a.w_support);
    const int l = k - first;
    return l >= 0 && l < a.w_support ? a.w[v * a.w_support + l] : 0.0f;
  }
  return a.w[v * a.num_layers + k];
}

template <bool SMEM, bool BF16, bool SPARSE>
__global__ void __launch_bounds__(kGridThreads)
tower_grid_kernel(const TowerGridArgs a) {
  extern __shared__ float plane[];  // [size * size] when SMEM
  __shared__ int box[4];            // u_min, u_max, v_min, v_max

  const int size = a.size;
  const int support = a.support;
  const int p = blockIdx.y;         // output plane h * K + k
  const int k = p % a.num_layers;
  const float* vals = p < a.num_layers ? a.vre : a.vim;
  const int64_t v_begin = static_cast<int64_t>(blockIdx.x) * a.block_v;
  const int64_t v_end =
      v_begin + a.block_v < a.total ? v_begin + a.block_v : a.total;
  const int count = static_cast<int>(v_end - v_begin);
  const int tid = threadIdx.x;
  float* dst = a.out + static_cast<int64_t>(p) * size * size;

  if (tid == 0) {
    box[0] = size;
    box[1] = -1;
    box[2] = size;
    box[3] = -1;
  }
  __syncthreads();

  // Pass 1: is any visibility active for this plane; tap bounding box.
  int active = 0;
  int u_min = size, u_max = -1, v_min = size, v_max = -1;
  for (int i = tid; i < count; i += kGridThreads) {
    const int64_t v = v_begin + i;
    if (layer_weight<SPARSE>(a, v, k) * vals[v] != 0.0f) {
      active = 1;
      u_min = min(u_min, a.iu0[v]);
      u_max = max(u_max, a.iu0[v]);
      v_min = min(v_min, a.iv0[v]);
      v_max = max(v_max, a.iv0[v]);
    }
  }
  if (!__syncthreads_or(active)) return;

  int r0 = 0, r1 = size, c0 = 0, c1 = size;
  if (SMEM) {
    if (active) {
      atomicMin(&box[0], u_min);
      atomicMax(&box[1], u_max);
      atomicMin(&box[2], v_min);
      atomicMax(&box[3], v_max);
    }
    __syncthreads();
    r0 = max(box[0], 0);
    r1 = min(box[1] + support, size);
    c0 = max(box[2], 0);
    c1 = min(box[3] + support, size);
    const int width = c1 - c0;
    for (int i = tid; i < (r1 - r0) * width; i += kGridThreads) {
      plane[(r0 + i / width) * size + c0 + i % width] = 0.0f;
    }
    __syncthreads();
  }

  // Pass 2: S x S taps of every active visibility.
  const int taps = support * support;
  for (int i = tid; i < count * taps; i += kGridThreads) {
    const int64_t v = v_begin + i / taps;
    const float s = layer_weight<SPARSE>(a, v, k) * vals[v];
    if (s == 0.0f) continue;
    const int t = i % taps;
    const int ia = t / support;
    const int ib = t % support;
    const int u = a.iu0[v] + ia;
    const int w = a.iv0[v] + ib;
    if (u < 0 || u >= size || w < 0 || w >= size) continue;
    const float uk = a.uk[v * support + ia];
    const float vk = a.vk[v * support + ib];
    // bf16 x bf16 is exact in f32: the product is the dot's term.
    const float val = BF16 ? __fmul_rn(round_bf16(__fmul_rn(uk, s)),
                                       round_bf16(vk))
                           : (uk * s) * vk;
    if (SMEM) {
      atomicAdd(&plane[u * size + w], val);
    } else {
      atomicAdd(&dst[u * size + w], val);
    }
  }

  // Pass 3: flush the box into the output plane.
  if (SMEM) {
    __syncthreads();
    const int width = c1 - c0;
    for (int i = tid; i < (r1 - r0) * width; i += kGridThreads) {
      const int cell = (r0 + i / width) * size + c0 + i % width;
      const float x = plane[cell];
      if (x != 0.0f) atomicAdd(&dst[cell], x);
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kDegridThreads)
tower_degrid_kernel(const float* __restrict__ planes,
                    const int* __restrict__ iu0,
                    const int* __restrict__ iv0,
                    const float* __restrict__ uk,
                    const float* __restrict__ vk,
                    const float* __restrict__ weights, int64_t total,
                    int support, int num_layers, int size,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * (kDegridThreads / 32) +
                    threadIdx.x / 32;
  if (v >= total) return;  // uniform across the warp

  const int u0 = iu0[v];
  const int w0 = iv0[v];
  const int taps = support * support;
  const int64_t plane_size = static_cast<int64_t>(size) * size;
  const float* uk_v = uk + v * support;
  const float* vk_v = vk + v * support;
  float re = 0.0f;
  float im = 0.0f;
  for (int k = 0; k < num_layers; ++k) {
    const float wt = weights[v * num_layers + k];
    if (wt == 0.0f) continue;  // uniform across the warp
    const float* layer_re = planes + k * plane_size;
    const float* layer_im = planes + (num_layers + k) * plane_size;
    float pr = 0.0f;
    float pi = 0.0f;
    for (int t = lane; t < taps; t += 32) {
      const int a = t / support;
      const int b = t % support;
      const int u = u0 + a;
      const int w = w0 + b;
      if (u < 0 || u >= size || w < 0 || w >= size) continue;
      const int64_t cell = static_cast<int64_t>(u) * size + w;
      if (BF16) {
        // The bf16 dot's term bf16(uk) * bf16(cell), exact in f32, then
        // the f32 product with vk.
        const float ua = round_bf16(uk_v[a]);
        pr = fmaf(__fmul_rn(ua, round_bf16(layer_re[cell])), vk_v[b], pr);
        pi = fmaf(__fmul_rn(ua, round_bf16(layer_im[cell])), vk_v[b], pi);
      } else {
        const float tap = uk_v[a] * vk_v[b];
        pr = fmaf(tap, layer_re[cell], pr);
        pi = fmaf(tap, layer_im[cell], pi);
      }
    }
    re = fmaf(wt, pr, re);
    im = fmaf(wt, pi, im);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
  if (lane == 0) {
    out[v] = re;
    out[total + v] = im;
  }
}

template <bool BF16, bool SPARSE>
cudaError_t launch_grid(const TowerGridArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.total + a.block_v - 1) /
                                        a.block_v),
                  2 * a.num_layers);
  const size_t smem = sizeof(float) * a.size * a.size;
  if (smem <= static_cast<size_t>(kMaxSmemPlane)) {
    const cudaError_t err = cudaFuncSetAttribute(
        tower_grid_kernel<true, BF16, SPARSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tower_grid_kernel<true, BF16, SPARSE><<<grid, kGridThreads, smem, s>>>(
        a);
  } else {
    tower_grid_kernel<false, BF16, SPARSE><<<grid, kGridThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool SPARSE>
int grid_entry(const TowerGridArgs& a, int bf16, void* stream) {
  if (a.total <= 0) return 0;
  if (a.support < 1 || a.num_layers < 1 || a.size < 1 || a.block_v < 1 ||
      2 * a.num_layers > 65535 ||
      (SPARSE && (a.w_support < 1 || a.w_support > a.num_layers)) ||
      static_cast<int64_t>(a.block_v) * a.support * a.support > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_grid<true, SPARSE>(a, s)
                               : launch_grid<false, SPARSE>(a, s));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success); `bf16`
// selects the bf16 mode.
// Dense weights [V, K] (K14, K16).
int sdp_torch_tower_grid(const float* vre, const float* vim, const int* iu0,
                         const int* iv0, const float* uk, const float* vk,
                         const float* weights, int64_t total, int support,
                         int num_layers, int size, int block_v, int bf16,
                         float* out, void* stream) {
  const TowerGridArgs a{vre, vim, iu0, iv0, nullptr, uk, vk, weights,
                        total, support, 0, num_layers, size, block_v, out};
  return grid_entry<false>(a, bf16, stream);
}

// Sparse w taps: k0 [V], wk [V, Sw] (K20).
int sdp_torch_tower_grid_sparse(const float* vre, const float* vim,
                                const int* iu0, const int* iv0,
                                const int* k0, const float* uk,
                                const float* vk, const float* wk,
                                int64_t total, int support, int w_support,
                                int num_layers, int size, int block_v,
                                int bf16, float* out, void* stream) {
  const TowerGridArgs a{vre, vim, iu0, iv0, k0, uk, vk, wk, total,
                        support, w_support, num_layers, size, block_v, out};
  return grid_entry<true>(a, bf16, stream);
}

// K15, K17.
int sdp_torch_tower_degrid(const float* planes, const int* iu0,
                           const int* iv0, const float* uk, const float* vk,
                           const float* weights, int64_t total, int support,
                           int num_layers, int size, int bf16, float* out,
                           void* stream) {
  if (total <= 0) return 0;
  if (support < 1 || num_layers < 1 || size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int per_cta = kDegridThreads / 32;
  const unsigned ctas = static_cast<unsigned>((total + per_cta - 1) / per_cta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tower_degrid_kernel<true><<<ctas, kDegridThreads, 0, s>>>(
        planes, iu0, iv0, uk, vk, weights, total, support, num_layers, size,
        out);
  } else {
    tower_degrid_kernel<false><<<ctas, kDegridThreads, 0, s>>>(
        planes, iu0, iv0, uk, vk, weights, total, support, num_layers, size,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
