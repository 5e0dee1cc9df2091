// Per-plane w-towers tap gridding / degridding for Hopper (sm_90a): the
// task drivers' kernels.
//
// Replace the Pallas TPU kernels grid_plane_pallas (K14) and
// degrid_plane_pallas (K15) of ska_sdp_func_tpu/kernels/pallas_tap.py.
// Both take one w-plane's [R, C] geometry as the task drivers make it
// (grid_data/wtower.py _plane_geometry): mask (bool), iu0, iv0, u_row,
// v_row, w_row (int32), flattened to V = R C entries, and the kernel
// tables uv_kernel [uv_rows, S] and w_kernel [w_rows, Sw] (f32). An entry
// is active where its mask is set; for it
//
//   grid:   stack[l, iu0+a, iv0+b] += (uk[a] * s_l) * vk[b],
//           s_l = w_kernel[w_row, l] * vis (re and im),
//   degrid: out = sum_l w_l sum_{a,b} uk[a] vk[b] stack[l, iu0+a, iv0+b],
//
// with uk = uv_kernel[u_row], vk = uv_kernel[v_row], w_l =
// w_kernel[w_row, l], and the stack [Sw, N, N] complex64 (interleaved re,
// im). Taps outside [0, N)^2 are dropped; kernel rows are clamped into
// their tables. BF16 is a template argument and rounds what the TPU's
// single-pass bf16 dot rounds, as tower_grid_kernel / tower_degrid_kernel
// do: grid bf16(uk * s) * bf16(vk), degrid (bf16(uk) * bf16(cell)) * vk
// with the f32 weight; products and sums stay f32.
//
// What bounds it on an H100. The TPU kernels stream every entry of the
// plane through dense band products, because on the TPU a dense block
// stream is the cheap form. The task drivers' planes are sparse: on the
// bench data a median plane has 251 active entries of 1,048,576 and the
// largest 4461. So the bytes that must move are the mask (1 byte an
// entry), ~110 bytes of operands for each active entry, and the stack
// (grid, read and written) or the [R, C] result (degrid, written): a few
// microseconds at most, and launch latency dominates. The design touches
// nothing else:
//
//   1. compact_active_kernel (shared by K14 and K15): one pass over the
//      mask, 16 entries a thread from one 16-byte load; a CTA-wide scan of
//      the per-thread counts (__popc of the thread's bits, warp shuffles)
//      and one atomicAdd per CTA reserve the CTA's run in a device list of
//      active linear indices. The count stays on the device: the consumer
//      launches with a fixed grid and reads it (no host sync). The list
//      keeps each CTA's entries in order, so a run of the list is a run of
//      neighbouring channels of few rows: neighbouring cells.
//   2. plane_grid_kernel: a fixed grid (SM count x CTAs that fit an SM);
//      CTA b takes entries [b c, (b + 1) c) of the list, c = max(32,
//      ceil(count / CTAs)), and exits past the count. It takes the cell
//      box of its entries, zeroes that box of an f32 stack of re and im
//      planes in shared memory (opt-in dynamic shared memory: 128 KB at N
//      = 64, Sw = 4), gathers each entry's operands and table rows itself
//      and adds its S x S taps on every layer with shared-memory atomics
//      (64 threads an entry: a warp's atomics hit distinct cells), then
//      flushes the box's non-zero cells into the complex64 stack with one
//      float2 global atomic each. A stack that does not fit (N = 128)
//      splits its layers into groups that fit, one grid row each; a
//      single layer that does not fit (N > 170) skips shared memory and
//      adds each tap straight into the stack with float2 atomics.
//   3. plane_degrid_kernel: the result is zeroed with one
//      cudaMemsetAsync; a fixed grid of warps walks the list, one warp an
//      active entry: its lanes gather the taps from the tables and the
//      cells from the interleaved stack (L1/L2-resident, 128 KB at N = 64),
//      a shuffle reduction sums them and lane 0 writes one float2.
//
// Two launches (compaction, consumer), not one fused pass whose CTAs would
// each compact a fixed span of the mask: a plane's active entries lie in
// few rows, so a fused pass would leave the work to the few CTAs whose
// spans hold them, and the separate pass costs little (chip_smoke.py times
// the call on an all-masked plane beside the real one; PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kPerThread = 16;        // mask entries per thread (16 B)
constexpr int kGridThreads = 512;
constexpr int kDegridThreads = 256;   // 8 warps, one entry each at a time
constexpr int kDegridCtasPerSm = 8;
constexpr int kMinChunk = 32;         // fewest entries a grid CTA takes
constexpr int kSmemReserve = 1024;    // static shared memory and slack

struct PlaneArgs {
  const int* iu0;
  const int* iv0;
  const int* u_row;
  const int* v_row;
  const int* w_row;
  const float* uv_kernel;
  int uv_rows;
  const float* w_kernel;
  int w_rows;
  int support;
  int w_support;
  int size;
  const int* active;   // [V] active linear indices, first *count valid
  const int* count;
};

// One active entry's cell, and its rows of the two tables.
struct Entry {
  int u0;
  int v0;
  const float* uk;
  const float* vk;
  const float* wk;
};

__device__ __forceinline__ Entry load_entry(const PlaneArgs& a, int idx) {
  Entry e;
  e.u0 = a.iu0[idx];
  e.v0 = a.iv0[idx];
  e.uk = a.uv_kernel + min(max(a.u_row[idx], 0), a.uv_rows - 1) * a.support;
  e.vk = a.uv_kernel + min(max(a.v_row[idx], 0), a.uv_rows - 1) * a.support;
  e.wk = a.w_kernel + min(max(a.w_row[idx], 0), a.w_rows - 1) * a.w_support;
  return e;
}

__device__ __forceinline__ void atomic_add2(float2* p, float x, float y) {
#if CUDART_VERSION >= 12010
  atomicAdd(p, make_float2(x, y));   // one vector atomic (sm_90, global)
#else
  atomicAdd(&p->x, x);
  atomicAdd(&p->y, y);
#endif
}

// Bits 0-3: which of the four bytes of x are non-zero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  const unsigned m = __vcmpne4(x, 0u) & 0x80808080u;
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

__global__ void __launch_bounds__(kCompactThreads)
compact_active_kernel(const uint8_t* __restrict__ mask, int64_t total,
                      bool aligned, int* __restrict__ active,
                      int* __restrict__ count) {
  __shared__ int warp_base[kCompactWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kCompactThreads + threadIdx.x) *
      kPerThread;

  unsigned bits = 0;
  if (aligned && first + kPerThread <= total) {
    const uint4 q = *reinterpret_cast<const uint4*>(mask + first);
    bits = nonzero_bytes(q.x) | (nonzero_bytes(q.y) << 4) |
           (nonzero_bytes(q.z) << 8) | (nonzero_bytes(q.w) << 12);
  } else {
    for (int i = 0; i < kPerThread && first + i < total; ++i) {
      bits |= static_cast<unsigned>(mask[first + i] != 0) << i;
    }
  }
  const int n = __popc(bits);

  // Inclusive scan of n over the warp, then over the CTA's warps.
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kCompactWarps ? warp_base[lane] : 0;
    int s = w;
#pragma unroll
    for (int off = 1; off < kCompactWarps; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    const int cta_total = __shfl_sync(0xffffffffu, s, kCompactWarps - 1);
    int base = 0;
    if (lane == 0 && cta_total > 0) base = atomicAdd(count, cta_total);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (lane < kCompactWarps) warp_base[lane] = base + s - w;
  }
  __syncthreads();
  int pos = warp_base[warp] + incl - n;
  while (bits) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1;
    active[pos++] = static_cast<int>(first + i);
  }
}

// Layers [blockIdx.y * group, + group) of the stack; SMEM: through a
// shared f32 stack (re planes, then im planes) of `group` layers.
template <bool BF16, bool SMEM>
__global__ void __launch_bounds__(kGridThreads)
plane_grid_kernel(const PlaneArgs a, const float2* __restrict__ vis,
                  int group, float2* __restrict__ out) {
  extern __shared__ float acc[];   // SMEM: [2][group][size][size]
  __shared__ int box[4];           // u_min, u_max, v_min, v_max

  const int count = *a.count;
  const int chunk = max(kMinChunk, (count + static_cast<int>(gridDim.x) - 1) /
                                       static_cast<int>(gridDim.x));
  const int64_t begin64 = static_cast<int64_t>(blockIdx.x) * chunk;
  if (begin64 >= count) return;   // uniform across the CTA
  const int begin = static_cast<int>(begin64);
  const int n = min(chunk, count - begin);
  const int size = a.size;
  const int support = a.support;
  const int plane = size * size;
  const int l0 = blockIdx.y * group;
  const int nl = min(group, a.w_support - l0);
  const int tid = threadIdx.x;

  int r0 = 0, r1 = size, c0 = 0, c1 = size;
  float* acc_re = acc;
  float* acc_im = acc + group * plane;
  if (SMEM) {
    if (tid == 0) {
      box[0] = size;
      box[1] = -1;
      box[2] = size;
      box[3] = -1;
    }
    __syncthreads();
    int u_min = size, u_max = -1, v_min = size, v_max = -1;
    for (int j = tid; j < n; j += kGridThreads) {
      const int idx = a.active[begin + j];
      u_min = min(u_min, a.iu0[idx]);
      u_max = max(u_max, a.iu0[idx]);
      v_min = min(v_min, a.iv0[idx]);
      v_max = max(v_max, a.iv0[idx]);
    }
    u_min = __reduce_min_sync(0xffffffffu, u_min);
    u_max = __reduce_max_sync(0xffffffffu, u_max);
    v_min = __reduce_min_sync(0xffffffffu, v_min);
    v_max = __reduce_max_sync(0xffffffffu, v_max);
    if ((tid & 31) == 0) {
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
    const int width = max(c1 - c0, 0);
    const int cells = max(r1 - r0, 0) * width;
    for (int i = tid; i < nl * cells; i += kGridThreads) {
      const int l = i / cells;
      const int c = i - l * cells;
      const int cell = l * plane + (r0 + c / width) * size + c0 + c % width;
      acc_re[cell] = 0.0f;
      acc_im[cell] = 0.0f;
    }
    __syncthreads();
  }

  // S x S taps of each entry on each layer of the group.
  const int taps = support * support;
  for (int i = tid; i < n * taps; i += kGridThreads) {
    const int idx = a.active[begin + i / taps];
    const int t = i % taps;
    const int ia = t / support;
    const int ib = t - ia * support;
    const Entry e = load_entry(a, idx);
    const int u = e.u0 + ia;
    const int w = e.v0 + ib;
    if (u < 0 || u >= size || w < 0 || w >= size) continue;
    const float2 v = vis[idx];
    const float uk = e.uk[ia];
    const float vk = e.vk[ib];
    const float vk_b = BF16 ? round_bf16(vk) : vk;
    for (int l = 0; l < nl; ++l) {
      const float wl = e.wk[l0 + l];
      if (wl == 0.0f) continue;
      const float sr = __fmul_rn(wl, v.x);
      const float si = __fmul_rn(wl, v.y);
      // bf16 x bf16 is exact in f32: the product is the dot's term.
      const float xr = BF16 ? __fmul_rn(round_bf16(__fmul_rn(uk, sr)), vk_b)
                            : __fmul_rn(__fmul_rn(uk, sr), vk);
      const float xi = BF16 ? __fmul_rn(round_bf16(__fmul_rn(uk, si)), vk_b)
                            : __fmul_rn(__fmul_rn(uk, si), vk);
      if (SMEM) {
        atomicAdd(&acc_re[l * plane + u * size + w], xr);
        atomicAdd(&acc_im[l * plane + u * size + w], xi);
      } else {
        atomic_add2(&out[static_cast<int64_t>(l0 + l) * plane + u * size + w],
                    xr, xi);
      }
    }
  }

  // Flush the box's non-zero cells into the complex64 stack.
  if (SMEM) {
    __syncthreads();
    const int width = max(c1 - c0, 0);
    const int cells = max(r1 - r0, 0) * width;
    for (int i = tid; i < nl * cells; i += kGridThreads) {
      const int l = i / cells;
      const int c = i - l * cells;
      const int cell = (r0 + c / width) * size + c0 + c % width;
      const float x = acc_re[l * plane + cell];
      const float y = acc_im[l * plane + cell];
      if (x != 0.0f || y != 0.0f) {
        atomic_add2(&out[static_cast<int64_t>(l0 + l) * plane + cell], x, y);
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kDegridThreads)
plane_degrid_kernel(const PlaneArgs a, const float2* __restrict__ stack,
                    float2* __restrict__ out) {
  const int count = *a.count;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kDegridThreads / 32);
  const int size = a.size;
  const int support = a.support;
  const int taps = support * support;
  const int64_t plane = static_cast<int64_t>(size) * size;
  for (int j = blockIdx.x * (kDegridThreads / 32) + threadIdx.x / 32;
       j < count; j += warps) {   // uniform across the warp
    const int idx = a.active[j];
    const Entry e = load_entry(a, idx);
    float re = 0.0f;
    float im = 0.0f;
    for (int k = 0; k < a.w_support; ++k) {
      const float wt = e.wk[k];
      if (wt == 0.0f) continue;   // uniform across the warp
      const float2* layer = stack + k * plane;
      float pr = 0.0f;
      float pi = 0.0f;
      for (int t = lane; t < taps; t += 32) {
        const int ia = t / support;
        const int ib = t - ia * support;
        const int u = e.u0 + ia;
        const int w = e.v0 + ib;
        if (u < 0 || u >= size || w < 0 || w >= size) continue;
        const float2 cell = layer[u * size + w];
        if (BF16) {
          // The bf16 dot's term bf16(uk) * bf16(cell), exact in f32, then
          // the f32 product with vk.
          const float ua = round_bf16(e.uk[ia]);
          pr = fmaf(__fmul_rn(ua, round_bf16(cell.x)), e.vk[ib], pr);
          pi = fmaf(__fmul_rn(ua, round_bf16(cell.y)), e.vk[ib], pi);
        } else {
          const float tap = e.uk[ia] * e.vk[ib];
          pr = fmaf(tap, cell.x, pr);
          pi = fmaf(tap, cell.y, pi);
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
    if (lane == 0) out[idx] = make_float2(re, im);
  }
}

struct Device {
  int sms;
  int smem_optin;
};

cudaError_t current_device(Device* d) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&d->smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err;
}

bool bad_args(const PlaneArgs& a, int64_t total) {
  return total > INT32_MAX || a.support < 1 || a.w_support < 1 ||
         a.size < 1 || a.uv_rows < 1 || a.w_rows < 1;
}

// Zero the count and fill the active list (K14 and K15's shared step).
cudaError_t compact(const uint8_t* mask, int64_t total, int* work,
                    cudaStream_t s) {
  int* count = work + total;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  constexpr int64_t per_cta = static_cast<int64_t>(kCompactThreads) *
                              kPerThread;
  const unsigned ctas = static_cast<unsigned>((total + per_cta - 1) / per_cta);
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  compact_active_kernel<<<ctas, kCompactThreads, 0, s>>>(mask, total, aligned,
                                                         work, count);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_grid(const PlaneArgs& a, const float2* vis, float2* out,
                        const Device& d, cudaStream_t s) {
  const size_t layer_bytes = 2 * sizeof(float) * a.size * a.size;
  const int fit = static_cast<int>((d.smem_optin - kSmemReserve) /
                                   static_cast<int64_t>(layer_bytes));
  if (fit < 1) {
    plane_grid_kernel<BF16, false>
        <<<dim3(d.sms * (2048 / kGridThreads), 1), kGridThreads, 0, s>>>(
            a, vis, a.w_support, out);
    return cudaGetLastError();
  }
  const int group = min(a.w_support, fit);
  const size_t smem = group * layer_bytes;
  auto kernel = plane_grid_kernel<BF16, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kGridThreads, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.sms * max(per_sm, 1),
                  (a.w_support + group - 1) / group);
  kernel<<<grid, kGridThreads, smem, s>>>(a, vis, group, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K14: add one plane's taps into `out`, the complex64 [Sw, N, N] stack
// (the wrapper's copy of the input stack). `work` is int32 [V + 1]
// scratch. Returns the cudaError_t of the launches (0 on success).
int sdp_torch_plane_grid(const uint8_t* mask, const int* iu0, const int* iv0,
                         const int* u_row, const int* v_row, const int* w_row,
                         const float* vis, const float* uv_kernel,
                         int uv_rows, const float* w_kernel, int w_rows,
                         int64_t total, int support, int w_support, int size,
                         int bf16, int* work, float* out, void* stream) {
  const PlaneArgs a{iu0,      iv0,     u_row,   v_row,     w_row,
                    uv_kernel, uv_rows, w_kernel, w_rows,   support,
                    w_support, size,    work,    work + total};
  if (total <= 0) return 0;
  if (bad_args(a, total)) return static_cast<int>(cudaErrorInvalidValue);
  Device d;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = compact(mask, total, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* v = reinterpret_cast<const float2*>(vis);
  float2* o = reinterpret_cast<float2*>(out);
  return static_cast<int>(bf16 ? launch_grid<true>(a, v, o, d, s)
                               : launch_grid<false>(a, v, o, d, s));
}

// K15: one plane's visibilities, complex64 [V] (zero where masked), from
// the complex64 [Sw, N, N] stack. `work` is int32 [V + 1] scratch.
int sdp_torch_plane_degrid(const uint8_t* mask, const int* iu0,
                           const int* iv0, const int* u_row, const int* v_row,
                           const int* w_row, const float* stack,
                           const float* uv_kernel, int uv_rows,
                           const float* w_kernel, int w_rows, int64_t total,
                           int support, int w_support, int size, int bf16,
                           int* work, float* out, void* stream) {
  const PlaneArgs a{iu0,      iv0,     u_row,   v_row,     w_row,
                    uv_kernel, uv_rows, w_kernel, w_rows,   support,
                    w_support, size,    work,    work + total};
  if (total <= 0) return 0;
  if (bad_args(a, total)) return static_cast<int>(cudaErrorInvalidValue);
  Device d;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(float2) * total, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = compact(mask, total, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctas = static_cast<unsigned>(d.sms * kDegridCtasPerSm);
  const float2* st = reinterpret_cast<const float2*>(stack);
  float2* o = reinterpret_cast<float2*>(out);
  if (bf16) {
    plane_degrid_kernel<true><<<ctas, kDegridThreads, 0, s>>>(a, st, o);
  } else {
    plane_degrid_kernel<false><<<ctas, kDegridThreads, 0, s>>>(a, st, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
