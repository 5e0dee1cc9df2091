// Fused and compact packed gridding / degridding kernels for Hopper
// (sm_90a): per-task stacks from a placed stream of slots whose taps are
// either evaluated in the kernel from two bit-packed int32 plan words per
// slot (fused), or pre-evaluated once per plan and read per slot beside
// the word pa (compact).
//
// Replace the stack forms of the Pallas TPU kernels in
// ska_sdp_func_tpu/kernels/fused_tap.py:
//   - grid_fused_stack_pallas (_grid_stack_kernel, _block_contrib,
//     _prep_common, _stack_accumulate)  -> fused_grid_stack_kernel<M, false>
//   - degrid_fused2_stack_pallas (_degrid_fstack_kernel, _degrid_fused_core,
//     _window_from_stack)             -> fused_degrid_stack_kernel<M, false>
//   - grid_compact_pallas (_grid_compact_kernel)
//                                     -> fused_grid_stack_kernel<M, true>
//   - degrid_compact_pallas (_degrid_compact_kernel)
//                                     -> fused_degrid_stack_kernel<M, true>
//
// Layout (shared with the plain PyTorch versions in fused_tap.py): the
// placed stream of `total` slots is cut into plan blocks of `block_v`
// slots; block b belongs to one (task t, w-slab k0, u-octet g) bucket.
// Slot words: pa = iv0 << 20 | u_off << 17 | w_row,
//             pb = valid << 30 | u_frac << 15 | v_frac.
// Compact taps: uk_t / vk_t [S][total], wk_t [Sw][total] f32 (wk_t zero on
// padding and invalid slots, so valid = 1); pb and the fits are not read.
// Fused taps: uk[s] / vk[s] / wk[j] = sum_d c[d][s] T_d(x),
// x = (2/ov) frac - 1,
// T_d by the three-term recurrence; every operation is rounded on its own
// (__fmul_rn / __fadd_rn, never contracted), in the order the plain
// versions use, so both evaluate identical taps. Stacks are
// f32 [T, 2, num_layers * (lanes + 8), lanes].
//
//   grid:   stack[t, h, (k0+j) sub_pad + 8g + u_off + su, iv0 + sv]
//             += P(uk[su] * (wk[j] * v_h), vk[sv])
//   degrid: v_h = sum_{j,su} (uk[su] * (wk[j] * valid))
//             * sum_sv P(stack[t, h, ...same cell...], vk[sv])
// P is the mode's product: kF32 a*b; kHigh the bf16 hi/lo halves
// hi*hi + (hi*lo + lo*hi), each product exact in f32 (the TPU's bf16-in,
// f32-accumulate dots); kBf16 bf16-rounded factors. Columns >= lanes are
// dropped, as the Pallas band build drops them.
//
// What bounds it on an H100, and the design. The Pallas kernels build a
// dense 16-row u band and a 128-lane v band per slot and contract them on
// the MXU: 2 * Sw * 16 * lanes MACs per slot, of which 2 * Sw * S * S
// (512) are not zero. Here only the non-zero taps are touched, so the work
// is memory-latency bound, not flop bound.
// Grid: one CTA of 256 threads per plan block. Empty blocks (nonempty == 0)
// return at once. The CTA evaluates the taps of 256 slots at a time (one
// slot per thread) into shared memory, then scatters the S x S x 2 Sw
// contributions of those slots into a shared-memory window
// [2 * Sw * 16][lanes + 8] with shared atomics (a warp covers four u rows
// of one slot; the 8-float row padding puts those rows on distinct
// banks), and flushes the window's non-zero cells once into the task's
// stack with global atomicAdd (so the f32 sum order varies run to run).
// The compact kernels stream 92 B (grid) and 84 B (degrid) per slot where
// the fused ones stream 16 B and evaluate a ~30-operation Chebyshev chain
// per tap; their time beside the fused ones' on one plan prices that chain.
// Degrid: one warp per slot; lanes 0..2S+Sw-1 each evaluate (or load) one
// tap and shuffle them to the others; lane (j, su) gathers its S stack cells
// (L1/L2-resident: consecutive slots share a bucket's window), forms its
// partial sums, and a shuffle reduction adds the 2 * Sw * S partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWinRows = 16;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // slots whose taps are staged at once
constexpr int kMaxS = 8;
constexpr int kMaxSw = 4;
constexpr int kMaxCoef = 16;
constexpr int kMaxSmem = 227 * 1024;

enum Mode { kF32 = 0, kHigh = 1, kBf16 = 2 };

__device__ __forceinline__ float split_hi(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__device__ __forceinline__ float prod(float a, float b) {
  if (MODE == kHigh) {
    const float ah = split_hi(a);
    const float al = round_bf16(__fsub_rn(a, ah));
    const float bh = split_hi(b);
    const float bl = round_bf16(__fsub_rn(b, bh));
    return __fadd_rn(__fmul_rn(ah, bh),
                     __fadd_rn(__fmul_rn(ah, bl), __fmul_rn(al, bh)));
  } else if (MODE == kBf16) {
    return __fmul_rn(round_bf16(a), round_bf16(b));
  }
  return __fmul_rn(a, b);
}

// Chebyshev basis T_0..T_{ncoef-1} of x.
__device__ __forceinline__ void cheb_basis(float x, int ncoef,
                                           float (&t)[kMaxCoef]) {
  const float two_x = __fmul_rn(2.0f, x);
  t[0] = 1.0f;
  t[1] = x;
#pragma unroll
  for (int d = 2; d < kMaxCoef; ++d) {
    t[d] = d < ncoef ? __fsub_rn(__fmul_rn(two_x, t[d - 1]), t[d - 2])
                     : 0.0f;
  }
}

// sum_d c[d * stride] * t[d], in order d = 0..ncoef-1.
__device__ __forceinline__ float cheb_sum(const float* __restrict__ c,
                                          int stride, int ncoef,
                                          const float (&t)[kMaxCoef]) {
  float acc = __fmul_rn(c[0], t[0]);
#pragma unroll
  for (int d = 1; d < kMaxCoef; ++d) {
    if (d < ncoef) acc = __fadd_rn(acc, __fmul_rn(c[d * stride], t[d]));
  }
  return acc;
}

__device__ __forceinline__ float frac_x(int frac, float inv2) {
  return __fsub_rn(__fmul_rn(inv2, static_cast<float>(frac)), 1.0f);
}

struct Geometry {
  int block_v, support, w_support, lanes, num_layers, ncoef;
  float inv2_ov, inv2_wov;
};

// Pre-evaluated taps of the compact kernels ([S or Sw][total] f32).
struct CompactTaps {
  const float* uk_t;
  const float* vk_t;
  const float* wk_t;
  int64_t total;
};

__host__ __device__ __forceinline__ int win_stride(int lanes) {
  return lanes + 8;
}

// Shared-memory bytes of one grid CTA.
__host__ __device__ __forceinline__ size_t grid_smem_bytes(int w_support,
                                                           int lanes) {
  const size_t window = 2 * w_support * kWinRows * win_stride(lanes);
  const size_t staged = kChunk * (2 * kMaxS + 2 * kMaxSw + 2);
  return sizeof(float) * (window + staged);
}

template <int MODE, bool COMPACT>
__global__ void __launch_bounds__(kThreads)
fused_grid_stack_kernel(const int* __restrict__ t_idx,
                        const int* __restrict__ k_idx,
                        const int* __restrict__ g_idx,
                        const int* __restrict__ nonempty,
                        const int* __restrict__ pa,
                        const int* __restrict__ pb,
                        const float* __restrict__ vre,
                        const float* __restrict__ vim,
                        const float* __restrict__ c_uv,
                        const float* __restrict__ c_w, CompactTaps ct,
                        Geometry geo, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  if (nonempty != nullptr && nonempty[b] == 0) return;  // uniform

  const int S = geo.support;
  const int Sw = geo.w_support;
  const int lanes = geo.lanes;
  const int stride = win_stride(lanes);
  const int rows = 2 * Sw * kWinRows;
  float* win = smem;                            // [rows][stride]
  float* s_uk = win + rows * stride;            // [kChunk][kMaxS]
  float* s_vk = s_uk + kChunk * kMaxS;          // [kChunk][kMaxS]
  float* s_wv = s_vk + kChunk * kMaxS;          // [kChunk][2][kMaxSw]
  int* s_pos = reinterpret_cast<int*>(s_wv + kChunk * 2 * kMaxSw);
  const int tid = threadIdx.x;

  for (int i = tid; i < rows * stride; i += kThreads) win[i] = 0.0f;

  const int64_t p_begin = static_cast<int64_t>(b) * geo.block_v;
  for (int c0 = 0; c0 < geo.block_v; c0 += kChunk) {
    const int n = min(kChunk, geo.block_v - c0);
    if (tid < n) {
      const int64_t p = p_begin + c0 + tid;
      const int a = pa[p];
      const float re = vre[p];
      const float im = vim[p];
      if (COMPACT) {
        for (int s = 0; s < S; ++s) {
          s_uk[tid * kMaxS + s] = ct.uk_t[s * ct.total + p];
          s_vk[tid * kMaxS + s] = ct.vk_t[s * ct.total + p];
        }
        for (int j = 0; j < Sw; ++j) {
          const float wk = ct.wk_t[j * ct.total + p];
          s_wv[(tid * 2 + 0) * kMaxSw + j] = __fmul_rn(wk, re);
          s_wv[(tid * 2 + 1) * kMaxSw + j] = __fmul_rn(wk, im);
        }
      } else {
        const int w = pb[p];
        float t[kMaxCoef];
        cheb_basis(frac_x((w >> 15) & 32767, geo.inv2_ov), geo.ncoef, t);
        for (int s = 0; s < S; ++s)
          s_uk[tid * kMaxS + s] = cheb_sum(c_uv + s, S, geo.ncoef, t);
        cheb_basis(frac_x(w & 32767, geo.inv2_ov), geo.ncoef, t);
        for (int s = 0; s < S; ++s)
          s_vk[tid * kMaxS + s] = cheb_sum(c_uv + s, S, geo.ncoef, t);
        cheb_basis(frac_x(a & 131071, geo.inv2_wov), geo.ncoef, t);
        for (int j = 0; j < Sw; ++j) {
          const float wk = cheb_sum(c_w + j, Sw, geo.ncoef, t);
          s_wv[(tid * 2 + 0) * kMaxSw + j] = __fmul_rn(wk, re);
          s_wv[(tid * 2 + 1) * kMaxSw + j] = __fmul_rn(wk, im);
        }
      }
      s_pos[2 * tid] = (a >> 17) & 7;  // u_off
      s_pos[2 * tid + 1] = a >> 20;    // iv0
    }
    __syncthreads();

    const int taps = S * S;
    for (int e = tid; e < n * taps; e += kThreads) {
      const int i = e / taps;
      const int su = (e % taps) / S;
      const int sv = e % S;
      const int col = s_pos[2 * i + 1] + sv;
      if (col >= lanes) continue;
      const float uk = s_uk[i * kMaxS + su];
      const float vk = s_vk[i * kMaxS + sv];
      float* cell = win + (s_pos[2 * i] + su) * stride + col;
      for (int h = 0; h < 2; ++h) {
        for (int j = 0; j < Sw; ++j) {
          const float a = __fmul_rn(uk, s_wv[(i * 2 + h) * kMaxSw + j]);
          atomicAdd(cell + (h * Sw + j) * kWinRows * stride,
                    prod<MODE>(a, vk));
        }
      }
    }
    __syncthreads();
  }

  // Flush the window into the task's stack at its (layer, octet) rows.
  const int64_t sub_pad = lanes + 8;
  const int64_t layer_rows = static_cast<int64_t>(geo.num_layers) * sub_pad;
  const int t = t_idx[b];
  const int k0 = k_idx[b];
  const int g8 = 8 * g_idx[b];
  for (int i = tid; i < rows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int c = i % lanes;
    const float x = win[r * stride + c];
    if (x == 0.0f) continue;
    const int h = r / (Sw * kWinRows);
    const int j = (r / kWinRows) % Sw;
    const int rr = r % kWinRows;
    atomicAdd(out + ((2 * static_cast<int64_t>(t) + h) * layer_rows +
                     (k0 + j) * sub_pad + g8 + rr) * lanes + c,
              x);
  }
}

template <int MODE, bool COMPACT>
__global__ void __launch_bounds__(kThreads)
fused_degrid_stack_kernel(const float* __restrict__ stack,
                          const int* __restrict__ t_idx,
                          const int* __restrict__ k_idx,
                          const int* __restrict__ g_idx,
                          const int* __restrict__ nonempty,
                          const int* __restrict__ pa,
                          const int* __restrict__ pb,
                          const float* __restrict__ c_uv,
                          const float* __restrict__ c_w, CompactTaps ct,
                          Geometry geo, int64_t total,
                          float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    threadIdx.x / 32;
  if (p >= total) return;  // uniform across the warp
  const int b = static_cast<int>(p / geo.block_v);
  if (nonempty != nullptr && nonempty[b] == 0) {
    if (lane == 0) {
      out[p] = 0.0f;
      out[total + p] = 0.0f;
    }
    return;
  }
  const int S = geo.support;
  const int Sw = geo.w_support;
  const int lanes = geo.lanes;
  const int a = pa[p];
  const int w = COMPACT ? (1 << 30) : pb[p];  // compact: valid = 1

  // One tap per lane: vk on lanes [0, S), uk on [S, 2S), wk on
  // [2S, 2S + Sw).
  float tap = 0.0f;
  if (COMPACT) {
    if (lane < S) {
      tap = ct.vk_t[lane * ct.total + p];
    } else if (lane < 2 * S) {
      tap = ct.uk_t[(lane - S) * ct.total + p];
    } else if (lane < 2 * S + Sw) {
      tap = ct.wk_t[(lane - 2 * S) * ct.total + p];
    }
  } else if (lane < 2 * S + Sw) {
    float t[kMaxCoef];
    if (lane < S) {
      cheb_basis(frac_x(w & 32767, geo.inv2_ov), geo.ncoef, t);
      tap = cheb_sum(c_uv + lane, S, geo.ncoef, t);
    } else if (lane < 2 * S) {
      cheb_basis(frac_x((w >> 15) & 32767, geo.inv2_ov), geo.ncoef, t);
      tap = cheb_sum(c_uv + lane - S, S, geo.ncoef, t);
    } else {
      cheb_basis(frac_x(a & 131071, geo.inv2_wov), geo.ncoef, t);
      tap = cheb_sum(c_w + lane - 2 * S, Sw, geo.ncoef, t);
    }
  }
  float vk[kMaxS];
#pragma unroll
  for (int sv = 0; sv < kMaxS; ++sv) {
    vk[sv] = __shfl_sync(0xffffffffu, tap, sv < S ? sv : 0);
  }
  const int j = lane / S;
  const int su = lane % S;
  const bool active = lane < Sw * S;
  const float uk = __shfl_sync(0xffffffffu, tap, S + su);
  const float wk = __shfl_sync(0xffffffffu, tap, 2 * S + (active ? j : 0));

  float re = 0.0f;
  float im = 0.0f;
  if (active) {
    const float valid = static_cast<float>(w >> 30);
    const float uw = __fmul_rn(uk, __fmul_rn(wk, valid));
    const int u_off = (a >> 17) & 7;
    const int iv0 = a >> 20;
    const int64_t sub_pad = lanes + 8;
    const int64_t plane = static_cast<int64_t>(geo.num_layers) * sub_pad *
                          lanes;
    const float* cell =
        stack + 2 * static_cast<int64_t>(t_idx[b]) * plane +
        ((k_idx[b] + j) * sub_pad + 8 * g_idx[b] + u_off + su) * lanes + iv0;
    float t0 = 0.0f;
    float t1 = 0.0f;
#pragma unroll
    for (int sv = 0; sv < kMaxS; ++sv) {
      if (sv < S && iv0 + sv < lanes) {
        t0 = __fadd_rn(t0, prod<MODE>(cell[sv], vk[sv]));
        t1 = __fadd_rn(t1, prod<MODE>(cell[plane + sv], vk[sv]));
      }
    }
    re = __fmul_rn(uw, t0);
    im = __fmul_rn(uw, t1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_down_sync(0xffffffffu, re, off);
    im += __shfl_down_sync(0xffffffffu, im, off);
  }
  if (lane == 0) {
    out[p] = re;
    out[total + p] = im;
  }
}

bool geometry_ok(const Geometry& geo, bool compact) {
  return geo.block_v > 0 && geo.support >= 1 && geo.support <= kMaxS &&
         geo.w_support >= 1 && geo.w_support <= kMaxSw &&
         2 * geo.support + geo.w_support <= 32 &&
         (compact || (geo.ncoef >= 2 && geo.ncoef <= kMaxCoef)) &&
         geo.lanes > 0 && geo.num_layers > 0;
}

template <int MODE, bool COMPACT>
cudaError_t launch_grid(unsigned blocks, size_t smem, cudaStream_t s,
                        const int* t_idx, const int* k_idx, const int* g_idx,
                        const int* nonempty, const int* pa, const int* pb,
                        const float* vre, const float* vim, const float* c_uv,
                        const float* c_w, const CompactTaps& ct,
                        const Geometry& geo, float* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_grid_stack_kernel<MODE, COMPACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_grid_stack_kernel<MODE, COMPACT><<<blocks, kThreads, smem, s>>>(
      t_idx, k_idx, g_idx, nonempty, pa, pb, vre, vim, c_uv, c_w, ct, geo,
      out);
  return cudaGetLastError();
}

template <int MODE, bool COMPACT>
cudaError_t launch_degrid(unsigned ctas, cudaStream_t s, const float* stack,
                          const int* t_idx, const int* k_idx,
                          const int* g_idx, const int* nonempty,
                          const int* pa, const int* pb, const float* c_uv,
                          const float* c_w, const CompactTaps& ct,
                          const Geometry& geo, int64_t total, float* out) {
  fused_degrid_stack_kernel<MODE, COMPACT><<<ctas, kThreads, 0, s>>>(
      stack, t_idx, k_idx, g_idx, nonempty, pa, pb, c_uv, c_w, ct, geo,
      total, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). The compact
// kernels run when uk_t is not null: then pb, the fits and nonempty are
// not read (pass null and ncoef 0).
int sdp_torch_fused_grid_stack(const int* t_idx, const int* k_idx,
                               const int* g_idx, const int* nonempty,
                               const int* pa, const int* pb,
                               const float* vre, const float* vim,
                               const float* c_uv, const float* c_w,
                               const float* uk_t, const float* vk_t,
                               const float* wk_t, int ncoef, float inv2_ov,
                               float inv2_wov, int num_blocks, int block_v,
                               int support, int w_support, int lanes,
                               int num_layers, int mode, float* out,
                               void* stream) {
  const Geometry geo{block_v, support, w_support, lanes, num_layers, ncoef,
                     inv2_ov, inv2_wov};
  const bool compact = uk_t != nullptr;
  if (!geometry_ok(geo, compact)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks <= 0) return 0;
  const size_t smem = grid_smem_bytes(w_support, lanes);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CompactTaps ct{uk_t, vk_t, wk_t,
                       static_cast<int64_t>(num_blocks) * block_v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(num_blocks);
#define SDP_GRID(M, C)                                                      \
  launch_grid<M, C>(nb, smem, s, t_idx, k_idx, g_idx, nonempty, pa, pb, vre, \
                    vim, c_uv, c_w, ct, geo, out)
  cudaError_t err;
  switch (mode) {
    case kF32:
      err = compact ? SDP_GRID(kF32, true) : SDP_GRID(kF32, false);
      break;
    case kHigh:
      err = compact ? SDP_GRID(kHigh, true) : SDP_GRID(kHigh, false);
      break;
    case kBf16:
      err = compact ? SDP_GRID(kBf16, true) : SDP_GRID(kBf16, false);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDP_GRID
  return static_cast<int>(err);
}

int sdp_torch_fused_degrid_stack(const float* stack, const int* t_idx,
                                 const int* k_idx, const int* g_idx,
                                 const int* nonempty, const int* pa,
                                 const int* pb, const float* c_uv,
                                 const float* c_w, const float* uk_t,
                                 const float* vk_t, const float* wk_t,
                                 int ncoef, float inv2_ov, float inv2_wov,
                                 int64_t total, int block_v, int support,
                                 int w_support, int lanes, int num_layers,
                                 int mode, float* out, void* stream) {
  const Geometry geo{block_v, support, w_support, lanes, num_layers, ncoef,
                     inv2_ov, inv2_wov};
  const bool compact = uk_t != nullptr;
  if (!geometry_ok(geo, compact)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total <= 0) return 0;
  constexpr int per_cta = kThreads / 32;
  const unsigned ctas = static_cast<unsigned>((total + per_cta - 1) / per_cta);
  const CompactTaps ct{uk_t, vk_t, wk_t, total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDP_DEGRID(M, C)                                                     \
  launch_degrid<M, C>(ctas, s, stack, t_idx, k_idx, g_idx, nonempty, pa, pb, \
                      c_uv, c_w, ct, geo, total, out)
  cudaError_t err;
  switch (mode) {
    case kF32:
      err = compact ? SDP_DEGRID(kF32, true) : SDP_DEGRID(kF32, false);
      break;
    case kHigh:
      err = compact ? SDP_DEGRID(kHigh, true) : SDP_DEGRID(kHigh, false);
      break;
    case kBf16:
      err = compact ? SDP_DEGRID(kBf16, true) : SDP_DEGRID(kBf16, false);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDP_DEGRID
  return static_cast<int>(err);
}

}  // extern "C"
