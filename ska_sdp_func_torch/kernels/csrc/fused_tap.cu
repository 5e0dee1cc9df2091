// Fused and compact packed gridding kernels for Hopper (sm_90a): per-task
// stacks from a placed stream of slots whose taps are either evaluated in
// the kernel from two bit-packed int32 plan words per slot (fused), or
// pre-evaluated once per plan and read per slot beside the word pa
// (compact).
//
// Replace the grid stack forms of the Pallas TPU kernels in
// ska_sdp_func_tpu/kernels/fused_tap.py:
//   - grid_fused_stack_pallas (_grid_stack_kernel, _block_contrib,
//     _prep_common, _stack_accumulate)  -> fused_grid_stack_kernel<M, false>
//   - grid_compact_pallas (_grid_compact_kernel)
//                                     -> fused_grid_stack_kernel<M, true>
// Their degrid twins (degrid_fused2_stack_pallas, degrid_compact_pallas:
// the degrid below) are window_gather.cu's window_gather_kernel<M,
// kStackWords> and <M, kStackTaps>.
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
// T_d by the three-term recurrence (taps.cuh, shared with band_tap.cu);
// every operation is rounded on its own, in the order the plain versions
// use, so both evaluate identical taps. Stacks are
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

#include "taps.cuh"

namespace {

constexpr int kWinRows = 16;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // slots whose taps are staged at once
constexpr int kMaxS = 8;
constexpr int kMaxSw = 4;
constexpr int kMaxSmem = 227 * 1024;

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

}  // extern "C"
