// Per-chunk tap preparation of the streaming engine's non-packable branch
// for Hopper (sm_90a): placed plan fields -> compact taps and w scales.
//
// Replaces two Pallas TPU kernels of ska_sdp_func_tpu/kernels/packed_tap.py:
//   - stream_prep_grid_pallas (_stream_prep_grid_kernel)
//                                     -> stream_prep_kernel<true, BF16>
//   - stream_prep_degrid_pallas (_stream_prep_degrid_kernel)
//                                     -> stream_prep_kernel<false, BF16>
//
// Per slot p of the placed stream (layout shared with the plain PyTorch
// versions in stream_prep.py):
//   uk[p][s] = C_uv(s, x(u_frac[p], ov)),  vk[p][s] = C_uv(s, x(v_frac[p], ov)),
//   wk[j]    = C_w(j, x(w_row[p], w_ov)),  x(f, ov) = (2 / ov) f - 1,
// with C the Clenshaw backward recurrence of the Chebyshev fit c[d][s]
// (the Pallas kernels' _clenshaw_rows):
//   b1 = c[k][s] + (2x) b1 - b2 for k = degree .. 1, then c[0][s] + x b1 - b2.
// Every operation is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, never contracted into an FMA), in the order of the plain
// versions, so both evaluate identical taps.
//   grid:   scales[j][p] = wk[j] * vre[p], scales[Sw + j][p] = wk[j] * vim[p];
//   degrid: wk_t[j][p]   = wk[j] * valid[p].
// In the bf16 mode (the streaming engine's fast mode) vk is stored as bf16,
// each tap rounded once to nearest even, as the Pallas kernels store their
// v-band in bf16 (packed_tap.py:521, :639); uk and the w scales stay f32.
// The Pallas kernels also place the taps into dense bands (ubase [16, V],
// vband [V, lanes], 1 KiB per slot); the port's band kernels (band_tap.cu)
// read the compact taps, so no band is built here.
//
// What bounds it on an H100, and the design. A fused elementwise pass: 20 B
// in and 96 B out per slot at S = 8, Sw = 4 grid (88 B degrid), against
// ~45 f32 operations per tap; at the dense stream's 5.9M slots that is
// ~0.2 ms of device-memory traffic and ~0.08 ms of f32 work, so bytes bound
// it (the bf16 vk saves 16 B of the output per slot). One thread per slot,
// the coefficient tables in shared memory; the scale rows are written
// coalesced, each slot's S taps as one 32 B (bf16: 16 B) run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 8;
constexpr int kMaxSw = 8;
constexpr int kMaxCoeffs = 16;

struct PrepArgs {
  const int* u_frac;
  const int* v_frac;
  const int* w_row;
  const float* vre;     // grid: [total]
  const float* vim;     // grid: [total]
  const float* valid;   // degrid: [total], 1 or 0
  const float* uv_coeffs;  // [ncoef][S]
  const float* w_coeffs;   // [ncoef][Sw]
  int ncoef, support, w_support;
  float inv2_ov, inv2_wov;
  int64_t total;
  float* uk;            // [total][S]
  void* vk;             // [total][S], f32 or bf16
  float* wk;            // grid: scales [2 Sw][total]; degrid: wk_t [Sw][total]
};

template <bool kGrid, bool kBf16>
__global__ void __launch_bounds__(kThreads) stream_prep_kernel(PrepArgs a) {
  __shared__ float c_uv[kMaxCoeffs * kMaxS];
  __shared__ float c_w[kMaxCoeffs * kMaxSw];
  const int S = a.support;
  const int Sw = a.w_support;
  for (int i = threadIdx.x; i < a.ncoef * S; i += kThreads) {
    c_uv[i] = a.uv_coeffs[i];
  }
  for (int i = threadIdx.x; i < a.ncoef * Sw; i += kThreads) {
    c_w[i] = a.w_coeffs[i];
  }
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= a.total) return;
  clenshaw(a.u_frac[p], a.inv2_ov, c_uv, a.ncoef, S, a.uk + p * S, 1);
  if (kBf16) {
    float vk[kMaxS];
    clenshaw(a.v_frac[p], a.inv2_ov, c_uv, a.ncoef, S, vk, 1);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.vk) + p * S;
    for (int s = 0; s < S; ++s) out[s] = __float2bfloat16_rn(vk[s]);
  } else {
    clenshaw(a.v_frac[p], a.inv2_ov, c_uv, a.ncoef, S,
             static_cast<float*>(a.vk) + p * S, 1);
  }
  float wk[kMaxSw];
  clenshaw(a.w_row[p], a.inv2_wov, c_w, a.ncoef, Sw, wk, 1);
  if (kGrid) {
    const float re = a.vre[p];
    const float im = a.vim[p];
    for (int j = 0; j < Sw; ++j) {
      a.wk[j * a.total + p] = __fmul_rn(wk[j], re);
      a.wk[(Sw + j) * a.total + p] = __fmul_rn(wk[j], im);
    }
  } else {
    const float valid = a.valid[p];
    for (int j = 0; j < Sw; ++j) {
      a.wk[j * a.total + p] = __fmul_rn(wk[j], valid);
    }
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). Grid: vre and vim
// given, valid null, `wk` the [2 Sw][total] scale stack. Degrid: valid
// given, vre and vim null, `wk` the [Sw][total] masked w taps. With
// `vk_bf16`, vk is bf16.
int sdp_torch_stream_prep(const int* u_frac, const int* v_frac,
                          const int* w_row, const float* vre, const float* vim,
                          const float* valid, const float* uv_coeffs,
                          const float* w_coeffs, int ncoef, int support,
                          int w_support, float inv2_ov, float inv2_wov,
                          int64_t total, float* uk, void* vk, float* wk,
                          int vk_bf16, void* stream) {
  const bool grid = vre != nullptr && vim != nullptr && valid == nullptr;
  const bool degrid = vre == nullptr && vim == nullptr && valid != nullptr;
  if ((!grid && !degrid) || support < 1 || support > kMaxS ||
      w_support < 1 || w_support > kMaxSw || ncoef < 1 ||
      ncoef > kMaxCoeffs || total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  const PrepArgs a{u_frac, v_frac, w_row, vre, vim, valid, uv_coeffs,
                   w_coeffs, ncoef, support, w_support, inv2_ov, inv2_wov,
                   total, uk, vk, wk};
  const unsigned ctas = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid) {
    if (vk_bf16) {
      stream_prep_kernel<true, true><<<ctas, kThreads, 0, s>>>(a);
    } else {
      stream_prep_kernel<true, false><<<ctas, kThreads, 0, s>>>(a);
    }
  } else if (vk_bf16) {
    stream_prep_kernel<false, true><<<ctas, kThreads, 0, s>>>(a);
  } else {
    stream_prep_kernel<false, false><<<ctas, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
