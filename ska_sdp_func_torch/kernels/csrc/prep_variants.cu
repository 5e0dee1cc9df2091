// Stage sweep of the streaming tap preparation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of experiments/exp_prep.py (variant(mode),
// body kern): over CAP slots, from the plan fields u_off, u_frac, w_row,
// iv0, v_frac [CAP] int32 and vre, vim [CAP] f32,
//   ub [16][CAP]:  ub[u_off + s][p] = uk[p][s]          (zero elsewhere)
//   vb [CAP][128]: vb[p][iv0 + s]   = vk[p][s]          (zero elsewhere)
//   sc [2 Sw][CAP]: sc[j][p] = wk[p][j] vre[p], sc[Sw + j][p] = wk[p][j] vim[p]
// with S = 8, Sw = 4 and the taps by Clenshaw's recurrence (taps.cuh, in
// the order of K6 and of the plain version). Five modes, a template
// parameter each, with no runtime branch on the mode inside:
//   full      every stage;
//   novband   ub and sc (vb written as zeros);
//   vbonly    vb (ub and sc zeros);
//   vbnochb   vb with every tap float(v_frac) (no Clenshaw), ub and sc zeros;
//   ubonly    ub (vb and sc zeros).
// Every mode writes all three outputs, as the TPU kernel does, so their
// bytes are nearly the same and the modes differ in compute and store
// pattern: the experiment asks which stage of K6/K7 costs the time.
//
// What bounds it on an H100: the stores, 608 B a slot (vb 512, ub 64, sc
// 32) against 28 B of reads: 3.74 GB at the experiment's CAP = 5,872,640,
// 1.12 ms at 3.35 TB/s. The design: one thread a slot evaluates its taps;
// ub and sc rows are written by consecutive threads at consecutive slots
// (coalesced); the slot's v taps and iv0 go to shared memory, and each
// warp then writes whole 512 B vb rows, a float4 a lane.

#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

enum PrepMode { kFull = 0, kNoVband = 1, kVbOnly = 2, kVbNoChb = 3,
                kUbOnly = 4 };

constexpr int kThreads = 256;
constexpr int kS = 8;
constexpr int kSw = 4;
constexpr int kRows = 16;
constexpr int kLanes = 128;
constexpr int kMaxCoeffs = 16;

struct VariantArgs {
  const int* u_off;
  const int* u_frac;
  const int* w_row;
  const float* vre;
  const float* vim;
  const int* iv0;
  const int* v_frac;
  const float* uv_coeffs;   // [ncoef][S]
  const float* w_coeffs;    // [ncoef][Sw]
  int ncoef;
  float inv2_ov, inv2_wov;
  int64_t cap;
  float* ub;                // [16][cap]
  float* vb;                // [cap][128]
  float* sc;                // [2 Sw][cap]
};

template <int MODE>
__global__ void __launch_bounds__(kThreads)
prep_variant_kernel(VariantArgs a) {
  constexpr bool kUb = MODE == kFull || MODE == kNoVband || MODE == kUbOnly;
  constexpr bool kSc = MODE == kFull || MODE == kNoVband;
  constexpr bool kVb = MODE == kFull || MODE == kVbOnly || MODE == kVbNoChb;
  __shared__ float c_uv[kMaxCoeffs * kS];
  __shared__ float c_w[kMaxCoeffs * kSw];
  __shared__ float vk_s[kThreads][kS + 1];
  __shared__ int iv_s[kThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < a.ncoef * kS; i += kThreads) c_uv[i] = a.uv_coeffs[i];
  for (int i = tid; i < a.ncoef * kSw; i += kThreads) c_w[i] = a.w_coeffs[i];
  __syncthreads();
  const int64_t cap = a.cap;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t p = p0 + tid;
  if (p < cap) {
    float uk[kS] = {};
    int uo = 0;
    if (kUb) {
      clenshaw(a.u_frac[p], a.inv2_ov, c_uv, a.ncoef, kS, uk, 1);
      uo = a.u_off[p];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = 0.0f;
      if (kUb) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          if (r == uo + s) v = uk[s];
        }
      }
      a.ub[r * cap + p] = v;
    }
    float wk[kSw] = {};
    float re = 0.0f;
    float im = 0.0f;
    if (kSc) {
      clenshaw(a.w_row[p], a.inv2_wov, c_w, a.ncoef, kSw, wk, 1);
      re = a.vre[p];
      im = a.vim[p];
    }
#pragma unroll
    for (int j = 0; j < kSw; ++j) {
      a.sc[j * cap + p] = kSc ? __fmul_rn(wk[j], re) : 0.0f;
      a.sc[(kSw + j) * cap + p] = kSc ? __fmul_rn(wk[j], im) : 0.0f;
    }
    if (kVb) {
      if (MODE == kVbNoChb) {
        const float f = static_cast<float>(a.v_frac[p]);
#pragma unroll
        for (int s = 0; s < kS; ++s) vk_s[tid][s] = f;
      } else {
        float vk[kS];
        clenshaw(a.v_frac[p], a.inv2_ov, c_uv, a.ncoef, kS, vk, 1);
#pragma unroll
        for (int s = 0; s < kS; ++s) vk_s[tid][s] = vk[s];
      }
      iv_s[tid] = a.iv0[p];
    }
  }
  __syncthreads();
  // vb: warp w writes the rows of slots w, w + 8, ..., a float4 a lane.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t = warp; t < kThreads; t += kThreads / 32) {
    const int64_t q = p0 + t;
    if (q >= cap) break;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kVb) {
      const int d0 = 4 * lane - iv_s[t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + e;
        if (static_cast<unsigned>(d) < static_cast<unsigned>(kS)) {
          o[e] = vk_s[t][d];
        }
      }
    }
    reinterpret_cast<float4*>(a.vb + q * kLanes)[lane] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). mode: 0 full,
// 1 novband, 2 vbonly, 3 vbnochb, 4 ubonly. Every output is written.
int sdp_torch_prep_variant(int mode, const int* u_off, const int* u_frac,
                           const int* w_row, const float* vre,
                           const float* vim, const int* iv0,
                           const int* v_frac, const float* uv_coeffs,
                           const float* w_coeffs, int ncoef, float inv2_ov,
                           float inv2_wov, int64_t cap, float* ub, float* vb,
                           float* sc, void* stream) {
  if (mode < kFull || mode > kUbOnly || ncoef < 1 || ncoef > kMaxCoeffs ||
      cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap == 0) return 0;
  const VariantArgs a{u_off, u_frac, w_row, vre, vim, iv0, v_frac,
                      uv_coeffs, w_coeffs, ncoef, inv2_ov, inv2_wov, cap,
                      ub, vb, sc};
  const unsigned ctas = static_cast<unsigned>((cap + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      prep_variant_kernel<kFull><<<ctas, kThreads, 0, s>>>(a);
      break;
    case kNoVband:
      prep_variant_kernel<kNoVband><<<ctas, kThreads, 0, s>>>(a);
      break;
    case kVbOnly:
      prep_variant_kernel<kVbOnly><<<ctas, kThreads, 0, s>>>(a);
      break;
    case kVbNoChb:
      prep_variant_kernel<kVbNoChb><<<ctas, kThreads, 0, s>>>(a);
      break;
    default:
      prep_variant_kernel<kUbOnly><<<ctas, kThreads, 0, s>>>(a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
