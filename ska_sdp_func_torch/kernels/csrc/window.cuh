// What the window kernels share: window_gather.cu (the degrid forms K4,
// K11, K13, K19) and window_scatter.cu (the grid forms K3, K8, K12, K18)
// walk the same bucket-run work units over the same four tap forms, keep a
// bucket's window in shared memory at the same row stride, and evaluate
// the word forms' taps with the same Chebyshev chain stage.
//
// A window is 2 Sw slabs (or planes) of kRows rows, slab (h, j) the half h
// (0 real, 1 imaginary) of w-plane j; a slot's taps cover rows
// u_off .. u_off + S - 1 and columns iv0 .. iv0 + S - 1 of each slab.
// In shared memory a slab row is padded to round_up(width, 32) + 8 floats
// (window_stride), so the row stride is 8 banks mod 32: lanes
// (q, sv) = (lane / 8, lane % 8) on cells (u_off + q, iv0 + sv) of one
// slot fall on 32 distinct banks, and the 8 padding columns take the taps
// past the window's right edge.

#pragma once

#include "taps.cuh"

namespace {

enum Form { kStackWords = 0, kStackTaps = 1, kBandTaps = 2, kBandWords = 3 };

constexpr int kRows = 16;                      // rows of a slab
constexpr int kMaxS = 8;
constexpr int kMaxSw = 8;
static_assert(kMaxS == kMaxSw, "the tap stage and fits share one width");
constexpr int kMaxStackSw = 4;                 // the stack and word forms'
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory row stride (floats) of a window `width` columns wide.
__host__ __device__ __forceinline__ int window_stride(int width) {
  return (width + 31) / 32 * 32 + 8;
}

// -- the word forms' taps -----------------------------------------------------

// The word forms' tap fits, copied into shared memory once a CTA: zero past
// ncoef rows and past S / Sw columns (kMaxS == kMaxSw columns each).
struct Fits {
  float uv[kMaxCoef][kMaxS];
  float w[kMaxCoef][kMaxSw];
};

// Threads `tid` of `nthreads` copy the fits c_uv [ncoef][S] and c_w
// [ncoef][Sw] into `f`.
__device__ __forceinline__ void load_fits(Fits* f, const float* c_uv,
                                          const float* c_w, int ncoef,
                                          int support, int w_support,
                                          int tid, int nthreads) {
  for (int e = tid; e < kMaxCoef * kMaxS; e += nthreads) {
    const int d = e / kMaxS;
    const int c = e % kMaxS;
    f->uv[d][c] = d < ncoef && c < support ? c_uv[d * support + c] : 0.0f;
    f->w[d][c] = d < ncoef && c < w_support ? c_w[d * w_support + c] : 0.0f;
  }
}

// The next Chebyshev basis term: T_d = 2x T_{d-1} - T_{d-2} (taps.cuh's
// cheb_basis, each operation rounded on its own, without the array);
// (prev, cur) = (T_{d-2}, T_{d-1}) become (T_{d-1}, T_d).
__device__ __forceinline__ float cheb_next(float two_x, float& prev,
                                           float& cur) {
  const float t = __fsub_rn(__fmul_rn(two_x, cur), prev);
  prev = cur;
  cur = t;
  return t;
}

// A slot's taps from the words' three Chebyshev arguments: vk[s], uk[s]
// (the uv fit) and wk[j] (the w fit) = sum_d c[d][.] T_d(x), each one
// taps.cuh's cheb_sum of cheb_basis, every operation rounded on its own
// in its order (so the taps equal the plain versions'). The 24 sums are
// independent chains, and each coefficient row is loaded before the
// previous one is used, so the shared-memory latency hides behind the
// arithmetic. Taps past S / Sw are zero (the fits are zero there).
__device__ __forceinline__ void cheb_taps3(const Fits& f, int ncoef,
                                           float xv, float xu, float xw,
                                           float (&vk)[kMaxS],
                                           float (&uk)[kMaxS],
                                           float (&wk)[kMaxSw]) {
  const float two_v = __fmul_rn(2.0f, xv);
  const float two_u = __fmul_rn(2.0f, xu);
  const float two_w = __fmul_rn(2.0f, xw);
  float pv = 1.0f, pu = 1.0f, pw = 1.0f;   // T_{d-2}
  float cv = xv, cu = xu, cwt = xw;        // T_{d-1}
  float cuv[kMaxS];
  float cw[kMaxSw];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    vk[s] = __fmul_rn(f.uv[0][s], 1.0f);
    uk[s] = __fmul_rn(f.uv[0][s], 1.0f);
    wk[s] = __fmul_rn(f.w[0][s], 1.0f);
    cuv[s] = f.uv[1][s];
    cw[s] = f.w[1][s];
  }
#pragma unroll
  for (int d = 1; d < kMaxCoef; ++d) {
    if (d >= ncoef) break;
    const float tv = d == 1 ? xv : cheb_next(two_v, pv, cv);
    const float tu = d == 1 ? xu : cheb_next(two_u, pu, cu);
    const float tw = d == 1 ? xw : cheb_next(two_w, pw, cwt);
    const int dn = d + 1 < kMaxCoef ? d + 1 : d;   // the last re-reads its row
    float nuv[kMaxS];
    float nw[kMaxSw];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      nuv[s] = f.uv[dn][s];
      nw[s] = f.w[dn][s];
    }
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      vk[s] = __fadd_rn(vk[s], __fmul_rn(cuv[s], tv));
      uk[s] = __fadd_rn(uk[s], __fmul_rn(cuv[s], tu));
      wk[s] = __fadd_rn(wk[s], __fmul_rn(cw[s], tw));
      cuv[s] = nuv[s];
      cw[s] = nw[s];
    }
  }
}

// The words' taps of one slot: (vk, uk, wk) from pb's (v_frac, u_frac)
// and pa's w_row.
__device__ __forceinline__ void word_taps(const Fits& f, int ncoef,
                                          float inv2_ov, float inv2_wov,
                                          int wa, int wb, float (&vk)[kMaxS],
                                          float (&uk)[kMaxS],
                                          float (&wk)[kMaxSw]) {
  cheb_taps3(f, ncoef, frac_x(wb & 32767, inv2_ov),
             frac_x((wb >> 15) & 32767, inv2_ov),
             frac_x(wa & 131071, inv2_wov), vk, uk, wk);
}

// The v tap as a kernel stages it: bf16-rounded in kBf16 (the taps' side of
// every product), else as it is.
template <int MODE>
__device__ __forceinline__ float stage_v(float v) {
  return MODE == kBf16 ? round_bf16(v) : v;
}

// -- host checks ----------------------------------------------------------------

bool common_ok(int num_runs, int64_t total, int block_v, int support,
               int w_support, int max_sw) {
  return num_runs >= 0 && total >= 0 && block_v > 0 && support >= 1 &&
         support <= kMaxS && w_support >= 1 && w_support <= max_sw;
}

bool words_ok(int support, int w_support, int ncoef) {
  return 2 * support + w_support <= 32 && ncoef >= 2 && ncoef <= kMaxCoef;
}

}  // namespace
