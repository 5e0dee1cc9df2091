// Device helpers shared by the kernels that evaluate Chebyshev kernel taps
// or take their products in one of the three precision modes
// (window.cuh, window_gather.cu, window_scatter.cu, stream_prep.cu,
// prep_variants.cu).
//
// Modes: kF32 the f32 product a * b ("highest"); kHigh the bf16 hi/lo
// halves hi*hi + (hi*lo + lo*hi), each product exact in f32 (the TPU's
// bf16-in, f32-accumulate dots, "high"); kBf16 bf16-rounded factors
// ("bf16"). Taps: tap[s] = sum_d c[d][s] T_d(x), x = (2 / ov) frac - 1,
// T_d by the three-term recurrence. Every operation is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, never contracted into an FMA), in the
// order of the plain PyTorch versions, so both evaluate identical taps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { kF32 = 0, kHigh = 1, kBf16 = 2 };

constexpr int kMaxCoef = 16;

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

// Clenshaw's backward recurrence of the Chebyshev fit c[d][s] (n taps a
// row), the Pallas kernels' _clenshaw_rows: tap s at x is
//   b1 = c[k][s] + (2x) b1 - b2 for k = ncoef - 1 .. 1, then c[0][s] + x b1 - b2.
__device__ __forceinline__ float clenshaw_at(float x, const float* c,
                                             int ncoef, int n, int s) {
  const float two_x = __fmul_rn(2.0f, x);
  float b1 = 0.0f;
  float b2 = 0.0f;
  for (int k = ncoef - 1; k >= 1; --k) {
    const float b = __fsub_rn(__fadd_rn(c[k * n + s], __fmul_rn(two_x, b1)),
                              b2);
    b2 = b1;
    b1 = b;
  }
  return __fsub_rn(__fadd_rn(c[s], __fmul_rn(x, b1)), b2);
}

// The n taps of one slot at x = inv2 * row - 1: out[s * out_stride].
__device__ __forceinline__ void clenshaw(int row, float inv2,
                                         const float* c, int ncoef, int n,
                                         float* out, int64_t out_stride) {
  const float x = __fsub_rn(__fmul_rn(inv2, static_cast<float>(row)), 1.0f);
  for (int s = 0; s < n; ++s) {
    out[s * out_stride] = clenshaw_at(x, c, ncoef, n, s);
  }
}

}  // namespace
