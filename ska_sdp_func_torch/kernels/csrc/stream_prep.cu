// Per-chunk tap preparation of the streaming engine's non-packable branch
// for Hopper (sm_90a): placed plan fields -> compact taps and w scales.
//
// Replaces two Pallas TPU kernels of ska_sdp_func_tpu/kernels/packed_tap.py:
//   - stream_prep_grid_pallas (_stream_prep_grid_kernel)
//                        -> stream_prep_kernel<true, BF16, NCOEF, S>
//   - stream_prep_degrid_pallas (_stream_prep_degrid_kernel)
//                        -> stream_prep_kernel<false, BF16, NCOEF, S>
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
// vband [V, lanes], 1 KiB per slot); the port's window kernels
// (window_scatter.cu, window_gather.cu) read the compact taps, so no band
// is built here.
//
// What bounds it on an H100. A fused elementwise pass: 20 B in and 96 B
// out per slot at S = 8, Sw = 4 grid (88 B degrid; the bf16 vk saves 16 B),
// ~0.2 ms of device-memory traffic at the dense stream's 5.9M slots. Its
// f32 work is 2S + Sw Clenshaw chains of ncoef - 1 steps a slot (3
// operations a step), below the bytes even at the unfused rate; what it
// costs is instruction issue, so the chains must carry no more than their
// arithmetic. The stores must fill whole sectors: one thread a slot
// storing its S taps puts a warp's lanes 32 B apart.
//
// The design. Persistent CTAs of 256 threads walk tiles of 256 slots:
//   A. a thread a slot reads the slot's fields (coalesced), stages the
//      three Chebyshev arguments x in shared memory and keeps its
//      visibility (grid) or validity (degrid) in registers;
//   B. a thread a (slot, tap): lane s of an 8-lane group evaluates uk[s]
//      and vk[s] of its slot, two independent chains on one coefficient
//      column; uk[p S + s] and vk[p S + s] are contiguous across a warp,
//      so each store instruction writes 4 slots' 128 B (bf16: 64 B) of
//      whole sectors;
//   B'. a thread a (slot, w tap) evaluates wk[j] into shared memory, every
//      lane busy (the lanes s < Sw of pass B would leave the others idle
//      through the w chain; PERF.md has both forms' times);
//   C. a thread a slot multiplies its w taps by its visibility and writes
//      each of the 2 Sw (Sw) scale rows as one contiguous run of the tile:
//      128 B a warp and row.
// The unrolled instance (NCOEF = 12, S = 8, Sw a power of two: the
// streaming paths' fits, degree 11, support 8 and w support 4) keeps each
// thread's two coefficient columns in registers for the CTA's life (a
// thread's taps s and j are the same in every tile and pass) and unrolls
// the chains over the compile-time count: three operations a step, no
// load and no loop counter. The generic instance (NCOEF = S = 0: any
// ncoef <= 16, S <= 8, Sw <= 8) stages the fits in shared memory, loads a
// column into registers before each chain and runs the chain unrolled to
// 16 steps, those past ncoef skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;                // slots a tile
constexpr int kMaxS = 8;
constexpr int kMaxSw = 8;
// w-tap rows in shared memory: row j at j * (kTile + pad), pad = 32 / Sw
// rounded up to a power of two, so the lanes (slot q, tap j) of a warp
// land on banks pad j + q, all distinct where Sw is a power of two.
constexpr int kWkRows = kMaxSw * (kTile + 32);
// The unrolled instance's fits: ncoef (degree + 1) and support (and a w
// support that is a power of two).
constexpr int kUnrolledNcoef = 12;
constexpr int kUnrolledS = 8;

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

// Clenshaw's recurrence at x on the coefficient column c (registers): c[k]
// for k < NC; with kSkip the steps k >= ncoef are skipped (the generic
// instance, NC = kMaxCoef). The operations and their order are
// taps.cuh's clenshaw_at.
template <int NC, bool kSkip>
__device__ __forceinline__ float chain(float x, float two_x,
                                       const float (&c)[NC], int ncoef) {
  float b1 = 0.0f;
  float b2 = 0.0f;
#pragma unroll
  for (int k = NC - 1; k >= 1; --k) {
    if (!kSkip || k < ncoef) {
      const float b = __fsub_rn(__fadd_rn(c[k], __fmul_rn(two_x, b1)), b2);
      b2 = b1;
      b1 = b;
    }
  }
  return __fsub_rn(__fadd_rn(c[0], __fmul_rn(x, b1)), b2);
}

// Column `col` of the fit c [ncoef][n] into registers (zero past ncoef).
template <int NC>
__device__ __forceinline__ void load_column(float (&out)[NC], const float* c,
                                            int ncoef, int n, int col) {
#pragma unroll
  for (int k = 0; k < NC; ++k) out[k] = k < ncoef ? c[k * n + col] : 0.0f;
}

template <bool kGrid, bool kBf16, int NCOEF, int SUP>
__global__ void __launch_bounds__(kThreads) stream_prep_kernel(PrepArgs a) {
  constexpr bool kGeneric = NCOEF == 0;
  constexpr int NC = kGeneric ? kMaxCoef : NCOEF;
  static_assert(kGeneric == (SUP == 0), "an instance is unrolled or generic");
  static_assert(kGeneric || kThreads % (SUP > 0 ? SUP : 1) == 0,
                "a thread's tap must be the same in every pass");
  __shared__ float x_s[3][kTile];         // x of u_frac, v_frac, w_row
  __shared__ float wk_s[kWkRows];
  __shared__ float fits_s[2][kGeneric ? kMaxCoef * kMaxS : 1];

  const int tid = threadIdx.x;
  const int S = kGeneric ? a.support : SUP;
  const int Sw = a.w_support;
  const int ncoef = kGeneric ? a.ncoef : NCOEF;

  int sw_pow2 = 1;
  int sw_shift = 0;
  while (sw_pow2 < Sw) {
    sw_pow2 *= 2;
    ++sw_shift;
  }
  const int wk_stride = kTile + 32 / sw_pow2;
  // The unrolled instance (Sw a power of two): this thread's uv tap s and
  // w tap j, and their columns, for good.
  const int s_fixed = kGeneric ? 0 : tid % SUP;
  const int j_fixed = kGeneric ? 0 : tid & (Sw - 1);
  float cu[NC];
  float cw[NC];
  if constexpr (!kGeneric) {
    load_column(cu, a.uv_coeffs, NC, SUP, s_fixed);
    load_column(cw, a.w_coeffs, NC, Sw, j_fixed);
  } else {
    for (int e = tid; e < ncoef * S; e += kThreads) {
      fits_s[0][e] = a.uv_coeffs[e];
    }
    for (int e = tid; e < ncoef * Sw; e += kThreads) {
      fits_s[1][e] = a.w_coeffs[e];
    }
  }

  const int64_t tiles = (a.total + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile;
    const int n = static_cast<int>(
        a.total - base < kTile ? a.total - base : kTile);

    // A. a thread a slot: the three arguments and the factors of its
    // scale rows (grid: vre, vim; degrid: re is the validity).
    float re = 0.0f;
    float im = 0.0f;
    if (tid < n) {
      const int64_t p = base + tid;
      x_s[0][tid] = frac_x(a.u_frac[p], a.inv2_ov);
      x_s[1][tid] = frac_x(a.v_frac[p], a.inv2_ov);
      x_s[2][tid] = frac_x(a.w_row[p], a.inv2_wov);
      if constexpr (kGrid) {
        re = a.vre[p];
        im = a.vim[p];
      } else {
        re = a.valid[p];
      }
    }
    __syncthreads();  // x_s staged (and, first tile, the generic fits)

    // B. a thread a (slot, tap): uk, vk to memory.
    const int ne = n * S;
    float* uk = a.uk + base * S;
#pragma unroll 2
    for (int e = tid; e < ne; e += kThreads) {
      const int q = kGeneric ? e / S : e / SUP;
      const int s = kGeneric ? e - q * S : s_fixed;
      const float xu = x_s[0][q];
      const float xv = x_s[1][q];
      float u, v;
      if constexpr (kGeneric) {
        load_column(cu, fits_s[0], ncoef, S, s);
        u = chain<NC, true>(xu, __fmul_rn(2.0f, xu), cu, ncoef);
        v = chain<NC, true>(xv, __fmul_rn(2.0f, xv), cu, ncoef);
      } else {
        u = chain<NC, false>(xu, __fmul_rn(2.0f, xu), cu, ncoef);
        v = chain<NC, false>(xv, __fmul_rn(2.0f, xv), cu, ncoef);
      }
      uk[e] = u;
      if constexpr (kBf16) {
        static_cast<__nv_bfloat16*>(a.vk)[base * S + e] =
            __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(a.vk)[base * S + e] = v;
      }
    }
    // B'. a thread a (slot, w tap), every lane busy: wk to shared memory.
    const int nw = n * Sw;
#pragma unroll 2
    for (int e = tid; e < nw; e += kThreads) {
      const int q = kGeneric ? e / Sw : e >> sw_shift;
      const int j = kGeneric ? e - q * Sw : j_fixed;
      const float xw = x_s[2][q];
      float w;
      if constexpr (kGeneric) {
        load_column(cw, fits_s[1], ncoef, Sw, j);
        w = chain<NC, true>(xw, __fmul_rn(2.0f, xw), cw, ncoef);
      } else {
        w = chain<NC, false>(xw, __fmul_rn(2.0f, xw), cw, ncoef);
      }
      wk_s[j * wk_stride + q] = w;
    }
    __syncthreads();  // wk_s complete; x_s free for the next tile

    // C. a thread a slot: the scale rows, each a contiguous run.
    if (tid < n) {
      float* row = a.wk + base + tid;
      for (int j = 0; j < Sw; ++j) {
        const float w = wk_s[j * wk_stride + tid];
        if constexpr (kGrid) {
          row[j * a.total] = __fmul_rn(w, re);
          row[(Sw + j) * a.total] = __fmul_rn(w, im);
        } else {
          row[j * a.total] = __fmul_rn(w, re);
        }
      }
    }
    // The next tile's phase A writes only x_s, which every thread has
    // finished reading; its first barrier orders wk_s's reuse after C.
  }
}

bool unrolled(int ncoef, int support, int w_support) {
  return ncoef == kUnrolledNcoef && support == kUnrolledS &&
         (w_support & (w_support - 1)) == 0;
}

template <bool kGrid, bool kBf16, int NCOEF, int SUP>
int launch(const PrepArgs& a, cudaStream_t s) {
  auto kernel = stream_prep_kernel<kGrid, kBf16, NCOEF, SUP>;
  cudaError_t err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (a.total + kTile - 1) / kTile;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  const unsigned ctas = static_cast<unsigned>(tiles < most ? tiles : most);
  kernel<<<ctas, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrid, bool kBf16>
int launch_fits(const PrepArgs& a, cudaStream_t s) {
  return unrolled(a.ncoef, a.support, a.w_support)
             ? launch<kGrid, kBf16, kUnrolledNcoef, kUnrolledS>(a, s)
             : launch<kGrid, kBf16, 0, 0>(a, s);
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
      ncoef > kMaxCoef || total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  const PrepArgs a{u_frac, v_frac, w_row, vre, vim, valid, uv_coeffs,
                   w_coeffs, ncoef, support, w_support, inv2_ov, inv2_wov,
                   total, uk, vk, wk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid) {
    return vk_bf16 ? launch_fits<true, true>(a, s)
                   : launch_fits<true, false>(a, s);
  }
  return vk_bf16 ? launch_fits<false, true>(a, s)
                 : launch_fits<false, false>(a, s);
}

// 1 if the launch for these fits takes the unrolled instance
// (stream_prep_kernel<.., 12, 8>), 0 if the generic one (<.., 0, 0>);
// stream_prep.py's `instance` mirrors it.
int sdp_torch_stream_prep_unrolled(int ncoef, int support, int w_support) {
  return unrolled(ncoef, support, w_support) ? 1 : 0;
}

}  // extern "C"
