// Bucket-window band gridding for Hopper (sm_90a), from compact per-slot
// taps or from the two plan words.
//
// Replace two Pallas TPU kernels of ska_sdp_func_tpu/kernels/:
//   - packed_tap.py grid_packed_pallas (_grid_kernel, _grid_kernel_split,
//     _grid_accumulate)                      -> band_grid_kernel<M, false>
//   - fused_tap.py grid_fused_pallas (_grid_fused_kernel, _block_contrib,
//     _prep_common)                          -> band_grid_kernel<M, true>
// Their degrid twins (packed_tap.py degrid_fused_pallas, fused_tap.py
// degrid_fused2_pallas: the degrid below) are window_gather.cu's
// window_gather_kernel<M, kBandTaps> and <M, kBandWords>.
//
// Layout (shared with the plain PyTorch versions in band_tap.py): the
// bucket-sorted stream of `total` slots is cut into plan blocks of
// `block_v` slots; block b belongs to one bucket. Slot p carries u_off[p]
// (u row of its first tap in the 16-row window), iv0[p] (lane of its
// first tap in the window), uk[p][S], vk[p][S]; the Pallas kernels stream
// these placed into dense bands (ubase [16, V], vband [V, lanes]). The
// fused forms (FUSED) read the plan words instead,
//   pa = iv0 << 20 | u_off << 17 | w_row,
//   pb = valid << 30 | u_frac << 15 | v_frac,
// and evaluate uk, vk and wk with taps.cuh's Chebyshev sums, each
// operation rounded on its own in the plain versions' order.
//
//   grid:   out[h Sw + j][bucket][u_off + su][iv0 + sv]
//             += P(uk[su] * s[h Sw + j], vk[sv]),
//           s the scale stack, given or split as wk_t[j] * (h ? vim : vre)
//           (fused: wk[j] * (h ? vim : vre));
//   degrid: v_h = sum_{j, su} (uk[su] * wk_t[j])
//             * sum_sv P(planes[h][p_idx + j][8 g + u_off + su]
//                              [128 hv + iv0 + sv], vk[sv])
//           (fused: wk_t[j] = wk[j] * valid).
//
// P is the mode's product (taps.cuh): kF32 ("highest"), kHigh (the bf16
// hi/lo halves; fused forms only) or kBf16 (bf16-rounded factors). The
// band forms take kBf16 when vk is bf16 (the streaming engine's fast mode,
// as JAX switches on the band's dtype); the fused forms take all three.
// Lanes past the window width are dropped, as the Pallas band build drops
// them.
//
// What bounds it on an H100, and the design. The Pallas kernels multiply
// the dense bands on the MXU: 2 Sw 16 lanes MACs per slot (65,536 at the
// ES shape Sw = 8, lanes = 256), of which 2 Sw S S (1,024) are not zero,
// and stream 1 KiB of bands per slot. Here only the non-zero products are
// formed, from 72 B of taps per slot (40 B with a bf16 vk; 16 B of words
// and visibilities in the fused grid), so the work is bound by
// shared-memory atomics (grid) and gathers (degrid), not by flops or device
// memory. A whole ES window (2 Sw 16 rows x 256 lanes f32, 256 KiB at
// Sw = 8) does not fit one block's 227 KB of shared memory, so the grid
// takes one window plane a CTA: one CTA of 256 threads per (group of kGroup consecutive plan
// blocks, window plane h Sw + j): a [16][lanes + 1] f32 window (16.4 KiB
// at 256 lanes; the odd row stride spreads a warp's eight u rows over the
// banks) takes the group's S x S products by shared atomics; whenever the
// bucket changes, and at the end, the window's non-zero cells are added
// to the bucket's output window with global atomicAdd (so the f32 sum
// order varies run to run) and the window is zeroed. Slots whose scale is
// zero (padding, invalid) are skipped. The fused form stages 256 slots at
// a time: one thread per slot evaluates that plane's taps (uk, vk and
// its one w tap) into shared memory, then the CTA scatters them as above;
// each slot's taps are so evaluated once per window plane (2 Sw times),
// and blocks that `nonempty` marks 0 are skipped.

#include "taps.cuh"

namespace {

constexpr int kWinRows = 16;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // fused grid: slots staged at once
constexpr int kGroup = 8;         // plan blocks per grid CTA
constexpr int kMaxS = 8;
constexpr int kMaxSw = 8;
constexpr int kMaxFusedSw = 4;    // the fused forms: Sw x S <= 32 lanes
constexpr int kMaxSmem = 227 * 1024;

// The plan words and tap fits of the fused forms.
struct WordTaps {
  const int* pa;
  const int* pb;
  const float* c_uv;     // [ncoef][S]
  const float* c_w;      // [ncoef][Sw]
  const int* nonempty;   // [num_blocks] or null
  int ncoef;
  float inv2_ov, inv2_wov;
};

struct GridArgs {
  const int* bucket_ids;
  const int* u_off;
  const int* iv0;
  const float* uk;
  const void* vk;       // [total][S] f32, or bf16 in kBf16
  const float* wk_t;    // split form: [Sw][total]
  const float* vre;
  const float* vim;
  const float* scales;  // stack form: [2 Sw][total]
  WordTaps wt;
  int num_blocks, block_v, support, w_support, lanes, num_buckets;
  float* out;           // [2 Sw][num_buckets][16][lanes]
};

// Band forms: vk[i] as f32 (bf16 storage in kBf16).
template <int MODE>
__device__ __forceinline__ float load_vk(const void* vk, int64_t i) {
  if (MODE == kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(vk)[i]);
  }
  return static_cast<const float*>(vk)[i];
}

// Adds the shared window's non-zero cells to `dst` (16 x lanes) and, with
// `zero`, clears them.
__device__ __forceinline__ void flush_window(float* win, int stride,
                                             float* dst, int lanes,
                                             bool zero) {
  for (int i = threadIdx.x; i < kWinRows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int c = i % lanes;
    const float x = win[r * stride + c];
    if (x != 0.0f) {
      atomicAdd(dst + i, x);
      if (zero) win[r * stride + c] = 0.0f;
    }
  }
}

__host__ __device__ __forceinline__ size_t grid_smem_bytes(int lanes,
                                                           bool fused) {
  const size_t window = kWinRows * (lanes + 1);
  const size_t staged = fused ? kChunk * (2 * kMaxS + 3) : 0;
  return sizeof(float) * (window + staged);
}

template <int MODE, bool FUSED>
__global__ void __launch_bounds__(kThreads)
band_grid_kernel(GridArgs a) {
  extern __shared__ float smem[];
  const int S = a.support;
  const int Sw = a.w_support;
  const int lanes = a.lanes;
  const int stride = lanes + 1;
  float* win = smem;                              // [16][lanes + 1]
  float* s_uk = win + kWinRows * stride;          // fused: [kChunk][kMaxS]
  float* s_vk = s_uk + kChunk * kMaxS;            // fused: [kChunk][kMaxS]
  float* s_sc = s_vk + kChunk * kMaxS;            // fused: [kChunk]
  int* s_pos = reinterpret_cast<int*>(s_sc + kChunk);  // [kChunk][2]
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
    // Uniform across the CTA: the block's occupancy and bucket.
    if (FUSED && a.wt.nonempty != nullptr && a.wt.nonempty[b] == 0) continue;
    const int bucket = a.bucket_ids[b];
    if (bucket != cur) {
      __syncthreads();
      if (cur >= 0) {
        flush_window(win, stride,
                     a.out + ((static_cast<int64_t>(plane) * a.num_buckets +
                               cur) * kWinRows) * lanes,
                     lanes, true);
        __syncthreads();
      }
      cur = bucket;
    }
    const int64_t p0 = static_cast<int64_t>(b) * a.block_v;
    if constexpr (FUSED) {
      const WordTaps& wt = a.wt;
      for (int c0 = 0; c0 < a.block_v; c0 += kChunk) {
        const int n = min(kChunk, a.block_v - c0);
        if (tid < n) {
          const int64_t p = p0 + c0 + tid;
          const int wa = wt.pa[p];
          const int wb = wt.pb[p];
          float t[kMaxCoef];
          cheb_basis(frac_x(wa & 131071, wt.inv2_wov), wt.ncoef, t);
          s_sc[tid] = __fmul_rn(cheb_sum(wt.c_w + j, Sw, wt.ncoef, t),
                                vis[p]);
          cheb_basis(frac_x((wb >> 15) & 32767, wt.inv2_ov), wt.ncoef, t);
          for (int s = 0; s < S; ++s) {
            s_uk[tid * kMaxS + s] = cheb_sum(wt.c_uv + s, S, wt.ncoef, t);
          }
          cheb_basis(frac_x(wb & 32767, wt.inv2_ov), wt.ncoef, t);
          for (int s = 0; s < S; ++s) {
            s_vk[tid * kMaxS + s] = cheb_sum(wt.c_uv + s, S, wt.ncoef, t);
          }
          s_pos[2 * tid] = (wa >> 17) & 7;  // u_off
          s_pos[2 * tid + 1] = wa >> 20;    // iv0
        }
        __syncthreads();
        for (int e = tid; e < n * S; e += kThreads) {
          const int i = e / S;
          const int su = e % S;
          const float s = s_sc[i];
          if (s == 0.0f) continue;
          const float u = __fmul_rn(s_uk[i * kMaxS + su], s);
          const int col = s_pos[2 * i + 1];
          float* row = win + (s_pos[2 * i] + su) * stride;
          for (int sv = 0; sv < S; ++sv) {
            if (col + sv < lanes) {
              atomicAdd(row + col + sv,
                        prod<MODE>(u, s_vk[i * kMaxS + sv]));
            }
          }
        }
        __syncthreads();
      }
    } else {
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
            atomicAdd(row + c0 + sv,
                      prod<MODE>(u, load_vk<MODE>(a.vk, p * S + sv)));
          }
        }
      }
    }
  }
  __syncthreads();
  if (cur >= 0) {
    flush_window(win, stride,
                 a.out + ((static_cast<int64_t>(plane) * a.num_buckets +
                           cur) * kWinRows) * lanes,
                 lanes, false);
  }
}

template <int MODE, bool FUSED>
cudaError_t launch_grid(const GridArgs& a, cudaStream_t s) {
  const size_t smem = grid_smem_bytes(a.lanes, FUSED);
  cudaError_t err = cudaFuncSetAttribute(
      band_grid_kernel<MODE, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.num_blocks + kGroup - 1) / kGroup, 2 * a.w_support);
  band_grid_kernel<MODE, FUSED><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

bool band_ok(int block_v, int support, int w_support, bool fused,
             int ncoef) {
  return block_v > 0 && support >= 1 && support <= kMaxS &&
         w_support >= 1 &&
         w_support <= (fused ? kMaxFusedSw : kMaxSw) &&
         (!fused || (2 * support + w_support <= 32 &&
                     ncoef >= 2 && ncoef <= kMaxCoef));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).
// Band grid (K8): the split scale form passes wk_t/vre/vim and a null
// `scales`, the stack form the reverse; `mode` kF32, or kBf16 with a bf16
// vk.
int sdp_torch_band_grid(const int* bucket_ids, const int* u_off,
                        const int* iv0, const float* uk, const void* vk,
                        const float* wk_t, const float* vre,
                        const float* vim, const float* scales,
                        int num_blocks, int block_v, int support,
                        int w_support, int lanes, int num_buckets, int mode,
                        float* out, void* stream) {
  if (!band_ok(block_v, support, w_support, false, 0) || lanes <= 0 ||
      num_buckets <= 0 || (mode != kF32 && mode != kBf16) ||
      (scales == nullptr && (wk_t == nullptr || vre == nullptr ||
                             vim == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks <= 0) return 0;
  if (grid_smem_bytes(lanes, false) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GridArgs a{bucket_ids, u_off, iv0, uk, vk, wk_t, vre, vim, scales,
                   WordTaps{}, num_blocks, block_v, support, w_support,
                   lanes, num_buckets, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == kBf16 ? launch_grid<kBf16, false>(a, s)
                                        : launch_grid<kF32, false>(a, s));
}

// Fused grid (K18): taps from the words pa/pb; `mode` kF32, kHigh or
// kBf16; blocks whose `nonempty` (may be null) is 0 are skipped.
int sdp_torch_band_grid_fused(const int* bucket_ids, const int* nonempty,
                              const int* pa, const int* pb,
                              const float* vre, const float* vim,
                              const float* c_uv, const float* c_w,
                              int ncoef, float inv2_ov, float inv2_wov,
                              int num_blocks, int block_v, int support,
                              int w_support, int lanes, int num_buckets,
                              int mode, float* out, void* stream) {
  if (!band_ok(block_v, support, w_support, true, ncoef) || lanes <= 0 ||
      num_buckets <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks <= 0) return 0;
  if (grid_smem_bytes(lanes, true) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GridArgs a{bucket_ids, nullptr, nullptr, nullptr, nullptr, nullptr,
                   vre, vim, nullptr,
                   WordTaps{pa, pb, c_uv, c_w, nonempty, ncoef, inv2_ov,
                            inv2_wov},
                   num_blocks, block_v, support, w_support, lanes,
                   num_buckets, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return static_cast<int>(launch_grid<kF32, true>(a, s));
    case kHigh: return static_cast<int>(launch_grid<kHigh, true>(a, s));
    case kBf16: return static_cast<int>(launch_grid<kBf16, true>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
