// Build / product overlap probe for Hopper (sm_90a): do tap builds on the
// CUDA cores overlap tensor-core products inside one kernel?
//
// Replaces the Pallas TPU kernel of experiments/exp_overlap.py
// (measure_one.run, body kernel). Over TOTAL slots of plan words pa, pb
// (int32) in blocks of BLOCK, each block sums over its chunks of SUB slots
//   acc += U @ V,   U [128, SUB], V [SUB, 128]
// with, per slot p, a tap build shaped like the fused gridder's: three
// Clenshaw evaluations (coefficients c [DEG + 1][8]) at
//   xu = pa 1e-7 - 0.5, xv = pb 1e-7 - 0.5, xw = (pa ^ pb) 1e-7 - 0.5,
//   U[16 j + uo + s][p] = uk[s] wk[j % 4] (uo = pb & 7, zero elsewhere),
//   V[p][iv + s] = vk[s]                  (iv = pa & 120, zero elsewhere).
// Variants, a template parameter each:
//   dot    no build: U[m][p] = pa 1e-9, V[p][n] = pb 1e-9, and the product;
//   vpu    the build, consumed without a product: acc += U[:, c0] V[c0, :]
//          for the first slot c0 of each chunk;
//   both   the build feeds the product (the fused kernels' pattern);
//   both2  the build of the next tile is issued after the product of this
//          one, into the other of two buffers (software pipelining).
// The TPU kernel's output is the last block's acc [128, 128]. A kernel
// that computed only that block would compute the same function at 1/4096
// of the work, so this one also writes each block's sum |acc| [num_blocks],
// which the plain version checks: no block's work can be skipped.
//
// What bounds it on an H100: the product, 3 x 2 x 128 x 128 TF32 operations
// a slot (three TF32 passes for f32 accuracy, 0.83 ms at 4M slots and 495
// TFLOP/s), and for the build ~1,000 f32 operations a slot on the CUDA cores
// (0.06 ms at 67 TFLOP/s); the placement stores 256 words of shared memory
// a slot. The design: one CTA of 8 warps a block; the block is staged 32
// slots at a time into shared memory (thread (slot, s) evaluates tap s of
// its slot and writes its one-hot rows and columns, zeros included); warp w
// accumulates rows 16 w .. 16 w + 15 with m16n16k8 TF32 wmma, each f32
// operand split hi + lo and three products summed, a tile's sums added to
// the running f32 sums on the CUDA cores.

#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "taps.cuh"

namespace {

using namespace nvcuda;

enum Variant { kDot = 0, kVpu = 1, kBoth = 2, kBoth2 = 3 };

constexpr int kS = 8;            // taps
constexpr int kM = 128;          // rows of U
constexpr int kN = 128;          // columns of V
constexpr int kKT = 32;          // slots per staged tile
constexpr int kThreads = 256;    // 8 warps: warp s builds tap s
constexpr int kTilesN = kN / 16;
constexpr int kLdU = kKT + 4;
constexpr int kLdV = kN + 4;
constexpr int kBufFloats = kM * kLdU + kKT * kLdV;
constexpr int kSmemBytes = 2 * kBufFloats * 4;
constexpr int kMaxCoeffs = 16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

struct OverlapArgs {
  const int* pa;
  const int* pb;
  const float* coeffs;     // [ncoef][8]
  int ncoef;
  int block;               // slots a block
  int sub;                 // slots a chunk
  int num_blocks;
  float* out;              // [128][128]: the last block's acc
  float* block_sums;       // [num_blocks]: sum |acc| of each block
};

// Stage slots p0 .. p0 + kKT - 1 into buffer buf: thread (slot = lane,
// s = warp) writes its tap's rows of U and columns of V, zeros included.
template <int VARIANT>
__device__ __forceinline__ void build_tile(const OverlapArgs& a, int64_t p0,
                                           const float* c, float* wk_s,
                                           float* buf) {
  float* u = buf;
  float* v = buf + kM * kLdU;
  const int slot = threadIdx.x % 32;
  const int s = threadIdx.x / 32;
  const int pa = a.pa[p0 + slot];
  const int pb = a.pb[p0 + slot];
  if constexpr (VARIANT == kDot) {
    const float fu = __fmul_rn(static_cast<float>(pa), 1e-9f);
    const float fv = __fmul_rn(static_cast<float>(pb), 1e-9f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      u[(s * 16 + i) * kLdU + slot] = fu;
      v[slot * kLdV + s * 16 + i] = fv;
    }
  } else {
    const float xu = __fsub_rn(__fmul_rn(static_cast<float>(pa), 1e-7f), 0.5f);
    const float xv = __fsub_rn(__fmul_rn(static_cast<float>(pb), 1e-7f), 0.5f);
    const float xw =
        __fsub_rn(__fmul_rn(static_cast<float>(pa ^ pb), 1e-7f), 0.5f);
    const float uk = clenshaw_at(xu, c, a.ncoef, kS, s);
    const float vk = clenshaw_at(xv, c, a.ncoef, kS, s);
    if (s < 4) wk_s[s * 32 + slot] = clenshaw_at(xw, c, a.ncoef, kS, s);
    __syncthreads();
    const int uo = pb & 7;
    const int iv = pa & 120;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u[(16 * j + uo + s) * kLdU + slot] =
          __fmul_rn(uk, wk_s[(j % 4) * 32 + slot]);
      u[(16 * j + ((uo + 8 + s) & 15)) * kLdU + slot] = 0.0f;
    }
    v[slot * kLdV + iv + s] = vk;
#pragma unroll
    for (int q = 1; q < kN / kS; ++q) {
      v[slot * kLdV + ((iv + kS * q + s) & (kN - 1))] = 0.0f;
    }
  }
}

// acc[t] += U[16 warp .., :] @ V[:, 16 t ..] over one staged tile, each
// f32 operand split into TF32 hi + lo, three products. The tensor cores sum
// the tile into fresh fragments, which are added to acc rounded to nearest
// (their own f32 accumulation truncates: over 1024 slots it drifted by
// 1.8e-5 of max on an H100 80GB HBM3).
__device__ __forceinline__ void mma_tile(const float* buf, int warp,
                                         FragC (&acc)[kTilesN]) {
  const float* u = buf;
  const float* v = buf + kM * kLdU;
  FragC part[kTilesN];
#pragma unroll
  for (int t = 0; t < kTilesN; ++t) wmma::fill_fragment(part[t], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kKT; kk += 8) {
    FragA ah, al;
    wmma::load_matrix_sync(ah, u + warp * 16 * kLdU + kk, kLdU);
#pragma unroll
    for (int i = 0; i < ah.num_elements; ++i) {
      const float x = ah.x[i];
      const float h = wmma::__float_to_tf32(x);
      ah.x[i] = h;
      al.x[i] = wmma::__float_to_tf32(x - h);
    }
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) {
      FragB bh, bl;
      wmma::load_matrix_sync(bh, v + kk * kLdV + t * 16, kLdV);
#pragma unroll
      for (int i = 0; i < bh.num_elements; ++i) {
        const float x = bh.x[i];
        const float h = wmma::__float_to_tf32(x);
        bh.x[i] = h;
        bl.x[i] = wmma::__float_to_tf32(x - h);
      }
      wmma::mma_sync(part[t], al, bh, part[t]);
      wmma::mma_sync(part[t], ah, bl, part[t]);
      wmma::mma_sync(part[t], ah, bh, part[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kTilesN; ++t) {
#pragma unroll
    for (int i = 0; i < acc[t].num_elements; ++i) {
      acc[t].x[i] = __fadd_rn(acc[t].x[i], part[t].x[i]);
    }
  }
}

// Sum of |x| over the CTA, into block_sums[blockIdx.x].
__device__ __forceinline__ void block_abs_sum(float part, float* red,
                                              float* dst) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    *dst = t;
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads) overlap_kernel(OverlapArgs a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float c[kMaxCoeffs * kS];
  __shared__ float wk_s[4 * 32];
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < a.ncoef * kS; i += kThreads) {
    c[i] = a.coeffs[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * a.block;
  const int tiles = a.block / kKT;
  const bool last = blockIdx.x == a.num_blocks - 1;
  float part = 0.0f;
  if constexpr (VARIANT == kVpu) {
    // Thread owns row m = tid / 2, columns 64 (tid % 2) .. + 63.
    const int m = threadIdx.x / 2;
    const int n0 = (threadIdx.x % 2) * 64;
    float acc[64] = {};
    for (int t = 0; t < tiles; ++t) {
      build_tile<VARIANT>(a, base + t * kKT, c, wk_s, smem);
      __syncthreads();
      if ((t * kKT) % a.sub == 0) {
        const float um = smem[m * kLdU];
        const float* v0 = smem + kM * kLdU + n0;
#pragma unroll
        for (int q = 0; q < 64; ++q) {
          acc[q] = __fadd_rn(acc[q], __fmul_rn(um, v0[q]));
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      part += fabsf(acc[q]);
      if (last) a.out[m * kN + n0 + q] = acc[q];
    }
  } else {
    FragC acc[kTilesN];
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) wmma::fill_fragment(acc[t], 0.0f);
    if constexpr (VARIANT == kBoth2) {
      build_tile<VARIANT>(a, base, c, wk_s, smem);
      __syncthreads();
      for (int t = 0; t < tiles; ++t) {
        mma_tile(smem + (t & 1) * kBufFloats, warp, acc);
        if (t + 1 < tiles) {
          build_tile<VARIANT>(a, base + (t + 1) * kKT, c, wk_s,
                              smem + ((t + 1) & 1) * kBufFloats);
        }
        __syncthreads();
      }
    } else {
      for (int t = 0; t < tiles; ++t) {
        build_tile<VARIANT>(a, base + t * kKT, c, wk_s, smem);
        __syncthreads();
        mma_tile(smem, warp, acc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) {
#pragma unroll
      for (int i = 0; i < acc[t].num_elements; ++i) part += fabsf(acc[t].x[i]);
      if (last) {
        wmma::store_matrix_sync(a.out + warp * 16 * kN + t * 16, acc[t], kN,
                                wmma::mem_row_major);
      }
    }
  }
  block_abs_sum(part, red, a.block_sums + blockIdx.x);
}

template <int VARIANT>
int launch(const OverlapArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      overlap_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  overlap_kernel<VARIANT><<<a.num_blocks, kThreads, kSmemBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). variant: 0 dot,
// 1 vpu, 2 both, 3 both2. pa, pb [num_blocks * block] int32; coeffs
// [ncoef][8] f32; block a multiple of sub, sub a multiple of 32.
int sdp_torch_overlap(int variant, const int* pa, const int* pb,
                      const float* coeffs, int ncoef, int block, int sub,
                      int num_blocks, float* out, float* block_sums,
                      void* stream) {
  if (variant < kDot || variant > kBoth2 || ncoef < 2 ||
      ncoef > kMaxCoeffs || sub < kKT || sub % kKT != 0 || block < sub ||
      block % sub != 0 || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OverlapArgs a{pa, pb, coeffs, ncoef, block, sub, num_blocks, out,
                      block_sums};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDot: return launch<kDot>(a, s);
    case kVpu: return launch<kVpu>(a, s);
    case kBoth: return launch<kBoth>(a, s);
    default: return launch<kBoth2>(a, s);
  }
}

}  // extern "C"
