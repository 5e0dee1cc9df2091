// Per-bucket sums of block band products for Hopper (sm_90a), on the
// tensor cores: the A/B family of the packed grid kernel's product.
//
// Replaces the Pallas TPU kernels of two experiments, one function in
// several formulations:
//   experiments/exp_dot.py _call (bodies _k_prod, _k_lhs_stream, _k_ksplit,
//     _k_nodot) and _call_npair (_k_npair);
//   experiments/exp_parity.py grid_packed_parity (_grid_kernel_parity).
// Per block b of B slots (block_v), with U_b [128, B] and V_b = vband[bB:
// (b+1)B] [B, 128]:
//   U_b[16 j + r][c] = ubase[r][bB + c] * scales[j][bB + c]   (build) or
//   U_b = uall[:, bB:(b+1)B]                                 (stream),
//   out[bucket_ids[b]] += U_b @ V_b                          [128, 128],
// and the formulations:
//   one      a single accumulator;
//   ksplit   KSPLIT independent tensor-core chains over the K range of each
//            staged chunk, added together, then to the accumulator;
//   slots    SLOTS accumulators, block b into slot b % SLOTS, added in slot
//            order at the flush (exp_parity's split accumulator);
//   side     npair: block b into bucket ids[b & ~1], columns (b & 1) * 128
//            of a [128, 256] bucket row;
//   nodot    no product: out += sum_c U_b[:, 128 c : 128 c + 128] + V_b[0].
// Products: TF32X3, f32 operands split into TF32 hi + lo and three tensor
// core products a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation
// (the TPU's Precision.HIGHEST); BF16, bf16 operands (U rounded once from
// its f32 product) with f32 accumulation; SIMT, f32 FMAs on the CUDA cores
// (as K1 and K8 compute today). The tensor cores sum each staged chunk
// (4 k-steps) into fresh fragments, which the CUDA cores add to the running
// f32 sums, rounded to nearest: the tensor cores' own f32 accumulation
// truncates, and over a bucket's 1024-8192 slots it drifted by 1.5-1.8e-5 of
// max on an H100 80GB HBM3. The blocks of a bucket must be contiguous;
// buckets no block visits are left as the wrapper filled them (zero).
//
// What bounds it on an H100, at exp_dot's 2,097,152 slots (6.87e10 FLOP):
// TF32X3 0.42 ms of tensor-core work (495 TFLOP/s dense / 3), above the f32
// bytes (1.29 GB, 0.39 ms); BF16 the bytes (0.74 GB, 0.22 ms); SIMT 1.03 ms
// of FMAs (67 TFLOP/s). The design, a simple one that is right: one CTA of
// 8 warps owns one bucket's run of blocks and one 64-column half of the
// output (the CTA of a run's first block works, the others exit), stages
// U and V through shared memory 32 slots (bf16: 64) at a time (U built
// there from ubase and scales, or copied from uall), and warp w accumulates
// the rows 16 w .. 16 w + 15 with nvcuda::wmma (m16n16k8 tf32, m16n16k16
// bf16) in registers until the run ends; the result is stored once, no
// atomics. Later work: wgmma, TMA, a pipelined ring of stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

enum Compute { kTf32x3 = 0, kBf16 = 1, kSimt = 2, kNoDot = 3 };
enum ASource { kBuild = 0, kStream = 1 };

constexpr int kM = 128;          // rows of U: 8 scale rows x 16 window rows
constexpr int kWin = 16;
constexpr int kLanes = 128;      // columns of the band
constexpr int kHalf = 64;        // columns a CTA owns
constexpr int kThreads = 256;    // 8 warps
constexpr int kTilesN = kHalf / 16;
constexpr int kSteps = 4;        // mma k-steps a staged chunk
// Slots staged a step: 4 k-steps of 8 (TF32, and the SIMT form) or 16
// (bf16); shared-memory leading dimensions padded by 16 bytes.
template <int COMPUTE>
constexpr int kKC = COMPUTE == kBf16 ? 64 : 32;
template <int COMPUTE>
constexpr int kLdA = COMPUTE == kBf16 ? 64 + 8 : 32 + 4;
template <int COMPUTE>
constexpr int kLdB = COMPUTE == kBf16 ? kHalf + 8 : kHalf + 4;
constexpr int kSmemBytes = (kM * 72 + 64 * 72) * 2;   // >= the f32 layout

struct DotArgs {
  const int* bucket_ids;   // [nb]
  const float* ubase;      // [16][total]       (build)
  const float* scales;     // [8][total]        (build)
  const void* uall;        // [128][total]      (stream; f32 or bf16)
  const void* vband;       // [total][128]      (f32 or bf16)
  int64_t total;
  int nb;                  // blocks taken
  int block_v;
  float* out;
  int64_t stride_j;        // output element strides of scale row j,
  int64_t stride_r;        // window row r,
  int64_t stride_bucket;   // bucket
};

template <int COMPUTE>
struct Frags;

template <>
struct Frags<kTf32x3> {
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                           wmma::row_major>;
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                           wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
};

template <>
struct Frags<kBf16> {
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>;
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
};

template <bool SIDE>
__device__ __forceinline__ int run_id(const DotArgs& a, int b) {
  return a.bucket_ids[SIDE ? (b & ~1) : b];
}

// Stage U [128][KC] and V [KC][64] of slots k0 .. k0 + KC - 1 (V's
// columns half * 64 ..) into shared memory, f32 or bf16.
template <int COMPUTE, int ASRC>
__device__ __forceinline__ void stage(const DotArgs& a, int64_t k0, int half,
                                      unsigned char* smem) {
  constexpr int KC = kKC<COMPUTE>;
  constexpr int LDA = kLdA<COMPUTE>;
  constexpr int LDB = kLdB<COMPUTE>;
  using T = typename std::conditional<COMPUTE == kBf16, __nv_bfloat16,
                                      float>::type;
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + kM * LDA;
  const int tid = threadIdx.x;
  const int64_t total = a.total;
  for (int idx = tid; idx < kM * KC; idx += kThreads) {
    const int m = idx / KC;
    const int k = idx % KC;
    const int64_t col = k0 + k;
    if constexpr (ASRC == kBuild) {
      const float u = __fmul_rn(a.ubase[(m % kWin) * total + col],
                                a.scales[(m / kWin) * total + col]);
      if constexpr (COMPUTE == kBf16) {
        as[m * LDA + k] = __float2bfloat16_rn(u);
      } else {
        as[m * LDA + k] = u;
      }
    } else {
      as[m * LDA + k] = static_cast<const T*>(a.uall)[m * total + col];
    }
  }
  for (int idx = tid; idx < KC * kHalf; idx += kThreads) {
    const int k = idx / kHalf;
    const int n = idx % kHalf;
    bs[k * LDB + n] = static_cast<const T*>(
        a.vband)[(k0 + k) * kLanes + half * kHalf + n];
  }
}

// acc[t] += U[16 warp .., :] @ V[:, 16 t ..] over the staged chunk. The
// tensor cores sum the chunk into KSPLIT fresh chains (k-steps split in
// contiguous ranges); the chains are added to each other and then to acc on
// the CUDA cores, rounded to nearest: the tensor cores' f32 accumulation
// truncates, and over a whole run of blocks it drifts by ~1.5e-5 of max.
template <int COMPUTE, int KSPLIT>
__device__ __forceinline__ void mma_chunk(
    const unsigned char* smem, int warp,
    typename Frags<COMPUTE>::Acc (&acc)[kTilesN]) {
  using F = Frags<COMPUTE>;
  constexpr int KC = kKC<COMPUTE>;
  constexpr int LDA = kLdA<COMPUTE>;
  constexpr int LDB = kLdB<COMPUTE>;
  constexpr int KS = KC / kSteps;
  typename F::Acc part[KSPLIT][kTilesN];
#pragma unroll
  for (int c = 0; c < KSPLIT; ++c) {
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) wmma::fill_fragment(part[c][t], 0.0f);
  }
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int kk = step * KS;
    auto& chain = part[step * KSPLIT / kSteps];
    if constexpr (COMPUTE == kTf32x3) {
      const float* as = reinterpret_cast<const float*>(smem);
      const float* bs = as + kM * LDA;
      typename F::A ah, al;
      wmma::load_matrix_sync(ah, as + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < ah.num_elements; ++i) {
        const float x = ah.x[i];
        const float h = wmma::__float_to_tf32(x);
        ah.x[i] = h;
        al.x[i] = wmma::__float_to_tf32(x - h);
      }
#pragma unroll
      for (int t = 0; t < kTilesN; ++t) {
        typename F::B bh, bl;
        wmma::load_matrix_sync(bh, bs + kk * LDB + t * 16, LDB);
#pragma unroll
        for (int i = 0; i < bh.num_elements; ++i) {
          const float x = bh.x[i];
          const float h = wmma::__float_to_tf32(x);
          bh.x[i] = h;
          bl.x[i] = wmma::__float_to_tf32(x - h);
        }
        wmma::mma_sync(chain[t], al, bh, chain[t]);
        wmma::mma_sync(chain[t], ah, bl, chain[t]);
        wmma::mma_sync(chain[t], ah, bh, chain[t]);
      }
    } else {
      const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(smem);
      const __nv_bfloat16* bs = as + kM * LDA;
      typename F::A af;
      wmma::load_matrix_sync(af, as + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int t = 0; t < kTilesN; ++t) {
        typename F::B bf;
        wmma::load_matrix_sync(bf, bs + kk * LDB + t * 16, LDB);
        wmma::mma_sync(chain[t], af, bf, chain[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTilesN; ++t) {
#pragma unroll
    for (int i = 0; i < acc[t].num_elements; ++i) {
      float sum = part[0][t].x[i];
#pragma unroll
      for (int c = 1; c < KSPLIT; ++c) sum = __fadd_rn(sum, part[c][t].x[i]);
      acc[t].x[i] = __fadd_rn(acc[t].x[i], sum);
    }
  }
}

// Tensor-core forms: COMPUTE kTf32x3 or kBf16. Block b's sums go to the
// running accumulator b % NACC (side: b & 1).
template <int COMPUTE, int ASRC, int NACC, int KSPLIT, bool SIDE>
__device__ void run_mma(const DotArgs& a, int b0, int b1, int bucket,
                        int half, unsigned char* smem) {
  using Acc = typename Frags<COMPUTE>::Acc;
  constexpr int KC = kKC<COMPUTE>;
  const int warp = threadIdx.x / 32;
  const int nkc = a.block_v / KC;
  Acc acc[NACC][kTilesN];
#pragma unroll
  for (int c = 0; c < NACC; ++c) {
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) wmma::fill_fragment(acc[c][t], 0.0f);
  }
  for (int b = b0; b < b1; ++b) {
    const int slot = SIDE ? (b & 1) : b % NACC;
    for (int kc = 0; kc < nkc; ++kc) {
      stage<COMPUTE, ASRC>(a, static_cast<int64_t>(b) * a.block_v + kc * KC,
                           half, smem);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < NACC; ++c) {
        if (c == slot) mma_chunk<COMPUTE, KSPLIT>(smem, warp, acc[c]);
      }
      __syncthreads();
    }
  }
  // Warp w holds rows 16 w .. 16 w + 15: scale row j = w, window rows r.
  float* base = a.out + warp * a.stride_j + bucket * a.stride_bucket +
                half * kHalf;
  if constexpr (SIDE) {
#pragma unroll
    for (int c = 0; c < NACC; ++c) {
#pragma unroll
      for (int t = 0; t < kTilesN; ++t) {
        wmma::store_matrix_sync(base + c * kLanes + t * 16, acc[c][t],
                                static_cast<unsigned>(a.stride_r),
                                wmma::mem_row_major);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < kTilesN; ++t) {
#pragma unroll
      for (int c = 1; c < NACC; ++c) {
#pragma unroll
        for (int i = 0; i < acc[0][t].num_elements; ++i) {
          acc[0][t].x[i] = __fadd_rn(acc[0][t].x[i], acc[c][t].x[i]);
        }
      }
      wmma::store_matrix_sync(base + t * 16, acc[0][t],
                              static_cast<unsigned>(a.stride_r),
                              wmma::mem_row_major);
    }
  }
}

// f32 FMAs on the CUDA cores: thread (ty, tx) owns rows 8 ty .. 8 ty + 7
// and columns 4 tx .. 4 tx + 3 of the CTA's half.
template <int ASRC>
__device__ void run_simt(const DotArgs& a, int b0, int b1, int bucket,
                         int half, unsigned char* smem) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  constexpr int KC = kKC<kSimt>;
  constexpr int LDA = kLdA<kSimt>;
  constexpr int LDB = kLdB<kSimt>;
  const int nkc = a.block_v / KC;
  const float* as = reinterpret_cast<const float*>(smem);
  const float* bs = as + kM * LDA;
  float acc[8][4] = {};
  for (int b = b0; b < b1; ++b) {
    for (int kc = 0; kc < nkc; ++kc) {
      stage<kSimt, ASRC>(a, static_cast<int64_t>(b) * a.block_v + kc * KC,
                         half, smem);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * LDB +
                                                          tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float u = as[(ty * 8 + i) * LDA + k];
          acc[i][0] = fmaf(u, v.x, acc[i][0]);
          acc[i][1] = fmaf(u, v.y, acc[i][1]);
          acc[i][2] = fmaf(u, v.z, acc[i][2]);
          acc[i][3] = fmaf(u, v.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 8 + i;
    float* dst = a.out + (m / kWin) * a.stride_j + (m % kWin) * a.stride_r +
                 bucket * a.stride_bucket + half * kHalf + tx * 4;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// No product: out += sum_c U_b[:, 128 c + n] + V_b[0][n]. Thread owns
// column n = tid % 64 of the half and rows 32 g .. 32 g + 31, g = tid / 64.
__device__ void run_nodot(const DotArgs& a, int b0, int b1, int bucket,
                          int half) {
  const int n = half * kHalf + threadIdx.x % kHalf;
  const int g = threadIdx.x / kHalf;
  const int64_t total = a.total;
  const float* vband = static_cast<const float*>(a.vband);
  float acc[32] = {};
  for (int b = b0; b < b1; ++b) {
    const int64_t s0 = static_cast<int64_t>(b) * a.block_v;
    const float v0 = vband[s0 * kLanes + n];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int m = g * 32 + i;
      const float* ub = a.ubase + (m % kWin) * total + s0 + n;
      const float* sc = a.scales + (m / kWin) * total + s0 + n;
      float s = __fmul_rn(ub[0], sc[0]);
      for (int c = kLanes; c < a.block_v; c += kLanes) {
        s = __fadd_rn(s, __fmul_rn(ub[c], sc[c]));
      }
      acc[i] = __fadd_rn(acc[i], __fadd_rn(s, v0));
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int m = g * 32 + i;
    a.out[(m / kWin) * a.stride_j + (m % kWin) * a.stride_r +
          bucket * a.stride_bucket + n] = acc[i];
  }
}

template <int COMPUTE, int ASRC, int NACC, int KSPLIT, bool SIDE>
__global__ void __launch_bounds__(kThreads) bucket_dot_kernel(DotArgs a) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int b0 = blockIdx.x;
  const int half = blockIdx.y;
  if (b0 >= a.nb) return;
  const int bucket = run_id<SIDE>(a, b0);
  // The CTA of a run's first block takes the run; the others exit.
  if (b0 > 0 && run_id<SIDE>(a, b0 - 1) == bucket) return;
  int b1 = b0 + 1;
  while (b1 < a.nb && run_id<SIDE>(a, b1) == bucket) ++b1;
  if constexpr (COMPUTE == kNoDot) {
    run_nodot(a, b0, b1, bucket, half);
  } else if constexpr (COMPUTE == kSimt) {
    run_simt<ASRC>(a, b0, b1, bucket, half, smem);
  } else {
    run_mma<COMPUTE, ASRC, NACC, KSPLIT, SIDE>(a, b0, b1, bucket, half,
                                               smem);
  }
}

template <int COMPUTE, int ASRC, int NACC = 1, int KSPLIT = 1,
          bool SIDE = false>
int launch(const DotArgs& a, cudaStream_t s) {
  const dim3 grid(a.nb, kLanes / kHalf);
  bucket_dot_kernel<COMPUTE, ASRC, NACC, KSPLIT, SIDE>
      <<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). variant:
//   0 prod (TF32X3)        1 prod (BF16)         2 prod (SIMT)
//   3 lhs_stream (TF32X3)  4 lhs_stream (BF16)
//   5 ksplit2 (TF32X3)     6 ksplit4 (TF32X3)    7 ksplit2 (BF16)
//   8 ksplit4 (BF16)       9 npair (TF32X3)      10 npair (BF16)
//   11 nodot               12 slots2 (TF32X3)    13 slots4 (TF32X3)
// Build forms read ubase [16][total] and scales [8][total] f32; stream
// forms uall [128][total] (bf16 for 4); vband [total][128] is bf16 for the
// BF16 forms, f32 otherwise. out is written at the buckets the blocks
// visit, element (j, r, bucket, n) at j stride_j + r stride_r + bucket
// stride_bucket + n (npair: n < 256); block_v is a multiple of 128 (so
// the K chains split it evenly) and the strides of 8 (32-byte rows).
int sdp_torch_bucket_dot(int variant, const int* bucket_ids,
                         const float* ubase, const float* scales,
                         const void* uall, const void* vband, int64_t total,
                         int nb, int block_v, float* out, int64_t stride_j,
                         int64_t stride_r, int64_t stride_bucket,
                         void* stream) {
  if (variant < 0 || variant > 13 || nb < 0 || block_v < kLanes ||
      block_v % kLanes != 0 || total < static_cast<int64_t>(nb) * block_v ||
      stride_r % 8 != 0 || stride_j % 8 != 0 || stride_bucket % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  const DotArgs a{bucket_ids, ubase, scales, uall, vband, total, nb,
                  block_v, out, stride_j, stride_r, stride_bucket};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<kTf32x3, kBuild>(a, s);
    case 1: return launch<kBf16, kBuild>(a, s);
    case 2: return launch<kSimt, kBuild>(a, s);
    case 3: return launch<kTf32x3, kStream>(a, s);
    case 4: return launch<kBf16, kStream>(a, s);
    case 5: return launch<kTf32x3, kBuild, 1, 2>(a, s);
    case 6: return launch<kTf32x3, kBuild, 1, 4>(a, s);
    case 7: return launch<kBf16, kBuild, 1, 2>(a, s);
    case 8: return launch<kBf16, kBuild, 1, 4>(a, s);
    case 9: return launch<kTf32x3, kBuild, 2, 1, true>(a, s);
    case 10: return launch<kBf16, kBuild, 2, 1, true>(a, s);
    case 11: return launch<kNoDot, kBuild>(a, s);
    case 12: return launch<kTf32x3, kBuild, 2>(a, s);
    default: return launch<kTf32x3, kBuild, 4>(a, s);
  }
}

}  // extern "C"
