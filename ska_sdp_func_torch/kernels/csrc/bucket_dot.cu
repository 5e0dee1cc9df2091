// Per-bucket sums of block band products for Hopper (sm_90a): the A/B
// family of the packed grid kernel's product.
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
//   ksplit   each staged chunk's K range in KSPLIT parts, each summed
//            apart and then added to the accumulator;
//   slots    SLOTS accumulators, block b into slot b % SLOTS, added in slot
//            order (exp_parity's split accumulator);
//   side     npair: block b into bucket ids[b & ~1], columns (b & 1) * 128
//            of a [128, 256] bucket row;
//   nodot    no product: out += sum_c U_b[:, 128 c : 128 c + 128] + V_b[0].
// Products: TF32X3, f32 operands split into TF32 hi + lo and three tensor
// core products a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation
// (the TPU's Precision.HIGHEST); BF16, bf16 operands (U rounded once from
// its f32 product) with f32 accumulation; SIMT, f32 FMAs on the CUDA cores
// (as K1 and K8 compute today). The tensor cores' own f32 accumulation
// truncates (over a bucket's 1024-8192 slots it drifted by 1.5-1.8e-5 of
// max on an H100 80GB HBM3), so they sum one staged chunk of 64 slots (or
// one of its KSPLIT parts) into fresh fragments, which the CUDA cores add to
// the running f32 sums, rounded to nearest. The blocks of a bucket must be
// contiguous; buckets no block visits are zero (the tensor-core kernel
// writes them; the CUDA-core forms leave them as the wrapper zeroed them).
//
// What bounds it on an H100, at exp_dot's 2,097,152 slots (6.87e10 FLOP):
// TF32X3 0.42 ms of tensor-core work (495 TFLOP/s dense / 3), above the f32
// bytes (1.29 GB, 0.39 ms); BF16 the bytes (0.74 GB, 0.22 ms); SIMT 1.03 ms
// of FMAs (67 TFLOP/s). So the tensor-core forms (bucket_dot_kernel) feed
// wgmma at the memory's rate:
//   - work units are the runs of a run table (first block, count; longest
//     first, (0, 0) rows last), each a whole bucket run and all 128
//     columns, so U is built or loaded once; a persistent grid of one CTA an
//     SM takes them one at a time from a shared counter, longest first
//     (the runs are ragged: with a fixed stride of the grid, exp_parity's
//     busiest CTA held 18 % more blocks than the mean);
//   - a producer warp streams 64-slot stages through a ring by TMA,
//     completing on mbarriers: vband [64, 128] in 128-byte swizzled boxes
//     and ubase [16, 72] (rows padded for conflict-free reads) with scales
//     [8, 64], or uall's [128, 64] tile (K-major, swizzled); the consumer
//     warps release a stage with one arrive each;
//   - two consumer warpgroups each own 64 of U's 128 rows (scale rows
//     4 g .. 4 g + 3), so neither waits for the other;
//   - TF32X3: a TF32 wgmma takes its shared-memory operand K-major only,
//     and vband [slots, 128] is MN-major as the B of U V, so the consumers
//     compute out^T = V^T U^T: A = V^T from registers (two m64 tiles, lanes
//     permuted so that one float4 a k-row feeds both; split into hi/lo
//     there), B = U^T, which the warpgroup writes as TF32 hi and lo planes
//     in the K-major swizzled layout (stream forms: the TMA tile is hi, the
//     tensor cores reading f32 as its TF32 truncation); three wgmma
//     m64n64k8 a k-step and m-tile, A double-buffered across k-steps;
//   - BF16: out = U V with B = vband MN-major from the stage; A = U built in
//     registers (build) or the uall tile (K-major, stream): wgmma
//     m64n128k16;
//   - slots and npair are passes over the run: pass p takes the run's
//     blocks b with b % PASSES == p; npair stores pass p at columns 128 p,
//     slots store pass 0 and add each later pass to the stored sums, so the
//     slots are added in slot order with one running accumulator;
//   - the sums are stored once a pass, with no atomics; the producer
//     warpgroup's other warps zero the buckets no block visits meanwhile,
//     so the wrapper need not fill the output first.
// prod_simt and nodot keep the first design's CUDA-core bodies
// (bucket_dot_cuda_core_kernel: a CTA a run and 64-column half).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

enum Compute { kTf32x3 = 0, kBf16 = 1, kSimt = 2, kNoDot = 3 };
enum ASource { kBuild = 0, kStream = 1 };

constexpr int kM = 128;          // rows of U: 8 scale rows x 16 window rows
constexpr int kWin = 16;
constexpr int kScaleRows = 8;
constexpr int kLanes = 128;      // columns of the band

struct DotArgs {
  const int* bucket_ids;   // [nb]
  const int2* runs;        // [num_runs] (first block, count) (tensor cores)
  int num_runs;
  int* work;               // [1 + num_buckets]: the next unit, then a flag a
                           // bucket (1: some block visits it) (tensor cores)
  int num_buckets;
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

// -- tensor-core forms --------------------------------------------------------

constexpr int kChunk = 64;              // slots of a ring stage
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kUbPitch = 72;            // f32 of a staged ubase row
constexpr int kBox = 8192;              // a swizzled box: 64 rows x 128 bytes
constexpr int kSmemMax = 232448;        // shared memory of a block (sm_90)
constexpr int kMaxStages = 6;

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory: the ring's stages, the TF32 forms' U^T planes, barriers.
template <int COMPUTE, int ASRC>
struct Layout {
  static constexpr bool kTf32 = COMPUTE == kTf32x3;
  // A stage: vband's [64, 128] tile in boxes of 128 bytes a row (f32: four
  // of 32 lanes; bf16: two of 64), then ubase [16, 72] and scales [8, 64]
  // f32 (build) or uall's [128, 64] tile in boxes (warpgroup g, slots
  // 32 kb) (f32) or (g) (bf16) of 64 rows.
  static constexpr int kV = 0;
  static constexpr int kVBoxes = kTf32 ? 4 : 2;
  static constexpr int kSrc = kVBoxes * kBox;
  static constexpr int kUb = kSrc;
  static constexpr int kSc = kUb + kWin * kUbPitch * 4;
  static constexpr int kSrcBytes =
      ASRC == kBuild ? kWin * kUbPitch * 4 + kScaleRows * kChunk * 4
                     : kVBoxes * kBox;
  static constexpr int kTx = kSrc + kSrcBytes;
  static constexpr int kStage = round1k(kTx);
  // A warpgroup's U^T [64 rows, 64 slots] plane is two boxes; the build
  // forms keep hi and lo planes, the stream forms lo only.
  static constexpr int kPlane = 2 * kBox;
  static constexpr int kPlanes = !kTf32 ? 0 : (ASRC == kBuild ? 2 : 1);
  static constexpr int kUBytes = 2 * kPlanes * kPlane;
  static constexpr int kFixed = 2048;        // barriers, alignment slack
  static constexpr int kFit = (kSmemMax - kFixed - kUBytes) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kU = kStages * kStage;
  static constexpr int kBars = kU + kUBytes;
  static constexpr int kUnits = kBars + 2 * 8 * kStages;
  static constexpr int kBytes = kBars + 1024 + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kBytes <= kSmemMax, "over a block's shared memory");
};

// The tensor maps of one launch (TMA descriptors, passed by value).
struct DotMaps {
  CUtensorMap vband;     // [total, 128]: boxes [64 slots, 32 (f32) or 64]
  CUtensorMap ubase;     // [16, total]: boxes [16, 72]
  CUtensorMap scales;    // [8, total]: boxes [8, 64]
  CUtensorMap uall;      // [128, total]: boxes [64 rows, 32 (f32) or 64]
};

// The first block b >= first of pass p (b % PASSES == p).
template <int PASSES>
__device__ __forceinline__ int pass_first(int first, int p) {
  return first + ((p - first % PASSES) % PASSES + PASSES) % PASSES;
}

// A consumer warpgroup's own barrier (ids 1 and 2).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
}

// x = hi + lo + O(2^-22 |x|): hi = TF32(x), lo = TF32(x - hi), both with
// their low 13 bits zero (the tensor cores read no more).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Producer: one thread keeps the ring full. It takes the units of the
// longest-first table one at a time from a counter that all CTAs share, so
// that each unit goes to the CTA that frees up first (ragged runs: 1-35
// blocks at exp_parity's scale), and streams each unit pass after pass,
// then a last stage that holds no work.
template <int COMPUTE, int ASRC, int PASSES>
__device__ void produce(const DotMaps& maps, const DotArgs& a, uint8_t* smem,
                        uint64_t* full, uint64_t* empty, int* units) {
  using L = Layout<COMPUTE, ASRC>;
  constexpr int kVLanes = kLanes / L::kVBoxes;
  const int chunks = a.block_v / kChunk;
  uint32_t it = 0;
  for (;;) {
    const int u = atomicAdd(a.work, 1);
    if (u >= a.num_runs) break;
    const int2 run = a.runs[u];
    if (run.y <= 0) break;
    const int end = run.x + run.y;
    for (int p = 0; p < PASSES; ++p) {
      for (int b = pass_first<PASSES>(run.x, p); b < end; b += PASSES) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % L::kStages;
          bar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
          uint8_t* st = smem + s * L::kStage;
          const int p0 = b * a.block_v + c * kChunk;
          units[s] = u;
          bar_expect_tx(&full[s], L::kTx);
#pragma unroll
          for (int i = 0; i < L::kVBoxes; ++i) {
            tma_2d(st + L::kV + i * kBox, &maps.vband, &full[s],
                   i * kVLanes, p0);
          }
          if constexpr (ASRC == kBuild) {
            tma_2d(st + L::kUb, &maps.ubase, &full[s], p0, 0);
            tma_2d(st + L::kSc, &maps.scales, &full[s], p0, 0);
          } else if constexpr (COMPUTE == kTf32x3) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {   // (g, kb) = (i / 2, i % 2)
              tma_2d(st + L::kSrc + i * kBox, &maps.uall, &full[s],
                     p0 + 32 * (i % 2), 64 * (i / 2));
            }
          } else {
#pragma unroll
            for (int g = 0; g < 2; ++g) {
              tma_2d(st + L::kSrc + g * kBox, &maps.uall, &full[s], p0,
                     64 * g);
            }
          }
        }
      }
    }
  }
  const int s = it % L::kStages;
  bar_wait(&empty[s], ((it / L::kStages) & 1) ^ 1);
  units[s] = -1;
  bar_arrive(&full[s]);
}

// The producer warpgroup's other three warps: zero the buckets no block
// visits (the wrapper leaves out uninitialised), a stride of the grid
// apart, while the consumers run.
template <bool SIDE>
__device__ void zero_unvisited(const DotArgs& a, int t) {
  constexpr int kCols4 = (SIDE ? 2 : 1) * kLanes / 4;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int bucket = blockIdx.x; bucket < a.num_buckets;
       bucket += gridDim.x) {
    if (a.work[1 + bucket]) continue;
    float* base = a.out + bucket * a.stride_bucket;
    for (int e = t; e < kM * kCols4; e += 96) {
      const int m = e / kCols4;
      *reinterpret_cast<float4*>(base + (m / kWin) * a.stride_j +
                                 (m % kWin) * a.stride_r +
                                 4 * (e % kCols4)) = z;
    }
  }
}

// Byte offset of 16-byte chunk q (slots 32 kb + 4 q ..) of row n of a
// K-major 128-byte-swizzled [64 rows, 64 slots] f32 plane (two boxes).
__device__ __forceinline__ int kmajor_off(int n, int kb, int q) {
  return kb * kBox + n * 128 + ((q ^ (n & 7)) << 4);
}

// Warpgroup g's U^T planes from the stage's ubase and scales: rows n =
// 16 jj + r (U row 64 g + n, scale row 4 g + jj, window row r), hi and lo.
// Thread t: window row t / 8, 16-byte chunk t % 8 of each half kb; a warp's
// store covers four whole 128-byte rows.
__device__ __forceinline__ void build_u_tf32(const uint8_t* st, int ub_off,
                                             int sc_off, uint8_t* u_hi,
                                             uint8_t* u_lo, int g, int t) {
  const float* ub = reinterpret_cast<const float*>(st + ub_off);
  const float* sc = reinterpret_cast<const float*>(st + sc_off);
  const int q = t % 8;
  const int r = t / 8;
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    const int k = 32 * kb + 4 * q;
    const float4 u4 = *reinterpret_cast<const float4*>(ub + r * kUbPitch + k);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          sc + (4 * g + jj) * kChunk + k);
      uint4 hi;
      uint4 lo;
      split_tf32(__fmul_rn(u4.x, s4.x), hi.x, lo.x);
      split_tf32(__fmul_rn(u4.y, s4.y), hi.y, lo.y);
      split_tf32(__fmul_rn(u4.z, s4.z), hi.z, lo.z);
      split_tf32(__fmul_rn(u4.w, s4.w), hi.w, lo.w);
      const int off = kmajor_off(16 * jj + r, kb, q);
      *reinterpret_cast<uint4*>(u_hi + off) = hi;
      *reinterpret_cast<uint4*>(u_lo + off) = lo;
    }
  }
}

// The stream forms: the TMA tile (the same layout) is the hi plane as it
// stands, since the tensor cores read an f32 operand as its TF32
// truncation (held on an H100: with lo = TF32(x - trunc(x)) the products
// meet the plain version at 1.06e-6 of max, as with a rounded hi, where a
// rounding unit would leave errors of 2^-11); its lo plane beside it.
__device__ __forceinline__ void split_u_tf32(const uint8_t* u_hi,
                                             uint8_t* u_lo, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = (i * 128 + t) * 16;
    const uint4 x = *reinterpret_cast<const uint4*>(u_hi + off);
    uint4 lo;
    lo.x = tf32_rna(__uint_as_float(x.x) - __uint_as_float(x.x & ~0x1FFFu));
    lo.y = tf32_rna(__uint_as_float(x.y) - __uint_as_float(x.y & ~0x1FFFu));
    lo.z = tf32_rna(__uint_as_float(x.z) - __uint_as_float(x.z & ~0x1FFFu));
    lo.w = tf32_rna(__uint_as_float(x.w) - __uint_as_float(x.w & ~0x1FFFu));
    *reinterpret_cast<uint4*>(u_lo + off) = lo;
  }
}

// acc[t] += one stage's out^T tile t [64 lanes, 64 U rows] in KSPLIT
// parts, each summed fresh on the tensor cores. Warp w's A rows (lanes) of
// tile t are 32 w + 4 gid + 2 t (+1 for rows gid + 8), so one float4 of
// the staged row (box w) feeds both tiles; k-step ks takes slots 8 ks + tig
// (a0, a1) and + 4 (a2, a3). B = U^T at slots 8 ks .. (32 bytes a step
// along the swizzled row, the next box past 32 slots) of the planes at
// shared addresses hi and lo.
template <int KSPLIT>
__device__ __forceinline__ void tf32_stage(const uint8_t* vt, uint32_t hi,
                                           uint32_t lo, int gid, int tig,
                                           float (&acc)[2][32]) {
  constexpr int kSteps = kChunk / 8;
  constexpr int kPer = kSteps / KSPLIT;
#pragma unroll
  for (int sub = 0; sub < KSPLIT; ++sub) {
    float f[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      f[0][i] = 0.0f;
      f[1][i] = 0.0f;
    }
    uint32_t ah[2][2][4];
    uint32_t al[2][2][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int ks = sub * kPer + i;
      const int bf = i & 1;
      const int k0 = 8 * ks + tig;
      const int k1 = k0 + 4;
      const float4 v0 = *reinterpret_cast<const float4*>(
          vt + k0 * 128 + ((gid ^ (k0 & 7)) << 4));
      const float4 v1 = *reinterpret_cast<const float4*>(
          vt + k1 * 128 + ((gid ^ (k1 & 7)) << 4));
      split_tf32(v0.x, ah[bf][0][0], al[bf][0][0]);
      split_tf32(v0.y, ah[bf][0][1], al[bf][0][1]);
      split_tf32(v1.x, ah[bf][0][2], al[bf][0][2]);
      split_tf32(v1.y, ah[bf][0][3], al[bf][0][3]);
      split_tf32(v0.z, ah[bf][1][0], al[bf][1][0]);
      split_tf32(v0.w, ah[bf][1][1], al[bf][1][1]);
      split_tf32(v1.z, ah[bf][1][2], al[bf][1][2]);
      split_tf32(v1.w, ah[bf][1][3], al[bf][1][3]);
      const int boff = (ks / 4) * kBox + (ks % 4) * 32;
      const uint64_t dh = desc_sw128_at(hi + boff, 16, 1024);
      const uint64_t dl = desc_sw128_at(lo + boff, 16, 1024);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        mma_tf32_rs_n64(f[t], al[bf][t], dh, i > 0);
        mma_tf32_rs_n64(f[t], ah[bf][t], dl, 1);
        mma_tf32_rs_n64(f[t], ah[bf][t], dh, 1);
      }
      wg_commit();
      if (i > 0) {
        // k-step i - 1 is done: its fragments may be overwritten.
        wg_wait<1>();
        fence_regs(ah[bf ^ 1][0]);
        fence_regs(ah[bf ^ 1][1]);
        fence_regs(al[bf ^ 1][0]);
        fence_regs(al[bf ^ 1][1]);
      }
    }
    wg_wait_all();
#pragma unroll
    for (int b2 = 0; b2 < 2; ++b2) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        fence_regs(ah[b2][t]);
        fence_regs(al[b2][t]);
      }
    }
    fence_regs(f[0]);
    fence_regs(f[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[0][i] = __fadd_rn(acc[0][i], f[0][i]);
      acc[1][i] = __fadd_rn(acc[1][i], f[1][i]);
    }
  }
}

// A slot pass after one of the run that stored: v[i] = (the sums stored
// at dst(i)) + v[i], all loaded first (one round trip to memory, not one a
// value: loaded and added in turn they cost exp_parity's slots4 0.25 ms).
template <int N, typename Dst>
__device__ __forceinline__ void add_stored(float4 (&v)[N], Dst dst) {
  float4 o[N];
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = *reinterpret_cast<const float4*>(dst(i));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = make_float4(__fadd_rn(o[i].x, v[i].x), __fadd_rn(o[i].y, v[i].y),
                       __fadd_rn(o[i].z, v[i].z), __fadd_rn(o[i].w, v[i].w));
  }
}

// The units the producer takes reach the consumers through the ring: it
// writes a stage's unit (-1: no more stages) before the stage's barrier
// arrive (a release), and they read it after their wait at a unit's first
// stage (`it`); the rest of a unit's stage sequence follows from its run.
template <int STAGES>
__device__ __forceinline__ int next_unit(uint64_t* full, const int* units,
                                         uint32_t it) {
  bar_wait(&full[it % STAGES], (it / STAGES) & 1);
  return units[it % STAGES];
}

template <int ASRC, int PASSES, int KSPLIT, bool SIDE>
__device__ void consume_tf32(const DotArgs& a, uint8_t* smem, uint64_t* full,
                             uint64_t* empty, const int* units, int g) {
  using L = Layout<kTf32x3, ASRC>;
  const int t = threadIdx.x % 128;
  const int w = t / 32;
  const int lane = t % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  uint8_t* planes = smem + L::kU + g * L::kPlanes * L::kPlane;
  uint8_t* u_lo = ASRC == kBuild ? planes + L::kPlane : planes;
  const int chunks = a.block_v / kChunk;
  uint32_t it = 0;
  for (int u; (u = next_unit<L::kStages>(full, units, it)) >= 0;) {
    const int2 run = a.runs[u];
    const int end = run.x + run.y;
    const int bucket = a.bucket_ids[SIDE ? (run.x & ~1) : run.x];
    bool stored = false;
    for (int p = 0; p < PASSES; ++p) {
      int b = pass_first<PASSES>(run.x, p);
      if (b >= end) continue;
      float acc[2][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[0][i] = 0.0f;
        acc[1][i] = 0.0f;
      }
      for (; b < end; b += PASSES) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % L::kStages;
          bar_wait(&full[s], (it / L::kStages) & 1);
          uint8_t* st = smem + s * L::kStage;
          uint8_t* u_hi =
              ASRC == kBuild ? planes : st + L::kSrc + 2 * g * kBox;
          // The warpgroup's previous products are complete (their wait),
          // so its planes are free.
          if constexpr (ASRC == kBuild) {
            build_u_tf32(st, L::kUb, L::kSc, u_hi, u_lo, g, t);
          } else {
            split_u_tf32(u_hi, u_lo, t);
          }
          // Generic-proxy writes, read next by wgmma (the async proxy).
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          group_sync(g);
          // Opaque from stage to stage: the build forms' planes are fixed,
          // and their 16 descriptors, hoisted out of the loops, would take
          // 32 registers for the whole kernel.
          uint32_t hi = smem_u32(u_hi);
          uint32_t lo = smem_u32(u_lo);
          asm volatile("" : "+r"(hi), "+r"(lo));
          tf32_stage<KSPLIT>(st + L::kV + w * kBox, hi, lo, gid, tig, acc);
          __syncwarp();
          if (lane == 0) bar_arrive(&empty[s]);
        }
      }
      // Fragment i of tile tt: lane 32 w + 4 gid + 2 tt + ((i >> 1) & 1),
      // U row 64 g + 8 (i >> 2) + 2 tig + (i & 1); v[2 q + e] holds U row
      // 64 g + 8 q + 2 tig + e, four lanes from 32 w + 4 gid.
      float* base = a.out + bucket * a.stride_bucket +
                    (SIDE ? p * kLanes : 0) + 32 * w + 4 * gid;
      const auto dst = [&](int i) {
        const int m = 64 * g + 8 * (i / 2) + 2 * tig + i % 2;
        return base + (m / kWin) * a.stride_j + (m % kWin) * a.stride_r;
      };
      float4 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int i0 = 4 * (i / 2) + i % 2;
        v[i] = make_float4(acc[0][i0], acc[0][i0 + 2], acc[1][i0],
                           acc[1][i0 + 2]);
      }
      if (!SIDE && stored) add_stored(v, dst);
#pragma unroll
      for (int i = 0; i < 16; ++i) *reinterpret_cast<float4*>(dst(i)) = v[i];
      stored = true;
    }
  }
}

template <int ASRC, int PASSES, int KSPLIT, bool SIDE>
__device__ void consume_bf16(const DotArgs& a, uint8_t* smem, uint64_t* full,
                             uint64_t* empty, const int* units, int g) {
  static_assert(SIDE || PASSES == 1, "no bf16 slot forms: passes store");
  using L = Layout<kBf16, ASRC>;
  constexpr int kSteps = kChunk / 16;
  constexpr int kPer = kSteps / KSPLIT;
  const int t = threadIdx.x % 128;
  const int w = t / 32;
  const int lane = t % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int j = 4 * g + w;          // warp w's 16 U rows: scale row j
  const int chunks = a.block_v / kChunk;
  uint32_t it = 0;
  for (int u; (u = next_unit<L::kStages>(full, units, it)) >= 0;) {
    const int2 run = a.runs[u];
    const int end = run.x + run.y;
    const int bucket = a.bucket_ids[SIDE ? (run.x & ~1) : run.x];
    for (int p = 0; p < PASSES; ++p) {
      int b = pass_first<PASSES>(run.x, p);
      if (b >= end) continue;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (; b < end; b += PASSES) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % L::kStages;
          bar_wait(&full[s], (it / L::kStages) & 1);
          const uint8_t* st = smem + s * L::kStage;
          // Build: U's fragment rows gid, gid + 8 of warp w; slots 16 ks +
          // 2 tig (+1) and + 8 (register e: row + 8 (e & 1), slot
          // + 8 (e >> 1)), rounded to bf16 once.
          uint32_t af[kSteps][4];
          if constexpr (ASRC == kBuild) {
            const float* ub = reinterpret_cast<const float*>(st + L::kUb);
            const float* sc =
                reinterpret_cast<const float*>(st + L::kSc) + j * kChunk;
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = gid + 8 * (e & 1);
                const int pp = 16 * ks + 2 * tig + 8 * (e >> 1);
                const float2 u2 =
                    *reinterpret_cast<const float2*>(ub + r * kUbPitch + pp);
                const float2 s2 = *reinterpret_cast<const float2*>(sc + pp);
                af[ks][e] = bf16_pair(__fmul_rn(u2.x, s2.x),
                                      __fmul_rn(u2.y, s2.y));
              }
            }
          }
#pragma unroll
          for (int sub = 0; sub < KSPLIT; ++sub) {
            float f[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) f[i] = 0.0f;
            wg_fence();
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              const int ks = sub * kPer + i;
              // Slots 16 ks ..: 2048 bytes into each 64-lane box.
              const uint64_t db = desc_sw128(st + L::kV + 2048 * ks, kBox,
                                             1024);
              if constexpr (ASRC == kBuild) {
                mma_rs_n128(f, af[ks], db, i > 0);
              } else {
                const uint64_t da =
                    desc_sw128(st + L::kSrc + g * kBox + 32 * ks, 16, 1024);
                mma_ss_n128(f, da, db, i > 0);
              }
            }
            wg_commit();
            wg_wait_all();
            fence_regs(f);
            if constexpr (ASRC == kBuild) {
#pragma unroll
              for (int ks = 0; ks < kSteps; ++ks) fence_regs(af[ks]);
            }
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
          }
          __syncwarp();
          if (lane == 0) bar_arrive(&empty[s]);
        }
      }
      // Fragment i: U row 16 w + gid + 8 ((i >> 1) & 1), lane 8 (i >> 2) +
      // 2 tig + (i & 1).
      float* base = a.out + bucket * a.stride_bucket + j * a.stride_j +
                    (SIDE ? p * kLanes : 0) + 2 * tig;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = gid + 8 * ((i >> 1) & 1);
        *reinterpret_cast<float2*>(base + r * a.stride_r + 8 * (i >> 2)) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

template <int COMPUTE, int ASRC, int PASSES, int KSPLIT, bool SIDE>
__global__ void __launch_bounds__(kThreads, 1)
bucket_dot_kernel(const __grid_constant__ DotMaps maps, const DotArgs a) {
  using L = Layout<COMPUTE, ASRC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  int* units = reinterpret_cast<int*>(smem + L::kUnits);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce<COMPUTE, ASRC, PASSES>(maps, a, smem, full, empty, units);
    } else if (threadIdx.x >= 32) {
      zero_unvisited<SIDE>(a, threadIdx.x - 32);
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  if constexpr (COMPUTE == kTf32x3) {
    consume_tf32<ASRC, PASSES, KSPLIT, SIDE>(a, smem, full, empty, units,
                                             wg - 1);
  } else {
    consume_bf16<ASRC, PASSES, KSPLIT, SIDE>(a, smem, full, empty, units,
                                             wg - 1);
  }
}

// The kernel's scratch, before it: the unit counter 0, then a flag a
// bucket, 1 where a block visits it (block b with b % step == 0; npair
// keys its pairs by the even block). One CTA.
__global__ void __launch_bounds__(1024)
dot_work_kernel(const int* bucket_ids, int nb, int step, int* work,
                int num_buckets) {
  for (int i = threadIdx.x; i <= num_buckets; i += blockDim.x) work[i] = 0;
  __syncthreads();
  for (int b = threadIdx.x * step; b < nb; b += blockDim.x * step) {
    work[1 + bucket_ids[b]] = 1;
  }
}

template <int COMPUTE, int ASRC, int PASSES = 1, int KSPLIT = 1,
          bool SIDE = false>
int launch_tc(const DotArgs& a, cudaStream_t s) {
  using L = Layout<COMPUTE, ASRC>;
  const bool bf16 = COMPUTE == kBf16;
  DotMaps maps;
  if (!make_map(&maps.vband, a.vband, bf16, kLanes, a.total, bf16 ? 64 : 32,
                kChunk, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (ASRC == kBuild) {
    if (!make_map(&maps.ubase, a.ubase, false, a.total, kWin, kUbPitch, kWin,
                  false) ||
        !make_map(&maps.scales, a.scales, false, a.total, kScaleRows, kChunk,
                  kScaleRows, false)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    maps.uall = maps.ubase;          // unused
  } else {
    if (!make_map(&maps.uall, a.uall, bf16, a.total, kM, bf16 ? 64 : 32, 64,
                  true)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    maps.ubase = maps.uall;          // unused
    maps.scales = maps.uall;
  }
  const auto kernel = bucket_dot_kernel<COMPUTE, ASRC, PASSES, KSPLIT, SIDE>;
  // One CTA an SM: units enough for each, or buckets to zero.
  const int ctas = grid_size(a.num_runs > a.num_buckets ? a.num_runs
                                                        : a.num_buckets);
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_work_kernel<<<1, 1024, 0, s>>>(a.bucket_ids, a.nb, SIDE ? 2 : 1,
                                      a.work, a.num_buckets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, kThreads, L::kBytes, s>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// -- CUDA-core forms (prod_simt, nodot) ---------------------------------------

constexpr int kHalf = 64;        // columns a CTA owns
constexpr int kCoreThreads = 256;
constexpr int kKC = 32;          // slots staged a step
constexpr int kLdA = kKC + 4;    // shared leading dimensions, padded
constexpr int kLdB = kHalf + 4;
constexpr int kCoreSmem = (kM * kLdA + kKC * kLdB) * 4;

// Stage U [128][32] and V [32][64] of slots k0 .. k0 + 31 (V's columns
// half * 64 ..) into shared memory.
template <int ASRC>
__device__ __forceinline__ void stage_f32(const DotArgs& a, int64_t k0,
                                          int half, float* smem) {
  float* as = smem;
  float* bs = as + kM * kLdA;
  const int tid = threadIdx.x;
  const int64_t total = a.total;
  for (int idx = tid; idx < kM * kKC; idx += kCoreThreads) {
    const int m = idx / kKC;
    const int k = idx % kKC;
    const int64_t col = k0 + k;
    if constexpr (ASRC == kBuild) {
      as[m * kLdA + k] = __fmul_rn(a.ubase[(m % kWin) * total + col],
                                   a.scales[(m / kWin) * total + col]);
    } else {
      as[m * kLdA + k] = static_cast<const float*>(a.uall)[m * total + col];
    }
  }
  for (int idx = tid; idx < kKC * kHalf; idx += kCoreThreads) {
    const int k = idx / kHalf;
    const int n = idx % kHalf;
    bs[k * kLdB + n] = static_cast<const float*>(
        a.vband)[(k0 + k) * kLanes + half * kHalf + n];
  }
}

// f32 FMAs on the CUDA cores: thread (ty, tx) owns rows 8 ty .. 8 ty + 7
// and columns 4 tx .. 4 tx + 3 of the CTA's half.
template <int ASRC>
__device__ void run_simt(const DotArgs& a, int b0, int b1, int bucket,
                         int half, float* smem) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int nkc = a.block_v / kKC;
  const float* as = smem;
  const float* bs = as + kM * kLdA;
  float acc[8][4] = {};
  for (int b = b0; b < b1; ++b) {
    for (int kc = 0; kc < nkc; ++kc) {
      stage_f32<ASRC>(a, static_cast<int64_t>(b) * a.block_v + kc * kKC,
                      half, smem);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * kLdB +
                                                          tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float u = as[(ty * 8 + i) * kLdA + k];
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

// A CTA a block and 64-column half: the CTA of a run's first block takes
// the run, the others exit.
template <int COMPUTE>
__global__ void __launch_bounds__(kCoreThreads)
bucket_dot_cuda_core_kernel(DotArgs a) {
  __shared__ __align__(128) float smem[kCoreSmem / 4];
  const int b0 = blockIdx.x;
  const int half = blockIdx.y;
  if (b0 >= a.nb) return;
  const int bucket = a.bucket_ids[b0];
  if (b0 > 0 && a.bucket_ids[b0 - 1] == bucket) return;
  int b1 = b0 + 1;
  while (b1 < a.nb && a.bucket_ids[b1] == bucket) ++b1;
  if constexpr (COMPUTE == kNoDot) {
    run_nodot(a, b0, b1, bucket, half);
  } else {
    run_simt<kBuild>(a, b0, b1, bucket, half, smem);
  }
}

template <int COMPUTE>
int launch_core(const DotArgs& a, cudaStream_t s) {
  const dim3 grid(a.nb, kLanes / kHalf);
  bucket_dot_cuda_core_kernel<COMPUTE><<<grid, kCoreThreads, 0, s>>>(a);
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
// stride_bucket + n (npair: n < 256); block_v is a multiple of 128 and the
// strides of 8 (32-byte rows). The tensor-core forms (all but 2 and 11)
// walk runs [num_runs] (first block, block count) int32 pairs: maximal
// runs of consecutive blocks of one bucket (npair: of block pairs, keyed
// by ids[b & ~1], from even blocks), longest first, rows of count 0 last,
// with work [1 + num_buckets] int32 scratch (its contents are set first);
// they write every bucket of out, those no block visits as zero. The
// CUDA-core forms find the runs themselves, ignore both and write the
// visited buckets only.
int sdp_torch_bucket_dot(int variant, const int* bucket_ids, const int* runs,
                         int num_runs, int* work, int num_buckets,
                         const float* ubase,
                         const float* scales, const void* uall,
                         const void* vband, int64_t total, int nb,
                         int block_v, float* out, int64_t stride_j,
                         int64_t stride_r, int64_t stride_bucket,
                         void* stream) {
  const bool core = variant == 2 || variant == 11;
  if (variant < 0 || variant > 13 || nb < 0 || block_v < kLanes ||
      block_v % kLanes != 0 || total < static_cast<int64_t>(nb) * block_v ||
      total >= (int64_t{1} << 31) || stride_r % 8 != 0 ||
      stride_j % 8 != 0 || stride_bucket % 8 != 0 ||
      (!core &&
       (runs == nullptr || num_runs < 0 || work == nullptr ||
        num_buckets < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (core ? nb == 0 : num_buckets == 0) return 0;
  const DotArgs a{bucket_ids, reinterpret_cast<const int2*>(runs), num_runs,
                  work, num_buckets, ubase, scales, uall, vband, total, nb,
                  block_v, out, stride_j, stride_r, stride_bucket};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_tc<kTf32x3, kBuild>(a, s);
    case 1: return launch_tc<kBf16, kBuild>(a, s);
    case 2: return launch_core<kSimt>(a, s);
    case 3: return launch_tc<kTf32x3, kStream>(a, s);
    case 4: return launch_tc<kBf16, kStream>(a, s);
    case 5: return launch_tc<kTf32x3, kBuild, 1, 2>(a, s);
    case 6: return launch_tc<kTf32x3, kBuild, 1, 4>(a, s);
    case 7: return launch_tc<kBf16, kBuild, 1, 2>(a, s);
    case 8: return launch_tc<kBf16, kBuild, 1, 4>(a, s);
    case 9: return launch_tc<kTf32x3, kBuild, 2, 1, true>(a, s);
    case 10: return launch_tc<kBf16, kBuild, 2, 1, true>(a, s);
    case 11: return launch_core<kNoDot>(a, s);
    case 12: return launch_tc<kTf32x3, kBuild, 2>(a, s);
    default: return launch_tc<kTf32x3, kBuild, 4>(a, s);
  }
}

}  // extern "C"
