// Build / product overlap probe for Hopper (sm_90a): can tap builds on the
// CUDA cores run while tensor-core products run, inside one kernel?
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
//   both2  the same sums, the build of the next stage issued while the
//          products of this one run (software pipelining).
// The TPU kernel's output is the last block's acc [128, 128]. A kernel
// that computed only that block would compute the same function at 1/4096
// of the work, so this one also writes each block's sum |acc| [num_blocks],
// which the plain version checks: no block's work can be skipped. For the
// same reason vpu builds and stages every slot, as the TPU kernel does,
// though it reads one slot a chunk: a vpu that built only those slots would
// compute the same function at 1/SUB of the work and measure nothing.
//
// What bounds it on an H100: the product, 3 x 2 x 128 x 128 TF32 operations
// a slot (f32 operands split into TF32 hi + lo, three passes), 0.83 ms at
// 4M slots and 495 TFLOP/s; the build, ~1,000 f32 operations a slot on the
// CUDA cores (0.06 ms at 67 TFLOP/s) and ~1 KB of staging stores a slot;
// the products' B reads, 3 KB of shared memory a slot. The design (after
// bucket_dot.cu):
//   - one CTA an SM takes the blocks a stride of the grid apart; a block is
//     a sequence of stages of 64 slots (32 where the block is no multiple
//     of 64);
//   - the tensor cores compute out^T = V^T U^T. A TF32 wgmma reads its
//     shared-memory operand K-major only, so the build writes U^T's hi and
//     lo planes slot-contiguous in the 128-byte swizzled layout (hi: u's raw
//     f32, since the tensor cores read an f32 operand as its TF32
//     truncation; lo = TF32(u - trunc(u))), and V, 8 nonzero lanes of 128 a
//     slot, as a compact record (vk[8] raw and lo, iv / 8) that the
//     consumers expand into the register A operand. Each of two consumer
//     warpgroups owns 64 lanes (rows of out^T): three wgmma m64n128k8 a
//     k-step, each stage summed into fresh fragments and added to the
//     running sums on the CUDA cores (the tensor cores' own f32
//     accumulation truncates: over 1024 slots it drifted by 1.8e-5 of max
//     on an H100 80GB HBM3);
//   - the build is a thread a (slot, tap), a warp four slots' eight taps:
//     the eight taps of a slot fall on eight 16-byte swizzle chunks, so
//     every row store of a warp hits 32 banks; a slot's w taps cross lanes
//     by shuffles; a thread's slots run their Clenshaw chains in lockstep,
//     and a stage's words are loaded while the one before it is built;
//   - dot, vpu and both are warp-specialised: builder warps (two
//     warpgroups; one for dot's cast) fill a ring of three stages under
//     mbarriers while the two consumer warpgroups multiply (dot, both) or
//     add the chunks' rank-one terms (vpu);
//   - both2 is not: each of two warpgroups issues half a stage's products
//     asynchronously, builds its share of the next stage into the other of
//     two buffers while they run, waits, and the two meet at one barrier a
//     stage.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

enum Variant { kDot = 0, kVpu = 1, kBoth = 2, kBoth2 = 3 };

constexpr int kS = 8;              // taps
constexpr int kRows = 128;         // rows of U: the columns of out^T
constexpr int kStage = 64;         // slots a stage holds at most
constexpr int kMaxCoeffs = 16;
constexpr int kBox = kRows * 128;  // U^T [128 rows, 32 slots]: 128 B a row
constexpr int kPlane = 2 * kBox;   // U^T [128 rows, 64 slots]
// A stage: U^T's hi and lo planes, then V's records v[slot][tap] (raw f32),
// vl[slot][tap] (lo) and grp[slot] = iv / 8.
constexpr int kV = 2 * kPlane;
constexpr int kVl = kV + kStage * kS * 4;
constexpr int kGrp = kVl + kStage * kS * 4;
constexpr int kStageBytes = (kGrp + kStage * 4 + 1023) / 1024 * 1024;
constexpr int kConsumerWarps = 8;
constexpr int kSmemMax = 232448;
constexpr uint32_t kTf32Hi = 0xFFFFE000u;

// The split forms' builder warps: two warpgroups for the Clenshaw build
// (with one, vpu and both ran slower), one for dot's cast (with two, dot
// ran slower: its builders idle at the ring). Per-thread registers: 168 at
// launch (384 threads), then builders give up 48 and consumers take 24
// (120 x 128 + 192 x 256 = 168 x 384); or 128 (512 threads), then
// 72 x 256 + 184 x 256.
template <int VARIANT>
struct Layout {
  static constexpr int kBuilderWarps = VARIANT == kDot ? 4 : 8;
  static constexpr bool kSplit = VARIANT != kBoth2;   // warp-specialised
  static constexpr int kBuilders = 32 * kBuilderWarps;
  static constexpr int kBuilderRegs = kBuilderWarps == 4 ? 120 : 72;
  static constexpr int kConsumerRegs = kBuilderWarps == 4 ? 192 : 184;
  static constexpr int kThreads = kSplit ? kBuilders + 256 : 256;
  static constexpr int kStages = kSplit ? 3 : 2;
  static constexpr int kBars = kStages * kStageBytes;     // full, empty
  static constexpr int kRed = kBars + 2 * 8 * kStages;    // block sums' parts
  static constexpr int kBytes = kRed + 2 * kConsumerWarps * 4 + 1024;
  static_assert(kBytes <= kSmemMax, "over a block's shared memory");
};

struct OverlapArgs {
  const int* pa;
  const int* pb;
  const float* coeffs;     // [ncoef][8]
  int ncoef;
  int block;               // slots a block
  int sub;                 // slots a chunk
  int stage;               // slots a stage: 64, or 32 (block % 64 != 0)
  int num_blocks;
  float* out;              // [128][128]: the last block's acc
  float* block_sums;       // [num_blocks]: sum |acc| of each block
};

// x's TF32 lo part where its hi is its TF32 truncation: x = trunc(x) + lo
// + O(2^-22 |x|).
__device__ __forceinline__ float tf32_lo(float x) {
  return __uint_as_float(tf32_rna(
      __fsub_rn(x, __uint_as_float(__float_as_uint(x) & kTf32Hi))));
}

// Byte offset of (row m, slot k) in a U^T plane, K-major in the 128-byte
// swizzle: box k / 32, row m, 16-byte chunk (k / 4) % 8 XOR m % 8.
__device__ __forceinline__ int plane_off(int m, int k) {
  return (k >> 5) * kBox + m * 128 + ((((k >> 2) & 7) ^ (m & 7)) << 4) +
         ((k & 3) << 2);
}

// Clenshaw's backward recurrence of one tap's coefficient column c, held in
// registers, at N arguments x in lockstep (one uniform branch a step, so a
// warp has N independent chains to issue): b1 = c[k] + (2x) b1 - b2 for
// k = ncoef - 1 .. 1, then c[0] + x b1 - b2, every operation rounded on its
// own in the plain version's order.
template <int N>
__device__ __forceinline__ void clenshaw_n(const float (&x)[N],
                                           const float (&c)[kMaxCoeffs],
                                           int ncoef, float (&out)[N]) {
  float two_x[N];
  float b1[N];
  float b2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    two_x[i] = __fmul_rn(2.0f, x[i]);
    b1[i] = 0.0f;
    b2[i] = 0.0f;
  }
#pragma unroll
  for (int k = kMaxCoeffs - 1; k >= 1; --k) {
    if (k < ncoef) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float b =
            __fsub_rn(__fadd_rn(c[k], __fmul_rn(two_x[i], b1[i])), b2[i]);
        b2[i] = b1[i];
        b1[i] = b;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[i] = __fsub_rn(__fadd_rn(c[0], __fmul_rn(x[i], b1[i])), b2[i]);
  }
}

__device__ __forceinline__ void load_coeffs(const OverlapArgs& a, int s,
                                            float (&c)[kMaxCoeffs]) {
#pragma unroll
  for (int k = 0; k < kMaxCoeffs; ++k) {
    c[k] = k < a.ncoef ? a.coeffs[k * kS + s] : 0.0f;
  }
}

__device__ __forceinline__ float word_x(int word) {
  return __fsub_rn(__fmul_rn(static_cast<float>(word), 1e-7f), 0.5f);
}

// Thread (slot k of the stage, tap s) writes its tap's rows of U^T's hi and
// lo planes, zeros included, and its entries of V's records, from its taps
// uk, vk, wk (dot: from the words). A slot's eight taps are lanes 8 (lane /
// 8) .. + 7; all 32 lanes take part (the w taps cross lanes by shuffles).
template <int VARIANT>
__device__ __forceinline__ void store_unit(uint8_t* st, int k, int s, int pa,
                                           int pb, float uk, float vk,
                                           float wk) {
  if constexpr (VARIANT == kDot) {
    // Every row: rows 8 h + s of tap s, one swizzle chunk for all.
    const float fu = __fmul_rn(static_cast<float>(pa), 1e-9f);
    const float fl = tf32_lo(fu);
    const int off = plane_off(s, k);
#pragma unroll
    for (int h = 0; h < kRows / 8; ++h) {
      *reinterpret_cast<float*>(st + off + h * 1024) = fu;
      *reinterpret_cast<float*>(st + kPlane + off + h * 1024) = fl;
    }
    vk = __fmul_rn(static_cast<float>(pb), 1e-9f);
  } else {
    const int first = (threadIdx.x & 31) & ~7;
    float u[4];
    float ul[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = __fmul_rn(uk, __shfl_sync(0xffffffffu, wk, first + j));
      ul[j] = tf32_lo(u[j]);
    }
    // Tap s's row of each group of 16 and one of its zero rows: both
    // congruent to uo + s mod 8, so one swizzle chunk.
    const int r = (pb & 7) + s;
    const int z = (r + 8) & 15;
    const int off = plane_off(r, k) - r * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ov = off + (16 * j + r) * 128;
      const int oz = off + (16 * j + z) * 128;
      *reinterpret_cast<float*>(st + ov) = u[j & 3];
      *reinterpret_cast<float*>(st + kPlane + ov) = ul[j & 3];
      *reinterpret_cast<float*>(st + oz) = 0.0f;
      *reinterpret_cast<float*>(st + kPlane + oz) = 0.0f;
    }
    if (s == 0) reinterpret_cast<int*>(st + kGrp)[k] = (pa & 120) >> 3;
  }
  reinterpret_cast<float*>(st + kV)[k * kS + s] = vk;
  reinterpret_cast<float*>(st + kVl)[k * kS + s] = tf32_lo(vk);
}

// U units at once: thread (slot k[u] of the stage, tap s) for u < U, their
// 3 U Clenshaw chains in lockstep.
template <int VARIANT, int U>
__device__ __forceinline__ void build_units(uint8_t* st, const int* k, int s,
                                            const int* pa, const int* pb,
                                            const float (&c)[kMaxCoeffs],
                                            int ncoef) {
  float t[3 * U] = {};
  if constexpr (VARIANT != kDot) {
    float x[3 * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x[3 * u] = word_x(pa[u]);
      x[3 * u + 1] = word_x(pb[u]);
      x[3 * u + 2] = word_x(pa[u] ^ pb[u]);
    }
    clenshaw_n<3 * U>(x, c, ncoef, t);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    store_unit<VARIANT>(st, k[u], s, pa[u], pb[u], t[3 * u], t[3 * u + 1],
                        t[3 * u + 2]);
  }
}

// A = V^T's k-step ks (slots 8 ks ..): a0 (row gid, slot k0 = 8 ks + tig),
// a1 (row gid + 8, k0), a2 (row gid, k1 = k0 + 4), a3 (row gid + 8, k1). Row
// r of warp w of consumer warpgroup g is lane 64 g + 16 w + r, so rows gid
// and gid + 8 lie in the 8-lane groups grp and grp + 1, at gid:
// V[k][lane] = vk[k][gid] where the slot's group is the row's, else 0 (dot:
// every lane).
template <int VARIANT>
__device__ __forceinline__ void a_frag(const uint8_t* st, int ks, int grp,
                                       int gid, int tig, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float* v = reinterpret_cast<const float*>(st + kV);
  const float* vl = reinterpret_cast<const float*>(st + kVl);
  const int k0 = 8 * ks + tig;
  const int k1 = k0 + 4;
  const uint32_t h0 = __float_as_uint(v[k0 * kS + gid]) & kTf32Hi;
  const uint32_t h1 = __float_as_uint(v[k1 * kS + gid]) & kTf32Hi;
  const uint32_t l0 = __float_as_uint(vl[k0 * kS + gid]);
  const uint32_t l1 = __float_as_uint(vl[k1 * kS + gid]);
  if constexpr (VARIANT == kDot) {
    ah[0] = ah[1] = h0;
    ah[2] = ah[3] = h1;
    al[0] = al[1] = l0;
    al[2] = al[3] = l1;
  } else {
    const int* g = reinterpret_cast<const int*>(st + kGrp);
    const int g0 = g[k0] - grp;
    const int g1 = g[k1] - grp;
    ah[0] = g0 == 0 ? h0 : 0u;
    ah[1] = g0 == 1 ? h0 : 0u;
    ah[2] = g1 == 0 ? h1 : 0u;
    ah[3] = g1 == 1 ? h1 : 0u;
    al[0] = g0 == 0 ? l0 : 0u;
    al[1] = g0 == 1 ? l0 : 0u;
    al[2] = g1 == 0 ? l1 : 0u;
    al[3] = g1 == 1 ? l1 : 0u;
  }
}

// Issue k-steps 4 h .. 4 h + 3 of the stage at st onto f (the stage's first
// starts f afresh) as one commit group: per k-step lo.hi + hi.lo + hi.hi.
// B = U^T at slots 8 ks ..: box ks / 4, 32 bytes a step along its rows.
template <int VARIANT>
__device__ __forceinline__ void issue_half(const uint8_t* st, int h, int grp,
                                           int gid, int tig, float (&f)[64],
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4]) {
  // Opaque from stage to stage, so the descriptors are made in the loop.
  uint32_t hi = smem_u32(st) + h * kBox;
  asm volatile("" : "+r"(hi));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ks = 4 * h + i;
    a_frag<VARIANT>(st, ks, grp, gid, tig, ah[i], al[i]);
    const uint64_t dh = desc_sw128_at(hi + 32 * i, 16, 1024);
    const uint64_t dl = desc_sw128_at(hi + kPlane + 32 * i, 16, 1024);
    wg_fence();
    mma_tf32_rs_n128(f, al[i], dh, ks > 0);
    mma_tf32_rs_n128(f, ah[i], dl, 1);
    mma_tf32_rs_n128(f, ah[i], dh, 1);
  }
  wg_commit();
}

__device__ __forceinline__ void wait_half(float (&f)[64],
                                          uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4]) {
  wg_wait_all();
  fence_regs(f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fence_regs(ah[i]);
    fence_regs(al[i]);
  }
}

// acc += U[:, k] V[k, :] for slot k of the stage, on the CUDA cores with the
// plain version's rounding: U from the hi plane (the raw f32), V from the
// records. Fragment layout as the wgmma accumulator's (below).
__device__ __forceinline__ void rank_one(const uint8_t* st, int k, int grp,
                                         int gid, int tig,
                                         float (&acc)[64]) {
  const int g = reinterpret_cast<const int*>(st + kGrp)[k] - grp;
  const float x = reinterpret_cast<const float*>(st + kV)[k * kS + gid];
  const float va = g == 0 ? x : 0.0f;
  const float vb = g == 1 ? x : 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = 8 * i + 2 * tig;
    const float u0 = *reinterpret_cast<const float*>(st + plane_off(m, k));
    const float u1 =
        *reinterpret_cast<const float*>(st + plane_off(m + 1, k));
    acc[4 * i] = __fadd_rn(acc[4 * i], __fmul_rn(u0, va));
    acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], __fmul_rn(u1, va));
    acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], __fmul_rn(u0, vb));
    acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], __fmul_rn(u1, vb));
  }
}

// The warp's part of the block's sum |acc|, into red.
__device__ __forceinline__ void warp_abs_sum(const float (&acc)[64],
                                             float* red, int warp) {
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) part += fabsf(acc[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, o);
  }
  if (threadIdx.x % 32 == 0) red[warp] = part;
}

// Fragment 4 i + e of a consumer thread: lane n (e < 2) or n + 8, U row
// 8 i + 2 tig + (e & 1); out is [U row][lane].
__device__ __forceinline__ void store_out(float* out, const float (&acc)[64],
                                          int n, int tig) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = 8 * i + 2 * tig;
    out[m * 128 + n] = acc[4 * i];
    out[(m + 1) * 128 + n] = acc[4 * i + 1];
    out[m * 128 + n + 8] = acc[4 * i + 2];
    out[(m + 1) * 128 + n + 8] = acc[4 * i + 3];
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The stages a CTA walks: its blocks a stride of the grid apart, each
// block's stages in order; stage n's first slot.
__device__ __forceinline__ int cta_stages(const OverlapArgs& a) {
  const int blocks =
      (a.num_blocks - static_cast<int>(blockIdx.x) +
       static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  return blocks * (a.block / a.stage);
}

__device__ __forceinline__ int64_t stage_p0(const OverlapArgs& a, int n) {
  const int stages = a.block / a.stage;
  return static_cast<int64_t>(blockIdx.x + gridDim.x * (n / stages)) *
             a.block +
         static_cast<int64_t>(n % stages) * a.stage;
}

// Builder warps of the split forms: warp w of W, lane (slot c = lane / 8 of
// each 4-slot group, tap s = lane % 8) builds groups w, w + W, .. of each
// stage, one arrive a warp. A stage's words are loaded while the one before
// it is built.
template <int VARIANT>
__device__ void build_ring(const OverlapArgs& a, uint8_t* smem,
                           uint64_t* full, uint64_t* empty) {
  using L = Layout<VARIANT>;
  constexpr int kWarps = L::kBuilderWarps;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int s = lane % 8;
  const int c = lane / 8;
  float coef[kMaxCoeffs];
  if constexpr (VARIANT != kDot) load_coeffs(a, s, coef);
  constexpr int kU = 16 / kWarps;
  const int units = a.stage / (4 * kWarps);
  const int total = cta_stages(a);
  int k[kU];
  int pa[kU];
  int pb[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    k[u] = 4 * (w + kWarps * u) + c;
    if (u < units) {
      pa[u] = a.pa[stage_p0(a, 0) + k[u]];
      pb[u] = a.pb[stage_p0(a, 0) + k[u]];
    }
  }
  for (int n = 0; n < total; ++n) {
    int next_pa[kU];
    int next_pb[kU];
    if (n + 1 < total) {
      const int64_t p0 = stage_p0(a, n + 1);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (u < units) {
          next_pa[u] = a.pa[p0 + k[u]];
          next_pb[u] = a.pb[p0 + k[u]];
        }
      }
    }
    const int sl = n % L::kStages;
    bar_wait(&empty[sl], ((n / L::kStages) & 1) ^ 1);
    uint8_t* st = smem + sl * kStageBytes;
    if (units == kU) {
      build_units<VARIANT, kU>(st, k, s, pa, pb, coef, a.ncoef);
    } else {
      build_units<VARIANT, kU / 2>(st, k, s, pa, pb, coef, a.ncoef);
    }
    // Generic-proxy writes, read next by wgmma (the async proxy); one
    // arrive a warp.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) bar_arrive(&full[sl]);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      pa[u] = next_pa[u];
      pb[u] = next_pb[u];
    }
  }
}

// Consumer warpgroup g of the split forms: lanes 64 g .. 64 g + 63.
template <int VARIANT>
__device__ void consume(const OverlapArgs& a, uint8_t* smem, uint64_t* full,
                        uint64_t* empty, float* red, int g) {
  using L = Layout<VARIANT>;
  const int t = threadIdx.x % 128;
  const int w = t / 32;
  const int lane = t % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int grp = 8 * g + 2 * w;
  const int halves = a.stage / 32;
  const int stages = a.block / a.stage;
  float f[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) f[i] = 0.0f;
  uint32_t it = 0;
  int par = 0;
  for (int b = blockIdx.x; b < a.num_blocks; b += gridDim.x, par ^= 1) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int j = 0; j < stages; ++j, ++it) {
      const int sl = it % L::kStages;
      bar_wait(&full[sl], (it / L::kStages) & 1);
      const uint8_t* st = smem + sl * kStageBytes;
      if constexpr (VARIANT == kVpu) {
        const int o = j * a.stage;
        for (int c0 = (o + a.sub - 1) / a.sub * a.sub; c0 < o + a.stage;
             c0 += a.sub) {
          rank_one(st, c0 - o, grp, gid, tig, acc);
        }
      } else {
        uint32_t ah[4][4];
        uint32_t al[4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < halves) {
            issue_half<VARIANT>(st, h, grp, gid, tig, f, ah, al);
            wait_half(f, ah, al);
          }
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[sl]);
    }
    // red holds a parity of blocks: the next writes to this half follow
    // the next block's barrier, which thread 0 passes after its reads.
    warp_abs_sum(acc, red + par * kConsumerWarps, 4 * g + w);
    consumer_sync();
    if (t == 0 && g == 0) {
      float total = 0.0f;
      for (int q = 0; q < kConsumerWarps; ++q) {
        total += red[par * kConsumerWarps + q];
      }
      a.block_sums[b] = total;
    }
    if (b == a.num_blocks - 1) store_out(a.out, acc, 64 * g + 16 * w + gid,
                                         tig);
  }
}

// both2: warpgroup g owns lanes 64 g ..; all 8 warps build, warp q the
// 4-slot groups q and q + 8 of a stage (one a half). The words of the stage
// built in iteration n (stage n + 1) were loaded in iteration n - 1.
__device__ void run_both2(const OverlapArgs& a, uint8_t* smem, float* red) {
  const int tid = threadIdx.x;
  const int g = tid / 128;
  const int w = (tid % 128) / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int s = lane % 8;
  const int c = lane / 8;
  const int grp = 8 * g + 2 * w;
  float coef[kMaxCoeffs];
  load_coeffs(a, s, coef);
  const int halves = a.stage / 32;
  const int stages = a.block / a.stage;
  const int total = cta_stages(a);
  int k[2];
  int pa[2];
  int pb[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    k[u] = 4 * (warp + 8 * u) + c;
    if (u < halves) {
      pa[u] = a.pa[stage_p0(a, 0) + k[u]];
      pb[u] = a.pb[stage_p0(a, 0) + k[u]];
      build_units<kBoth, 1>(smem, k + u, s, pa + u, pb + u, coef, a.ncoef);
      if (total > 1) {
        pa[u] = a.pa[stage_p0(a, 1) + k[u]];
        pb[u] = a.pb[stage_p0(a, 1) + k[u]];
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float f[64];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    f[i] = 0.0f;
    acc[i] = 0.0f;
  }
  for (int n = 0; n < total; ++n) {
    const uint8_t* st = smem + (n & 1) * kStageBytes;
    uint8_t* next = smem + ((n + 1) & 1) * kStageBytes;
    const bool more = n + 1 < total;
    int next_pa[2];
    int next_pb[2];
    if (n + 2 < total) {
      const int64_t p0 = stage_p0(a, n + 2);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u < halves) {
          next_pa[u] = a.pa[p0 + k[u]];
          next_pb[u] = a.pb[p0 + k[u]];
        }
      }
    }
    uint32_t ah[4][4];
    uint32_t al[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h < halves) {
        issue_half<kBoth2>(st, h, grp, gid, tig, f, ah, al);
        // The next stage's unit h while this half's products run.
        if (more) {
          build_units<kBoth, 1>(next, k + h, s, pa + h, pb + h, coef,
                                a.ncoef);
        }
        wait_half(f, ah, al);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
    const bool end = n % stages == stages - 1;
    const int par = (n / stages) & 1;
    if (end) warp_abs_sum(acc, red + par * kConsumerWarps, warp);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (end) {
      const int b = blockIdx.x + gridDim.x * (n / stages);
      if (tid == 0) {
        float sum = 0.0f;
        for (int q = 0; q < kConsumerWarps; ++q) {
          sum += red[par * kConsumerWarps + q];
        }
        a.block_sums[b] = sum;
      }
      if (b == a.num_blocks - 1) store_out(a.out, acc, 64 * g + 16 * w + gid,
                                           tig);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      pa[u] = next_pa[u];
      pb[u] = next_pb[u];
    }
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(Layout<VARIANT>::kThreads, 1)
overlap_kernel(const OverlapArgs a) {
  using L = Layout<VARIANT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1k(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  if constexpr (VARIANT == kBoth2) {
    run_both2(a, smem, red);
  } else {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
    uint64_t* empty = full + L::kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < L::kStages; ++s) {
        bar_init(&full[s], L::kBuilderWarps);
        bar_init(&empty[s], kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int wg = threadIdx.x / 128;
    if (threadIdx.x < L::kBuilders) {
      regs_dec<L::kBuilderRegs>();
      build_ring<VARIANT>(a, smem, full, empty);
      return;
    }
    regs_inc<L::kConsumerRegs>();
    consume<VARIANT>(a, smem, full, empty, red, wg - L::kBuilders / 128);
  }
}

template <int VARIANT>
int launch(const OverlapArgs& a, cudaStream_t s) {
  using L = Layout<VARIANT>;
  const int ctas = grid_size(a.num_blocks);
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      overlap_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  overlap_kernel<VARIANT><<<ctas, L::kThreads, L::kBytes, s>>>(a);
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
      ncoef > kMaxCoeffs || sub < 32 || sub % 32 != 0 || block < sub ||
      block % sub != 0 || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const OverlapArgs a{pa, pb, coeffs, ncoef, block, sub,
                      block % kStage == 0 ? kStage : kStage / 2, num_blocks,
                      out, block_sums};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kDot: return launch<kDot>(a, s);
    case kVpu: return launch<kVpu>(a, s);
    case kBoth: return launch<kBoth>(a, s);
    default: return launch<kBoth2>(a, s);
  }
}

}  // extern "C"
