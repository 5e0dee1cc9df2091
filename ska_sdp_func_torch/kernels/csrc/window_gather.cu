// Window-gather degridding for Hopper (sm_90a): every degrid kernel that
// reads a bucket's window and gathers each slot's S x S x Sw taps from it,
// in its four tap forms, over the plan's bucket runs.
//
// Replace four Pallas TPU kernels of ska_sdp_func_tpu/kernels/, each by
// one form of window_gather_kernel<MODE, FORM>:
//   - fused_tap.py:924 degrid_fused2_stack_pallas (K4; _degrid_fstack_kernel,
//     _degrid_fused_core, _window_from_stack)          -> kStackWords
//   - fused_tap.py:636 degrid_compact_pallas (K13; _degrid_compact_kernel)
//                                                      -> kStackTaps
//   - packed_tap.py:935 degrid_fused_pallas (K11; _degrid_fused_kernel,
//     _degrid_math, _degrid_tail)                      -> kBandTaps
//   - fused_tap.py:814 degrid_fused2_pallas (K19; _degrid_fused_kernel,
//     _degrid_fused_core)                              -> kBandWords
// (The first port ran them as one warp a slot over a flat grid.) The
// Chebyshev chain stage, the row stride and the forms are window.cuh's,
// shared with the grid forms in window_scatter.cu.
//
// What each slot computes, as the plain versions in fused_tap.py and
// band_tap.py:
//   v_h = sum_{j, su, sv} (uk[su] * wk[j]) * P(win[h][j][u_off + su][iv0 + sv],
//                                              vk[sv]),
// h = 0 the real and h = 1 the imaginary half, P the mode's product
// (taps.cuh: kF32 "highest", kHigh the bf16 hi/lo halves, kBf16 the
// bf16-rounded factors), columns iv0 + sv past the window's width dropped.
// The taps come per form: kStackWords / kBandWords evaluate uk, vk and wk
// from the plan words pa = iv0 << 20 | u_off << 17 | w_row and
// pb = valid << 30 | u_frac << 15 | v_frac with taps.cuh's Chebyshev chain
// (each operation rounded on its own, in the plain versions' order), the
// w taps times `valid`; kStackTaps reads uk_t / vk_t [S][total] and wk_t
// [Sw][total] beside pa; kBandTaps reads u_off, iv0 [total], uk, vk
// [total][S] (vk bf16 in kBf16) and wk_t [Sw][total]. A block that
// `nonempty` marks 0 predicts zero. The windows: the stack forms read the
// per-task stacks f32 [T, 2, K (lanes + 8), lanes] at rows
// (k0 + j) (lanes + 8) + 8 g, the band forms the plane stacks f32
// [2, P, rows_pad, lanes_pad] at plane p + j, rows 8 g, lanes 128 hv.
// Each slot's products are P of the same factors as the plain version;
// only the order of its sums differs (within 1e-5 of max|output|).
//
// What bounds it on an H100, and the design. The TPU kernels contract
// dense bands on the MXU (2 Sw 16 lanes MACs a slot); of those only
// 2 Sw S S are not zero, and those are gathers. The work is the gathers:
// at the dense stream (Sw 4, S 8) 512 window cells a slot, 5.9 M slots a
// chunk. The first port fetched each cell from global memory through L1,
// 32 rows a warp-wide load (about 12 ms on an H100 at 700 W). Here each
// window is read from device memory once per work unit and the gathers
// hit shared memory, so the bound is the issue rate of the gather and tap
// instructions (no device-memory or FLOP roofline is near):
//   - work units are bucket runs: (first block, count) rows of the plan's
//     run table, a run being consecutive blocks of one window
//     (packed_tap.run_table; cut into parts of a few blocks so that the
//     grid's static stride over the table balances). One CTA an SM (or
//     more, as occupancy allows) walks the table with a stride of the grid;
//   - a producer warp copies each unit's window, 2 Sw slabs of
//     16 rows x width f32 (slab (h, j)), with 16-byte cp.async into a
//     ring in shared memory, each buffer completing on an mbarrier
//     (cp.async.mbarrier.arrive), so that the next unit's window loads
//     while this one's is gathered. A slab row is padded to
//     round_up(width, 32) + 8 floats, so the row stride is 8 banks mod 32;
//   - the ring holds groups of w-planes, both halves of a plane side by
//     side: the whole window, double-buffered, when two fit (the dense
//     stream: 2 x 68 KiB); else groups of a few planes (the ES-FFT window,
//     Sw 8 x 256 lanes, 256 KiB: 4 groups of 2 planes, double-buffered);
//     else one slab at a time (windows wider than ~1500 lanes), in column
//     tiles past 3104 lanes. A split window cuts its units to kUnitCap
//     slots, whose partial sums the consumer warps keep in registers
//     across the groups;
//   - eight consumer warps take the unit's 32-slot tiles round robin (the
//     rotation runs on across units, so short units do not load the same
//     warps). Per tile, lane i stages slot i's taps in the warp's shared
//     memory: every global load first, or the word forms' 24 Chebyshev
//     sums as independent chains over coefficient rows kept in shared
//     memory. Then the warp gathers kSlots = 4 slots at once with lane
//     (q, sv) = (lane / 8, lane % 8) on cells (u_off + q, iv0 + sv) and
//     (u_off + q + 4, iv0 + sv) of both halves of each plane: with the
//     8-bank row stride the 32 lanes hit 32 distinct banks. When every
//     lane's taps lie inside the window (S 8, away from its edge) the
//     loads carry no predicate; one butterfly of 9 shuffles sums the 8
//     re / im values of the 4 slots; lanes 4 x stage them and lane i
//     writes slot i's re and im once, coalesced (out rows 0 and 1, no
//     atomics);
//   - in kBf16 the consumers round each group's cells to bf16 once, in
//     place, behind a named barrier, instead of once per product.
// Measured on an H100 at 700 W, a slot a warp with guarded per-slab loads
// compiled to dependent load-use chains (5.5 ms at the dense stream); four
// slots at once without branches around the loads issue them together.
// A thread a slot was the other mapping: its 32 lanes gather at 32
// unrelated (row, column) pairs, ~3.5-way bank conflicts at random
// offsets.

#include "window.cuh"

namespace {

constexpr int kWarps = 8;                      // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);    // + the producer warp
constexpr int kTilesPerWarp = 4;               // a split window's tiles
constexpr int kUnitCap = 32 * kWarps * kTilesPerWarp;
constexpr int kTapPad = kMaxS + 1;             // staged tap row (banks)
constexpr int kSlots = 4;                      // slots a warp gathers at once
constexpr int kMaxBuffers = 2;
constexpr unsigned kFull = 0xffffffffu;

// One consumer warp's staged taps of a 32-slot tile.
struct Stage {
  float vk[32 * kTapPad];
  float uk[32 * kTapPad];
  float wk[32 * kTapPad];    // w taps x valid
  int pos[32][2];            // (u_off, iv0); u_off < 0: a zero slot
  float res[2][32];          // the reduced re / im of each slot
};

struct Args {
  const int2* runs;          // [num_runs] (first block, count), longest
                             // first; rows of count 0 end it
  int num_runs;
  // Per block: stack forms (t, k0, g); band forms (p, g, hv).
  const int* i0;
  const int* i1;
  const int* i2;
  const int* nonempty;       // [num_blocks] or null (word forms)
  const int* pa;
  const int* pb;
  const float* c_uv;         // [ncoef][S]
  const float* c_w;          // [ncoef][Sw]
  int ncoef;
  float inv2_ov, inv2_wov;
  const float* uk;           // stack taps: uk_t [S][total]; band: [total][S]
  const void* vk;            // same layout; bf16 in the band kBf16 form
  const float* wk_t;         // [Sw][total]
  const int* u_off;          // band taps: [total]
  const int* iv0;
  const float* base;         // the stack or the planes
  int64_t limit;             // elements of `base`
  int64_t half_stride;       // elements between the re and im halves
  int64_t plane_stride;      // elements between consecutive layers/planes
  int num_layers;            // stack: K (band: unused)
  int row_stride;            // elements between window rows
  int width;                 // window columns (lanes / lanes_win)
  int64_t total;
  int block_v, support, w_support;
  int stride;                // shared row stride (floats)
  int jn;                    // w-planes of a group (of each half)
  int nh;                    // halves of a group: 2, or 1 (one slab)
  int tile_w, ntiles;        // one-slab groups: column tiles of the window
  int ngroups;
  int nbuf;                  // ring buffers of nh x jn slabs
  float* out;                // rows 0 (re) and 1 (im) of [.., total]
};

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The barrier's phase completes once this thread's earlier cp.async are
// done (one of the `count` arrivals it was initialised with).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// -- the work units ----------------------------------------------------------

template <int FORM>
__device__ __forceinline__ int64_t window_origin(const Args& a, int b) {
  if (FORM == kStackWords || FORM == kStackTaps) {
    // (task t, w-slab k0, octet g)
    return (2 * static_cast<int64_t>(a.i0[b]) * a.num_layers + a.i1[b]) *
               a.plane_stride +
           8 * static_cast<int64_t>(a.i2[b]) * a.row_stride;
  }
  // (plane p, octet g, 128-lane block hv)
  return static_cast<int64_t>(a.i0[b]) * a.plane_stride +
         8 * static_cast<int64_t>(a.i1[b]) * a.row_stride + 128 * a.i2[b];
}

// Calls f(first block, first slot, slots) for each sub-unit of this CTA,
// in order: the rows of the run table with a stride of the grid, each cut
// to kUnitCap slots when the window is split into groups.
template <typename F>
__device__ __forceinline__ void for_units(const Args& a, F&& f) {
  for (int u = blockIdx.x; u < a.num_runs; u += gridDim.x) {
    const int2 run = a.runs[u];
    if (run.y <= 0) break;
    const int64_t first = static_cast<int64_t>(run.x) * a.block_v;
    const int64_t slots = static_cast<int64_t>(run.y) * a.block_v;
    const int64_t cut = a.ngroups > 1 ? kUnitCap : slots;
    for (int64_t s0 = 0; s0 < slots; s0 += cut) {
      const int64_t left = slots - s0;
      f(run.x, first + s0, static_cast<int>(left < cut ? left : cut));
    }
  }
}

// -- taps (the chain stage is window.cuh's) ----------------------------------

// Lane `lane` stages slot p's taps: every load first (fixed-width loops,
// predicated), then the shared-memory stores.
template <int MODE, int FORM>
__device__ __forceinline__ void stage_taps(const Args& a, const Fits& fits,
                                           Stage& st, int lane, int64_t p) {
  const int S = a.support;
  const int Sw = a.w_support;
  float vk[kMaxS];
  float uk[kMaxS];
  float wk[kMaxSw];
  int u_off;
  int iv0;
  if (FORM == kStackWords || FORM == kBandWords) {
    const int b = static_cast<int>(p / a.block_v);
    if (a.nonempty != nullptr && a.nonempty[b] == 0) {
      st.pos[lane][0] = -1;
      return;
    }
    const int wa = a.pa[p];
    const int wb = a.pb[p];
    const float valid = static_cast<float>(wb >> 30);
    word_taps(fits, a.ncoef, a.inv2_ov, a.inv2_wov, wa, wb, vk, uk, wk);
#pragma unroll
    for (int j = 0; j < kMaxSw; ++j) wk[j] = __fmul_rn(wk[j], valid);
    u_off = (wa >> 17) & 7;
    iv0 = wa >> 20;
  } else if (FORM == kStackTaps) {
    const float* vk_t = static_cast<const float*>(a.vk);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      vk[s] = s < S ? vk_t[s * a.total + p] : 0.0f;
      uk[s] = s < S ? a.uk[s * a.total + p] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMaxSw; ++j) {
      wk[j] = j < Sw ? a.wk_t[j * a.total + p] : 0.0f;
    }
    const int wa = a.pa[p];
    u_off = (wa >> 17) & 7;
    iv0 = wa >> 20;
  } else {
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      const int64_t e = p * S + s;
      vk[s] = s >= S ? 0.0f
              : MODE == kBf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.vk)[e])
                  : static_cast<const float*>(a.vk)[e];
      uk[s] = s < S ? a.uk[e] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMaxSw; ++j) {
      wk[j] = j < Sw ? a.wk_t[j * a.total + p] : 0.0f;
    }
    u_off = a.u_off[p];
    iv0 = a.iv0[p];
  }
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    st.vk[lane * kTapPad + s] = stage_v<MODE>(vk[s]);
    st.uk[lane * kTapPad + s] = uk[s];
  }
#pragma unroll
  for (int j = 0; j < kMaxSw; ++j) st.wk[lane * kTapPad + j] = wk[j];
  st.pos[lane][0] = u_off;
  st.pos[lane][1] = iv0;
}

// P(cell, v) with the cell and v as staged (both already bf16-rounded in
// kBf16).
template <int MODE>
__device__ __forceinline__ float cell_prod(float x, float v) {
  if (MODE == kHigh) return prod<kHigh>(x, v);
  return __fmul_rn(x, v);
}

// The slabs of group g: planes j0 .. j0 + jc - 1 of both halves (nh 2:
// half A the real, B the imaginary one) or of half `h` alone (nh 1).
// One-slab groups of a window wider than a slab of shared memory take it
// in column tiles: columns c0 .. c0 + cw - 1.
struct Group {
  int j0, jc, h, c0, cw;
};

__device__ __forceinline__ Group group_of(const Args& a, int g) {
  if (a.nh == 2) {
    const int j0 = g * a.jn;
    return Group{j0, min(a.jn, a.w_support - j0), 0, 0, a.width};
  }
  const int s = g / a.ntiles;
  const int c0 = (g % a.ntiles) * a.tile_w;
  return Group{s % a.w_support, 1, s / a.w_support, c0,
               min(a.tile_w, a.width - c0)};
}

// -- the kernel --------------------------------------------------------------

template <int MODE, int FORM>
__global__ void __launch_bounds__(kThreads, 1)
window_gather_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int slab = kRows * a.stride;
  const int group_slabs = a.nh * a.jn;
  Stage* stages =
      reinterpret_cast<Stage*>(ring + a.nbuf * group_slabs * slab);
  Fits* fits = reinterpret_cast<Fits*>(stages + kWarps);
  uint64_t* full = reinterpret_cast<uint64_t*>(fits + 1);
  uint64_t* empty = full + kMaxBuffers;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Sw = a.w_support;

  if (threadIdx.x == 0) {
    for (int b = 0; b < a.nbuf; ++b) {
      bar_init(&full[b], 32);
      bar_init(&empty[b], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (FORM == kStackWords || FORM == kBandWords) {
    load_fits(fits, a.c_uv, a.c_w, a.ncoef, a.support, Sw, threadIdx.x,
              kThreads);
  }
  __syncthreads();

  if (warp == kWarps) {
    // Producer: each group's slabs, 16-byte copies, a row a pass.
    uint32_t gi = 0;
    for_units(a, [&](int block, int64_t, int) {
      const int64_t origin = window_origin<FORM>(a, block);
      for (int g = 0; g < a.ngroups; ++g, ++gi) {
        const int buf = gi % a.nbuf;
        if (gi >= static_cast<uint32_t>(a.nbuf)) {
          bar_wait(&empty[buf], ((gi / a.nbuf) - 1) & 1);
        }
        const Group gr = group_of(a, g);
        const int cpr = gr.cw / 4;
        const int chunks = kRows * cpr;
        float* dst = ring + buf * group_slabs * slab;
        for (int hi = 0; hi < a.nh; ++hi) {
          for (int jj = 0; jj < gr.jc; ++jj) {
            const int64_t src = origin + (a.nh == 2 ? hi : gr.h) *
                                             a.half_stride +
                                (gr.j0 + jj) * a.plane_stride + gr.c0;
            float* d = dst + (jj * a.nh + hi) * slab;
            for (int e = lane; e < chunks; e += 32) {
              const int r = e / cpr;
              const int c = 4 * (e - r * cpr);
              const int64_t at =
                  src + static_cast<int64_t>(r) * a.row_stride + c;
              if (at + 4 <= a.limit) {
                cp_async16(d + r * a.stride + c, a.base + at);
              }
            }
          }
        }
        cp_async_arrive(&full[buf]);
      }
    });
    cp_async_wait_all();
    return;
  }

  // Consumers.
  Stage& st = stages[warp];
  const int S = a.support;
  const int q = lane >> 3;
  const int sv = lane & 7;
  const int s4 = 4 * a.stride;
  uint32_t gi = 0;
  int rot = 0;
  float acc[kTilesPerWarp][2];
  for_units(a, [&](int, int64_t first, int n) {
    const int ntiles = (n + 31) / 32;
    const int t0 = (warp - rot % kWarps + kWarps) % kWarps;
    rot = (rot + ntiles) % kWarps;
    for (int g = 0; g < a.ngroups; ++g, ++gi) {
      const int buf = gi % a.nbuf;
      bar_wait(&full[buf], (gi / a.nbuf) & 1);
      const Group gr = group_of(a, g);
      // Slab (plane jj, half hi) of the group at gbase + (jj nh + hi) slab.
      float* gbase = ring + buf * group_slabs * slab;
      if (MODE == kBf16) {
        // Round the group's cells to bf16 once, in place, before any
        // consumer gathers them (the cells' side of every product).
        for (int e = threadIdx.x; e < group_slabs * slab; e += 32 * kWarps) {
          gbase[e] = round_bf16(gbase[e]);
        }
        asm volatile("bar.sync 1, %0;" ::"r"(32 * kWarps) : "memory");
      }
      const bool two = a.nh == 2;
      const int jstep = a.nh * slab;
      for (int m0 = 0; t0 + kWarps * m0 < ntiles; m0 += kTilesPerWarp) {
#pragma unroll
        for (int r = 0; r < kTilesPerWarp; ++r) {
          const int tile = t0 + kWarps * (m0 + r);
          if (tile >= ntiles) break;
          const int64_t p0 = first + 32 * tile;
          const int nt = min(32, n - 32 * tile);
          if (lane < nt) {
            stage_taps<MODE, FORM>(a, *fits, st, lane, p0 + lane);
          }
          __syncwarp();
          for (int i0 = 0; i0 < nt; i0 += kSlots) {
            // kSlots slots at once, branch-free, so that their shared loads
            // interleave; lanes past a slot's taps load nothing.
            float v[kSlots], u0[kSlots], u1[kSlots];
            float ra[kSlots], rb[kSlots];
            int at[kSlots], wofs[kSlots];
            bool okc[kSlots], ok0[kSlots], ok1[kSlots];
#pragma unroll
            for (int c = 0; c < kSlots; ++c) {
              const int i = i0 + c;
              const int u_off = i < nt ? st.pos[i][0] : -1;
              const int col = (u_off >= 0 ? st.pos[i][1] : 0) + sv;
              okc[c] = u_off >= 0 && sv < S && col >= gr.c0 &&
                       col < gr.c0 + gr.cw;
              ok0[c] = okc[c] && q < S;
              ok1[c] = okc[c] && q + 4 < S;
              v[c] = okc[c] ? st.vk[i * kTapPad + sv] : 0.0f;
              u0[c] = ok0[c] ? st.uk[i * kTapPad + q] : 0.0f;
              u1[c] = ok1[c] ? st.uk[i * kTapPad + q + 4] : 0.0f;
              at[c] = okc[c] ? (u_off + q) * a.stride + col - gr.c0 : 0;
              wofs[c] = (okc[c] ? i : 0) * kTapPad + gr.j0;
              ra[c] = 0.0f;
              rb[c] = 0.0f;
            }
            // Both halves' cells of plane jj: the slot's real (a) and
            // imaginary (b) sums.
            auto gather = [&](int c, float xa0, float xa1, float xb0,
                              float xb1, float w) {
              const float ta = fmaf(u1[c], cell_prod<MODE>(xa1, v[c]),
                                    u0[c] * cell_prod<MODE>(xa0, v[c]));
              const float tb = fmaf(u1[c], cell_prod<MODE>(xb1, v[c]),
                                    u0[c] * cell_prod<MODE>(xb0, v[c]));
              ra[c] = fmaf(w, ta, ra[c]);
              rb[c] = fmaf(w, tb, rb[c]);
            };
            bool all_in = two;
#pragma unroll
            for (int c = 0; c < kSlots; ++c) all_in = all_in && ok1[c];
            if (__all_sync(kFull, all_in)) {
              // Every lane's taps of the kSlots slots lie in the window
              // (S 8 away from its edge): no predicates.
              const float* pc[kSlots];
              const float* pw[kSlots];
#pragma unroll
              for (int c = 0; c < kSlots; ++c) {
                pc[c] = gbase + at[c];
                pw[c] = st.wk + wofs[c];
              }
              for (int jj = 0; jj < gr.jc; ++jj) {
#pragma unroll
                for (int c = 0; c < kSlots; ++c) {
                  const float* p = pc[c];
                  gather(c, p[0], p[s4], p[slab], p[slab + s4], pw[c][jj]);
                  pc[c] = p + jstep;
                }
              }
            } else {
              // A one-half group reads its own slab twice and drops the
              // second sum (no uniform condition on the loads).
              for (int jj = 0; jj < gr.jc; ++jj) {
                const float* sa = gbase + jj * jstep;
                const float* sb = two ? sa + slab : sa;
#pragma unroll
                for (int c = 0; c < kSlots; ++c) {
                  gather(c, ok0[c] ? sa[at[c]] : 0.0f,
                         ok1[c] ? sa[at[c] + s4] : 0.0f,
                         ok0[c] ? sb[at[c]] : 0.0f,
                         ok1[c] ? sb[at[c] + s4] : 0.0f,
                         okc[c] ? st.wk[wofs[c] + jj] : 0.0f);
                }
              }
            }
            // vals[2 c + h] is slot i0 + c's half h on this lane; one
            // butterfly sums them all: each xor step halves the values a
            // lane carries until lane 4 x holds value x.
            float vals[2 * kSlots];
#pragma unroll
            for (int c = 0; c < kSlots; ++c) {
              vals[2 * c] = two || gr.h == 0 ? ra[c] : 0.0f;
              vals[2 * c + 1] = two ? rb[c] : gr.h == 1 ? ra[c] : 0.0f;
            }
#pragma unroll
            for (int m = kSlots, off = 16; m >= 1; m /= 2, off /= 2) {
              const bool upper = lane & off;
#pragma unroll
              for (int e = 0; e < m; ++e) {
                const float keep = upper ? vals[m + e] : vals[e];
                const float send = upper ? vals[e] : vals[m + e];
                vals[e] = keep + __shfl_xor_sync(kFull, send, off);
              }
            }
            float sum = vals[0];
            sum += __shfl_xor_sync(kFull, sum, 2);
            sum += __shfl_xor_sync(kFull, sum, 1);
            const int c = lane >> 3;
            if ((lane & 3) == 0 && i0 + c < nt) {
              st.res[(lane >> 2) & 1][i0 + c] = sum;
            }
          }
          __syncwarp();
          if (lane < nt) {
            float re = st.res[0][lane];
            float im = st.res[1][lane];
            if (a.ngroups > 1) {
              if (g > 0) {
                re += acc[r][0];
                im += acc[r][1];
              }
              acc[r][0] = re;
              acc[r][1] = im;
            }
            if (g == a.ngroups - 1) {
              a.out[p0 + lane] = re;
              a.out[a.total + p0 + lane] = im;
            }
          }
          __syncwarp();
        }
      }
      if (lane == 0) bar_arrive(&empty[buf]);
    }
  });
}

// -- host --------------------------------------------------------------------

struct Plan {
  int stride, jn, nh, tile_w, ntiles, ngroups, nbuf;
  size_t smem;
};

size_t smem_bytes(int stride, int slabs) {
  return sizeof(float) * static_cast<size_t>(slabs) * kRows * stride +
         kWarps * sizeof(Stage) + sizeof(Fits) +
         2 * kMaxBuffers * sizeof(uint64_t);
}

// The ring's layout for a window of 2 Sw slabs of `width` columns: the
// whole window double-buffered when two fit, else groups of w-planes of
// both halves (double-buffered when two groups fit), else one slab at a
// time, in column tiles when a whole one does not fit.
void plan_ring(int width, int w_support, Plan* p) {
  const size_t fixed = smem_bytes(0, 0);
  const int max_tile =
      static_cast<int>((kMaxSmem - fixed) / (sizeof(float) * kRows) - 8) /
      32 * 32;
  p->tile_w = width < max_tile ? width : max_tile;
  p->ntiles = (width + p->tile_w - 1) / p->tile_w;
  p->stride = window_stride(p->tile_w);
  const size_t slab = sizeof(float) * kRows * p->stride;
  const int fit = static_cast<int>((kMaxSmem - fixed) / slab);
  const int sw = w_support;
  p->nh = 2;
  p->nbuf = 2;
  if (fit >= 4 * sw) {
    p->jn = sw;
  } else if (fit >= 2 * sw) {
    p->jn = sw;
    p->nbuf = 1;
  } else if (fit >= 4) {
    const int groups = (sw + fit / 4 - 1) / (fit / 4);
    p->jn = (sw + groups - 1) / groups;
  } else if (fit >= 2) {
    p->jn = 1;
    p->nbuf = 1;
  } else {
    p->jn = 1;
    p->nh = 1;
    p->nbuf = 1;
  }
  p->ngroups = p->nh == 2 ? (sw + p->jn - 1) / p->jn : 2 * sw * p->ntiles;
  p->smem = smem_bytes(p->stride, p->nbuf * p->nh * p->jn);
}

template <int MODE, int FORM>
int launch(Args a, cudaStream_t s) {
  Plan p;
  plan_ring(a.width, a.w_support, &p);
  a.stride = p.stride;
  a.jn = p.jn;
  a.nh = p.nh;
  a.tile_w = p.tile_w;
  a.ntiles = p.ntiles;
  a.ngroups = p.ngroups;
  a.nbuf = p.nbuf;
  auto kernel = window_gather_kernel<MODE, FORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, p.smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ctas = a.num_runs < sms * per_sm ? a.num_runs : sms * per_sm;
  if (ctas <= 0) return 0;
  kernel<<<ctas, kThreads, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM>
int launch_mode(int mode, const Args& a, cudaStream_t s) {
  switch (mode) {
    case kF32: return launch<kF32, FORM>(a, s);
    case kHigh: return launch<kHigh, FORM>(a, s);
    case kBf16: return launch<kBf16, FORM>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). `runs` is the
// plan's run table [num_runs, 2] int32 (first block, block count), longest
// first, rows of count 0 (if any) last; every block must lie in one row.

// K4 (uk_t null) and K13 (uk_t, vk_t, wk_t given; pb, the fits and
// nonempty unused): the per-task stack f32 [num_tasks, 2, K (lanes + 8),
// lanes]; out f32 [2, total].
int sdp_torch_fused_degrid_stack(const float* stack, const int* runs,
                                 int num_runs, const int* t_idx,
                                 const int* k_idx, const int* g_idx,
                                 const int* nonempty, const int* pa,
                                 const int* pb, const float* c_uv,
                                 const float* c_w, const float* uk_t,
                                 const float* vk_t, const float* wk_t,
                                 int ncoef, float inv2_ov, float inv2_wov,
                                 int64_t total, int block_v, int support,
                                 int w_support, int lanes, int num_layers,
                                 int num_tasks, int mode, float* out,
                                 void* stream) {
  const bool compact = uk_t != nullptr;
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxStackSw) ||
      (!compact && !words_ok(support, w_support, ncoef)) || lanes <= 0 ||
      lanes % 4 != 0 || num_layers <= 0 || num_tasks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
  const int64_t plane = static_cast<int64_t>(lanes + 8) * lanes;
  Args a{};
  a.runs = reinterpret_cast<const int2*>(runs);
  a.num_runs = num_runs;
  a.i0 = t_idx;
  a.i1 = k_idx;
  a.i2 = g_idx;
  a.nonempty = compact ? nullptr : nonempty;
  a.pa = pa;
  a.pb = pb;
  a.c_uv = c_uv;
  a.c_w = c_w;
  a.ncoef = ncoef;
  a.inv2_ov = inv2_ov;
  a.inv2_wov = inv2_wov;
  a.uk = uk_t;
  a.vk = vk_t;
  a.wk_t = wk_t;
  a.base = stack;
  a.limit = static_cast<int64_t>(num_tasks) * 2 * num_layers * plane;
  a.half_stride = num_layers * plane;
  a.plane_stride = plane;
  a.num_layers = num_layers;
  a.row_stride = lanes;
  a.width = lanes;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compact ? launch_mode<kStackTaps>(mode, a, s)
                 : launch_mode<kStackWords>(mode, a, s);
}

// K11: the plane stack f32 [2, num_planes, rows_pad, lanes_pad], windows of
// lanes_win lanes; `mode` kF32, or kBf16 with a bf16 vk; out rows 0 and 1
// of f32 [8, total].
int sdp_torch_band_degrid(const float* planes, const int* runs,
                          int num_runs, const int* p_idx, const int* g_idx,
                          const int* hv_idx, const int* u_off,
                          const int* iv0, const float* uk, const void* vk,
                          const float* wk_t, int num_planes, int rows_pad,
                          int lanes_pad, int64_t total, int block_v,
                          int support, int w_support, int lanes_win,
                          int mode, float* out, void* stream) {
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxSw) ||
      num_planes <= 0 || rows_pad <= 0 || lanes_pad <= 0 || lanes_win <= 0 ||
      lanes_win % 4 != 0 || lanes_pad % 4 != 0 ||
      (mode != kF32 && mode != kBf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
  Args a{};
  a.runs = reinterpret_cast<const int2*>(runs);
  a.num_runs = num_runs;
  a.i0 = p_idx;
  a.i1 = g_idx;
  a.i2 = hv_idx;
  a.uk = uk;
  a.vk = vk;
  a.wk_t = wk_t;
  a.u_off = u_off;
  a.iv0 = iv0;
  a.base = planes;
  a.plane_stride = static_cast<int64_t>(rows_pad) * lanes_pad;
  a.half_stride = num_planes * a.plane_stride;
  a.limit = 2 * a.half_stride;
  a.row_stride = lanes_pad;
  a.width = lanes_win;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.out = out;
  return launch_mode<kBandTaps>(mode, a, static_cast<cudaStream_t>(stream));
}

// K19: as K11 with the taps from the words pa/pb (the valid bit of pb masks
// the w taps); `mode` kF32, kHigh or kBf16; blocks whose `nonempty` (may be
// null) is 0 predict zero.
int sdp_torch_band_degrid_fused(const float* planes, const int* runs,
                                int num_runs, const int* p_idx,
                                const int* g_idx, const int* hv_idx,
                                const int* nonempty, const int* pa,
                                const int* pb, const float* c_uv,
                                const float* c_w, int ncoef, float inv2_ov,
                                float inv2_wov, int num_planes, int rows_pad,
                                int lanes_pad, int64_t total, int block_v,
                                int support, int w_support, int lanes_win,
                                int mode, float* out, void* stream) {
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxStackSw) ||
      !words_ok(support, w_support, ncoef) || num_planes <= 0 ||
      rows_pad <= 0 || lanes_pad <= 0 || lanes_win <= 0 ||
      lanes_win % 4 != 0 || lanes_pad % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
  Args a{};
  a.runs = reinterpret_cast<const int2*>(runs);
  a.num_runs = num_runs;
  a.i0 = p_idx;
  a.i1 = g_idx;
  a.i2 = hv_idx;
  a.nonempty = nonempty;
  a.pa = pa;
  a.pb = pb;
  a.c_uv = c_uv;
  a.c_w = c_w;
  a.ncoef = ncoef;
  a.inv2_ov = inv2_ov;
  a.inv2_wov = inv2_wov;
  a.base = planes;
  a.plane_stride = static_cast<int64_t>(rows_pad) * lanes_pad;
  a.half_stride = num_planes * a.plane_stride;
  a.limit = 2 * a.half_stride;
  a.row_stride = lanes_pad;
  a.width = lanes_win;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.out = out;
  return launch_mode<kBandWords>(mode, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
