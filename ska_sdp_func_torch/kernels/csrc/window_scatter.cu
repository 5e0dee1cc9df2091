// Window-scatter gridding for Hopper (sm_90a): every grid kernel that adds
// each slot's S x S x 2 Sw tap products into its bucket's window, in its
// four tap forms, over the plan's bucket runs.
//
// Replace four Pallas TPU kernels of ska_sdp_func_tpu/kernels/, each by
// one form of window_scatter_kernel<MODE, FORM>:
//   - fused_tap.py:426 grid_fused_stack_pallas (K3; _grid_stack_kernel,
//     _block_contrib, _prep_common, _stack_accumulate)  -> kStackWords
//   - fused_tap.py:555 grid_compact_pallas (K12; _grid_compact_kernel)
//                                                       -> kStackTaps
//   - packed_tap.py:397 grid_packed_pallas (K8; _grid_kernel,
//     _grid_kernel_split, _grid_accumulate)             -> kBandTaps
//   - fused_tap.py:328 grid_fused_pallas (K18; _grid_fused_kernel,
//     _block_contrib, _prep_common)                     -> kBandWords
// Their degrid twins are window_gather.cu's window_gather_kernel; the
// forms, the row stride and the Chebyshev chain stage are window.cuh's.
//
// What each slot adds, as the plain versions in fused_tap.py and
// band_tap.py:
//   win[h][j][u_off + su][iv0 + sv] += P(uk[su] * s[h Sw + j], vk[sv]),
// s the slot's scale of plane (h, j): wk[j] * v_h (h = 0 the real, 1 the
// imaginary visibility) in the word and compact forms, the band form's
// scale stack row h Sw + j (or its split form wk_t[j] * v_h); P the
// mode's product (taps.cuh: kF32 "highest", kHigh the bf16 hi/lo halves,
// kBf16 bf16-rounded factors, the band form's when vk is bf16). Every
// product is rounded on its own, in the plain versions' order; only the
// order of the sums differs. Columns iv0 + sv at or past the window's
// width are dropped. The taps per form: kStackWords / kBandWords evaluate
// uk, vk and wk from the plan words pa = iv0 << 20 | u_off << 17 | w_row
// and pb = valid << 30 | u_frac << 15 | v_frac (the chain stage, bit-equal
// to taps.cuh) and skip the blocks `nonempty` marks 0; kStackTaps reads
// uk_t / vk_t [S][total] and wk_t [Sw][total] beside pa; kBandTaps reads
// u_off, iv0 [total], uk, vk [total][S] and the scales. The windows: the
// stack forms add into the per-task stacks f32 [T, 2, K (lanes + 8),
// lanes] at rows ((2 t + h) K + k0 + j) (lanes + 8) + 8 g, the band forms
// into the bucket windows f32 [2 Sw, num_buckets, 16, lanes].
//
// What bounds it on an H100, and the design. The TPU kernels build dense
// 16-row u bands and lanes-wide v bands a slot and contract them on the
// MXU (2 Sw 16 lanes MACs a slot); only 2 Sw S S of those are not zero.
// Those are read-modify-writes of one window cell each: at the dense
// stream (S 8, Sw 4) 512 a slot, 5.9 M slots a chunk. No device-memory or
// FLOP roofline is near (a few bytes and two operations a cell); the bound
// is the shared-memory wavefronts of the cells and of the staged taps the
// warps read (one wavefront an instruction, one an SM a clock). The first
// port gave each plan block a CTA (zeroing and flushing the whole window
// each time, with scalar global atomics) and a thread a (slot, tap), with
// shared atomics at unrelated cells (a CAS loop, ATOMS.CAST.SPIN, for f32
// in shared memory on sm_90). Here:
//   - work units are bucket runs: (first block, count) rows of the plan's
//     run table, a run being consecutive blocks of one window
//     (packed_tap.run_table; the predicts' parts, so the ingest and the
//     predict cut the stream alike). CTAs, as many as fit on the SMs, walk
//     the table with a stride of the grid; each keeps its unit's window in
//     shared memory, zeroed once, and adds it to device memory once;
//   - 4 producer warps stage 128 slots at a time, a thread a slot, into
//     one of two tiles (named barriers hand the tiles over): its taps
//     (loaded, or the word forms' 24 Chebyshev sums as independent chains)
//     as (uk[q], uk[q + 4]) pairs, (vk[sv], first cell) pairs and one
//     (re, im) scale pair a w-plane, each read by a consumer lane with one
//     8-byte load. Slots that add nothing (zero scales on the group's
//     w-planes, a block `nonempty` marks 0, taps outside the window) are
//     dropped there: the tile is compacted in slot order. The next tile's
//     loads are issued before this one is handed over;
//   - each of the 4 consumer warps owns whole w-planes, both halves (the
//     real and the imaginary plane share the slot's taps, so a warp reads
//     them once for 4 cells a lane): one at the dense stream, two when 8
//     fit. For each staged slot, lane (q, sv) = (lane / 8, lane % 8)
//     updates cells (u_off + q, iv0 + sv) and (u_off + q + 4, iv0 + sv) of
//     each of its planes with a plain load, add and store: no atomics (a
//     plane has one owner), 32 distinct banks (window.cuh's stride), and a
//     fixed sum order within a unit. Lanes past S store nothing; columns
//     past the width land in the padding. The next slot's taps are loaded
//     before this one's cells;
//   - a window too large for shared memory (the ES-FFT one, 8 w-planes x
//     256 lanes, 270 KB) is taken in groups of w-planes, each a pass over
//     the unit's slots, restaged; past ~1440 lanes a w-plane is taken in
//     column tiles (with 8 padding columns on the left);
//   - each consumer warp flushes its own planes: one
//     cp.reduce.async.bulk .add.f32 a window row, from shared memory to
//     device memory, atomic per element (UBLKRED.G.S.ADD.F32), so parts of
//     one bucket (and the stack's overlapping octets and layers) add up;
//     then it zeroes them, while the producers stage on.
// Measured on an H100 at 700 W (dense stream, K3): 8 warps each owning one
// plane, staging and scattering in turn, 1.42 ms; this design 1.15 ms.
// Interleaving two slots whose columns do not overlap (to halve the
// dependent load-add-store round trips) took 1.62 ms, so the round trip
// is not what sets the pace; larger work units (fewer flushes) did not
// help either.

#include "window.cuh"

namespace {

constexpr int kProd = 4;                       // producer (staging) warps
constexpr int kCons = 4;                       // consumer (scatter) warps
constexpr int kThreads = 32 * (kProd + kCons);
constexpr int kTile = 32 * kProd;              // slots staged at once
constexpr int kRec = 42;                       // words a staged slot (banks)
constexpr int kTileLpad = 8;                   // a column tile's left pad
constexpr unsigned kFull = 0xffffffffu;
// Named barriers: a buffer full (producers arrive, consumers wait) and
// empty (the reverse), and the producers' own.
constexpr int kBarFull = 1;                    // + buffer
constexpr int kBarEmpty = 3;                   // + buffer
constexpr int kBarProd = 5;

// One staged slot, as the consumer lanes (q, sv) read it: three 8-byte
// loads that all lanes of a warp share.
struct Rec {
  float2 u[4];                   // (uk[q], uk[q + 4])
  float2 va[8];                  // (vk[sv] as staged, first cell as int bits)
  float2 s[kMaxSw];              // (scale of (j, re), scale of (j, im))
  float pad[kRec - 40];
};
static_assert(sizeof(Rec) == 4 * kRec, "staged slot layout");

// One staged tile: its live slots compacted in slot order, and one spare
// record the consumers' prefetch may read past the last.
struct Tile {
  Rec rec[kTile + 1];
  int count[kProd];              // live slots of each producer warp
};

struct Args {
  const int2* runs;          // [num_runs] (first block, count); rows of
                             // count 0 end it
  int num_runs;
  // Per block: stack forms (t, k0, g); band forms the bucket in i0.
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
  const float* wk_t;         // [Sw][total] (band: split scale form)
  const int* u_off;          // band taps: [total]
  const int* iv0;
  const float* vre;          // [total] (not the band stack form)
  const float* vim;
  const float* scales;       // band stack form: [2 Sw][total]
  int64_t total;
  int block_v, support, w_support;
  int width;                 // window columns (lanes)
  int num_layers;            // stack: K
  int num_buckets;           // band
  // The layout (plan_layout).
  int stride, lpad, jn, ngp, tile_w, ntiles;
  float* out;
};

// -- PTX wrappers ------------------------------------------------------------

// Adds `bytes` (a multiple of 16) of f32 from shared `src` to global
// `dst`, atomically per element, in this thread's bulk async-group.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to the bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- groups ------------------------------------------------------------------

// Group g: w-planes j0 .. j0 + jn - 1 (both halves of each: window
// planes 2 jl + h in shared memory), columns c0 .. c0 + cw - 1.
struct Group {
  int j0, jn, c0, cw;
};

__device__ __forceinline__ Group group_of(const Args& a, int g) {
  const int pg = g / a.ntiles;
  const int c0 = (g % a.ntiles) * a.tile_w;
  const int j0 = pg * a.jn;
  return Group{j0, min(a.jn, a.w_support - j0), c0,
               min(a.tile_w, a.width - c0)};
}

// Element offset in `out` of row r of window plane (h, j) of the unit
// whose first block is b.
template <int FORM>
__device__ __forceinline__ int64_t out_row(const Args& a, int b, int h,
                                           int j, int r) {
  if (FORM == kStackWords || FORM == kStackTaps) {
    const int64_t sub_pad = a.width + 8;
    return (((2 * static_cast<int64_t>(a.i0[b]) + h) * a.num_layers +
             a.i1[b] + j) * sub_pad + 8 * a.i2[b] + r) * a.width;
  }
  return ((static_cast<int64_t>(h * a.w_support + j) * a.num_buckets +
           a.i0[b]) * kRows + r) * a.width;
}

// -- staging -----------------------------------------------------------------

// What a thread loads for its slot, before the previous tile is scattered.
struct Raw {
  int wa, wb;                // words (word forms); pa (stack taps)
  int u_off, iv0;            // band taps
  float re, im;
  float uk[kMaxS], vk[kMaxS];
  float wk[kMaxSw];          // stack taps, band split form: wk_t
  float st[2][kMaxSw];       // band stack form: scale rows h Sw + j
  bool empty;                // a block `nonempty` marks 0
};

template <int MODE, int FORM>
__device__ __forceinline__ void load_raw(const Args& a, int64_t p, int b,
                                         Raw& r) {
  const int S = a.support;
  const int Sw = a.w_support;
  r.empty = false;
  if (FORM == kStackWords || FORM == kBandWords) {
    if (a.nonempty != nullptr && a.nonempty[b] == 0) {
      r.empty = true;
      return;
    }
    r.wa = a.pa[p];
    r.wb = a.pb[p];
    r.re = a.vre[p];
    r.im = a.vim[p];
  } else if (FORM == kStackTaps) {
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      r.uk[s] = s < S ? a.uk[s * a.total + p] : 0.0f;
      r.vk[s] = s < S ? static_cast<const float*>(a.vk)[s * a.total + p]
                      : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kMaxStackSw; ++j) {
      r.wk[j] = j < Sw ? a.wk_t[j * a.total + p] : 0.0f;
    }
    r.wa = a.pa[p];
    r.re = a.vre[p];
    r.im = a.vim[p];
  } else {
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      const int64_t e = p * S + s;
      r.uk[s] = s < S ? a.uk[e] : 0.0f;
      r.vk[s] = s >= S ? 0.0f
                : MODE == kBf16
                    ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.vk)[e])
                    : static_cast<const float*>(a.vk)[e];
    }
    if (a.scales != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kMaxSw; ++j) {
          r.st[h][j] = j < Sw ? a.scales[(h * Sw + j) * a.total + p] : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxSw; ++j) {
        r.wk[j] = j < Sw ? a.wk_t[j * a.total + p] : 0.0f;
      }
      r.re = a.vre[p];
      r.im = a.vim[p];
    }
    r.u_off = a.u_off[p];
    r.iv0 = a.iv0[p];
  }
}

// -- the named barriers --------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Producer thread `pt` (of kTile) turns its Raw into a record of the group
// `gr` (live: the slot adds something there) and the producers compact the
// tile in slot order.
template <int MODE, int FORM>
__device__ __forceinline__ void stage_tile(const Args& a, const Fits& fits,
                                           Tile& tile, const Group& gr,
                                           const Raw& r, bool have, int pt) {
  const int S = a.support;
  const int Sw = a.w_support;
  const int pw = pt / 32;
  const int lane = pt % 32;
  constexpr int JN = FORM == kBandTaps ? kMaxSw : kMaxStackSw;
  float uk[kMaxS];
  float vk[kMaxS];
  float sc[2][JN];           // the scale of plane (h, j)
  int u_off = 0;
  int iv0 = 0;
  bool live = have && !r.empty;
  if (live) {
    float wk[kMaxSw];
    if (FORM == kStackWords || FORM == kBandWords) {
      word_taps(fits, a.ncoef, a.inv2_ov, a.inv2_wov, r.wa, r.wb, vk, uk,
                wk);
      u_off = (r.wa >> 17) & 7;
      iv0 = r.wa >> 20;
    } else {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        uk[s] = r.uk[s];
        vk[s] = r.vk[s];
      }
#pragma unroll
      for (int j = 0; j < kMaxSw; ++j) wk[j] = r.wk[j];
      if (FORM == kStackTaps) {
        u_off = (r.wa >> 17) & 7;
        iv0 = r.wa >> 20;
      } else {
        u_off = r.u_off;
        iv0 = r.iv0;
      }
    }
    bool any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        if (FORM == kBandTaps && a.scales != nullptr) {
          sc[h][j] = r.st[h][j];
        } else {
          sc[h][j] = __fmul_rn(wk[j], h ? r.im : r.re);
        }
        any = any || (j < Sw && j >= gr.j0 && j < gr.j0 + gr.jn &&
                      sc[h][j] != 0.0f);
      }
    }
    live = any && u_off >= 0 && u_off + S <= kRows && iv0 >= 0 &&
           iv0 < gr.c0 + gr.cw && iv0 + S > gr.c0;
  }
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) tile.count[pw] = __popc(ballot);
  bar_sync(kBarProd, kTile);
  if (live) {
    int k = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < pw; ++w) k += tile.count[w];
    Rec& rec = tile.rec[k];
    const float at = __int_as_float(u_off * a.stride + a.lpad + iv0 - gr.c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) rec.u[q] = make_float2(uk[q], uk[q + 4]);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      rec.va[s] = make_float2(stage_v<MODE>(vk[s]), at);
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      if (j < Sw) rec.s[j] = make_float2(sc[0][j], sc[1][j]);
    }
  }
}

// -- scatter -----------------------------------------------------------------

// P(a, v) with v as staged (bf16-rounded in kBf16).
template <int MODE>
__device__ __forceinline__ float cell_prod(float x, float v) {
  if (MODE == kHigh) return prod<kHigh>(x, v);
  if (MODE == kBf16) return __fmul_rn(round_bf16(x), v);
  return __fmul_rn(x, v);
}

// Consumer warp `cw` takes the tile's `total` records into its JP w-planes
// (local jl = cw, cw + kCons; both halves each): lane (q, sv) adds the
// slot's cells (u_off + q, iv0 + sv) and (u_off + q + 4, iv0 + sv) of each
// plane, a plain load, add and store. The next record is loaded before this
// one's cells.
template <int MODE, int JP>
__device__ __forceinline__ void scatter_tile(const Tile& tile, float* win,
                                             int plane_sz, int s4,
                                             int lane_off, bool ok0,
                                             bool ok1, int j0, int cw,
                                             int total) {
  const int lane = threadIdx.x % 32;
  const int q = lane >> 3;
  const int sv = lane & 7;
  float* base[JP][2];
  int js[JP];
#pragma unroll
  for (int i = 0; i < JP; ++i) {
    const int jl = cw + i * kCons;
    js[i] = j0 + jl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      base[i][h] = win + (2 * jl + h) * plane_sz + lane_off;
    }
  }
  const Rec* rec = tile.rec;
  float2 u = rec->u[q];
  float2 va = rec->va[sv];
  float2 s[JP];
#pragma unroll
  for (int i = 0; i < JP; ++i) s[i] = rec->s[js[i]];
  for (int k = 0; k < total; ++k) {
    const float2 uc = u;
    const float v = va.x;
    const int at = __float_as_int(va.y);
    float2 sc[JP];
#pragma unroll
    for (int i = 0; i < JP; ++i) sc[i] = s[i];
    ++rec;                       // record k + 1 (the spare one past the last)
    u = rec->u[q];
    va = rec->va[sv];
#pragma unroll
    for (int i = 0; i < JP; ++i) s[i] = rec->s[js[i]];
    float p0[JP][2], p1[JP][2];
#pragma unroll
    for (int i = 0; i < JP; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sh = h ? sc[i].y : sc[i].x;
        p0[i][h] = cell_prod<MODE>(__fmul_rn(uc.x, sh), v);
        p1[i][h] = cell_prod<MODE>(__fmul_rn(uc.y, sh), v);
      }
    }
    float c0[JP][2], c1[JP][2];
#pragma unroll
    for (int i = 0; i < JP; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* c = base[i][h] + at;
        c0[i][h] = ok0 ? c[0] : 0.0f;
        c1[i][h] = ok1 ? c[s4] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < JP; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* c = base[i][h] + at;
        if (ok0) c[0] = __fadd_rn(c0[i][h], p0[i][h]);
        if (ok1) c[s4] = __fadd_rn(c1[i][h], p1[i][h]);
      }
    }
  }
}

// Consumer warp `cw` adds its planes (both halves of w-planes cw, cw +
// kCons of the group) to device memory, a bulk reduce-add a row (a lane a
// row), waits until they are read, and zeroes them: no other warp touches
// them.
template <int FORM>
__device__ __forceinline__ void flush_planes(const Args& a, const Group& gr,
                                             int block, float* win,
                                             int plane_sz, int cw) {
  const int lane = threadIdx.x % 32;
  fence_proxy_async();
  __syncwarp();
  for (int jl = cw; jl < gr.jn; jl += kCons) {
    for (int e = lane; e < 2 * kRows; e += 32) {
      const int h = e / kRows;
      const int row = e % kRows;
      bulk_reduce_add(
          a.out + out_row<FORM>(a, block, h, gr.j0 + jl, row) + gr.c0,
          win + (2 * jl + h) * plane_sz + row * a.stride + a.lpad,
          4 * gr.cw);
    }
  }
  bulk_commit_and_wait_read();
  __syncwarp();
  float4* w4 = reinterpret_cast<float4*>(win);
  const int plane_f4 = plane_sz / 4;
  for (int jl = cw; jl < gr.jn; jl += kCons) {
    for (int i = lane; i < 2 * plane_f4; i += 32) {
      w4[2 * jl * plane_f4 + i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncwarp();
}

// -- the kernel --------------------------------------------------------------

template <int MODE, int FORM>
__global__ void __launch_bounds__(kThreads, 2)
window_scatter_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  const int plane_sz = kRows * a.stride;
  Tile* tiles = reinterpret_cast<Tile*>(win + 2 * a.jn * plane_sz);
  Fits* fits = reinterpret_cast<Fits*>(tiles + 2);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int S = a.support;

  if (FORM == kStackWords || FORM == kBandWords) {
    load_fits(fits, a.c_uv, a.c_w, a.ncoef, S, a.w_support, tid, kThreads);
  }
  float4* win4 = reinterpret_cast<float4*>(win);
  for (int i = tid; i < 2 * a.jn * plane_sz / 4; i += kThreads) {
    win4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int ngroups = a.ngp * a.ntiles;

  if (warp >= kCons) {
    // Producers: each (unit, group, tile) in order into buffer n % 2.
    const int pt = tid - 32 * kCons;
    uint32_t n = 0;
    for (int u = blockIdx.x; u < a.num_runs; u += gridDim.x) {
      const int2 run = a.runs[u];
      if (run.y <= 0) break;
      const int64_t first = static_cast<int64_t>(run.x) * a.block_v;
      const int64_t len = static_cast<int64_t>(run.y) * a.block_v;
      for (int g = 0; g < ngroups; ++g) {
        const Group gr = group_of(a, g);
        Raw r;
        bool have = pt < len;
        if (have) {
          load_raw<MODE, FORM>(a, first + pt, run.x + pt / a.block_v, r);
        }
        for (int64_t t0 = 0; t0 < len; t0 += kTile, ++n) {
          const int buf = n % 2;
          bar_sync(kBarEmpty + buf, kThreads);
          stage_tile<MODE, FORM>(a, *fits, tiles[buf], gr, r, have, pt);
          // The next tile's loads, in flight while the consumers work.
          const int64_t nxt = t0 + kTile + pt;
          have = nxt < len;
          if (have) {
            load_raw<MODE, FORM>(a, first + nxt,
                                 run.x + static_cast<int>(nxt / a.block_v),
                                 r);
          }
          bar_arrive(kBarFull + buf, kThreads);
        }
      }
    }
    // Match the consumers' last two releases.
    bar_sync(kBarEmpty + n % 2, kThreads);
    bar_sync(kBarEmpty + (n + 1) % 2, kThreads);
    return;
  }

  // Consumers: warp `warp` owns w-planes warp, warp + kCons of each group.
  const int q = lane >> 3;
  const int sv = lane & 7;
  const bool ok0 = q < S && sv < S;
  const bool ok1 = q + 4 < S && sv < S;
  const int lane_off = q * a.stride + sv;
  const int s4 = 4 * a.stride;
  bar_arrive(kBarEmpty + 0, kThreads);
  bar_arrive(kBarEmpty + 1, kThreads);
  uint32_t n = 0;
  for (int u = blockIdx.x; u < a.num_runs; u += gridDim.x) {
    const int2 run = a.runs[u];
    if (run.y <= 0) break;
    const int64_t len = static_cast<int64_t>(run.y) * a.block_v;
    for (int g = 0; g < ngroups; ++g) {
      const Group gr = group_of(a, g);
      bool touched = false;
      for (int64_t t0 = 0; t0 < len; t0 += kTile, ++n) {
        const int buf = n % 2;
        const Tile& tile = tiles[buf];
        bar_sync(kBarFull + buf, kThreads);
        int total = 0;
#pragma unroll
        for (int w = 0; w < kProd; ++w) total += tile.count[w];
        if (total > 0) {
          touched = true;
          if (warp + kCons < gr.jn) {
            scatter_tile<MODE, 2>(tile, win, plane_sz, s4, lane_off, ok0,
                                  ok1, gr.j0, warp, total);
          } else if (warp < gr.jn) {
            scatter_tile<MODE, 1>(tile, win, plane_sz, s4, lane_off, ok0,
                                  ok1, gr.j0, warp, total);
          }
        }
        bar_arrive(kBarEmpty + buf, kThreads);
      }
      if (touched && warp < gr.jn) {
        flush_planes<FORM>(a, gr, run.x, win, plane_sz, warp);
      }
    }
  }
}

// -- host --------------------------------------------------------------------

struct Layout {
  int stride, lpad, jn, ngp, tile_w, ntiles;
  size_t smem;
};

constexpr size_t kFixedSmem = 2 * sizeof(Tile) + sizeof(Fits);

// The window's layout for the 2 Sw planes of Sw w-planes, `width` columns
// each: every w-plane in shared memory when they fit beside the two staged
// tiles, else balanced groups of w-planes (both halves each), each a pass
// over the unit's slots; a w-plane wider than shared memory in column
// tiles of a multiple of 32 columns (with kTileLpad padding columns on the
// left). packed_tap.scatter_layout mirrors it.
void plan_layout(int width, int w_support, Layout* l) {
  const size_t avail = kMaxSmem - kFixedSmem;
  const size_t pair_bytes = 2 * sizeof(float) * kRows;  // a column, 2 planes
  l->lpad = 0;
  l->tile_w = width;
  l->ntiles = 1;
  l->stride = window_stride(width);
  if (pair_bytes * l->stride > avail) {
    l->lpad = kTileLpad;
    // window_stride(kTileLpad + w) = w + window_stride(kTileLpad) for a
    // multiple w of 32.
    const int max_w = (static_cast<int>(avail / pair_bytes) -
                       window_stride(kTileLpad)) / 32 * 32;
    l->ntiles = (width + max_w - 1) / max_w;
    l->tile_w = ((width + l->ntiles - 1) / l->ntiles + 31) / 32 * 32;
    l->stride = window_stride(kTileLpad + l->tile_w);
  }
  const int fit = static_cast<int>(avail / (pair_bytes * l->stride));
  const int jn = fit < w_support ? fit : w_support;
  l->ngp = (w_support + jn - 1) / jn;
  l->jn = (w_support + l->ngp - 1) / l->ngp;
  l->smem = kFixedSmem + pair_bytes * l->stride * l->jn;
}

template <int MODE, int FORM>
int launch(Args a, cudaStream_t s) {
  Layout l;
  plan_layout(a.width, a.w_support, &l);
  a.stride = l.stride;
  a.lpad = l.lpad;
  a.jn = l.jn;
  a.ngp = l.ngp;
  a.tile_w = l.tile_w;
  a.ntiles = l.ntiles;
  auto kernel = window_scatter_kernel<MODE, FORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, l.smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ctas = a.num_runs < sms * per_sm ? a.num_runs : sms * per_sm;
  if (ctas <= 0) return 0;
  kernel<<<ctas, kThreads, l.smem, s>>>(a);
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
// plan's run table [num_runs, 2] int32 (first block, block count), rows of
// count 0 (if any) last; every block must lie in one row. The output must
// hold zeros (or the sums to add to) and lie on a 16-byte boundary; lanes
// must be a multiple of 4.

// K3 (uk_t null) and K12 (uk_t, vk_t, wk_t given; pb, the fits and
// nonempty unused): into the per-task stack f32 [num_tasks, 2,
// K (lanes + 8), lanes].
int sdp_torch_scatter_stack(const int* runs, int num_runs, const int* t_idx,
                            const int* k_idx, const int* g_idx,
                            const int* nonempty, const int* pa, const int* pb,
                            const float* vre, const float* vim,
                            const float* c_uv, const float* c_w,
                            const float* uk_t, const float* vk_t,
                            const float* wk_t, int ncoef, float inv2_ov,
                            float inv2_wov, int64_t total, int block_v,
                            int support, int w_support, int lanes,
                            int num_layers, int mode, float* out,
                            void* stream) {
  const bool compact = uk_t != nullptr;
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxStackSw) ||
      (!compact && !words_ok(support, w_support, ncoef)) || lanes <= 0 ||
      lanes % 4 != 0 || num_layers <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
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
  a.vre = vre;
  a.vim = vim;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.width = lanes;
  a.num_layers = num_layers;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compact ? launch_mode<kStackTaps>(mode, a, s)
                 : launch_mode<kStackWords>(mode, a, s);
}

// K8: into the bucket windows f32 [2 Sw, num_buckets, 16, lanes]; the
// split scale form passes wk_t/vre/vim and a null `scales`, the stack form
// the reverse; `mode` kF32, or kBf16 with a bf16 vk.
int sdp_torch_scatter_band(const int* runs, int num_runs,
                           const int* bucket_ids, const int* u_off,
                           const int* iv0, const float* uk, const void* vk,
                           const float* wk_t, const float* vre,
                           const float* vim, const float* scales,
                           int64_t total, int block_v, int support,
                           int w_support, int lanes, int num_buckets,
                           int mode, float* out, void* stream) {
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxSw) ||
      lanes <= 0 || lanes % 4 != 0 || num_buckets <= 0 ||
      (mode != kF32 && mode != kBf16) ||
      (scales == nullptr &&
       (wk_t == nullptr || vre == nullptr || vim == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
  Args a{};
  a.runs = reinterpret_cast<const int2*>(runs);
  a.num_runs = num_runs;
  a.i0 = bucket_ids;
  a.uk = uk;
  a.vk = vk;
  a.wk_t = wk_t;
  a.u_off = u_off;
  a.iv0 = iv0;
  a.vre = vre;
  a.vim = vim;
  a.scales = scales;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.width = lanes;
  a.num_buckets = num_buckets;
  a.out = out;
  return launch_mode<kBandTaps>(mode, a, static_cast<cudaStream_t>(stream));
}

// K18: as K8 with the taps from the words pa/pb; `mode` kF32, kHigh or
// kBf16; blocks whose `nonempty` (may be null) is 0 are skipped.
int sdp_torch_scatter_band_fused(const int* runs, int num_runs,
                                 const int* bucket_ids, const int* nonempty,
                                 const int* pa, const int* pb,
                                 const float* vre, const float* vim,
                                 const float* c_uv, const float* c_w,
                                 int ncoef, float inv2_ov, float inv2_wov,
                                 int64_t total, int block_v, int support,
                                 int w_support, int lanes, int num_buckets,
                                 int mode, float* out, void* stream) {
  if (!common_ok(num_runs, total, block_v, support, w_support, kMaxStackSw) ||
      !words_ok(support, w_support, ncoef) || lanes <= 0 || lanes % 4 != 0 ||
      num_buckets <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0 || num_runs == 0) return 0;
  Args a{};
  a.runs = reinterpret_cast<const int2*>(runs);
  a.num_runs = num_runs;
  a.i0 = bucket_ids;
  a.nonempty = nonempty;
  a.pa = pa;
  a.pb = pb;
  a.vre = vre;
  a.vim = vim;
  a.c_uv = c_uv;
  a.c_w = c_w;
  a.ncoef = ncoef;
  a.inv2_ov = inv2_ov;
  a.inv2_wov = inv2_wov;
  a.total = total;
  a.block_v = block_v;
  a.support = support;
  a.w_support = w_support;
  a.width = lanes;
  a.num_buckets = num_buckets;
  a.out = out;
  return launch_mode<kBandWords>(mode, a, static_cast<cudaStream_t>(stream));
}

// The layout plan_layout gives a window of 2 w_support planes of `lanes`
// columns (packed_tap.scatter_layout's twin): out[0..7] = stride, lpad,
// w-planes a group, groups, tile width, column tiles, shared bytes, fixed
// (staging) bytes.
int sdp_torch_scatter_layout(int w_support, int lanes, int64_t* out) {
  if (w_support < 1 || w_support > kMaxSw || lanes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout l;
  plan_layout(lanes, w_support, &l);
  const int64_t v[8] = {l.stride, l.lpad, l.jn, l.ngp, l.tile_w, l.ntiles,
                        static_cast<int64_t>(l.smem),
                        static_cast<int64_t>(kFixedSmem)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
