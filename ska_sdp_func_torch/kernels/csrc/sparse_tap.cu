// The sparse all-layer w-towers grid (K20) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grid_all_layers_sparse (K20) of
// ska_sdp_func_tpu/kernels/sparse_tap.py (_sparse_grid_kernel). Inputs, as
// the plain version in sparse_tap.py takes them: per slot v the visibility
// vre/vim [V] f32, its sub-grid cell iu0/iv0 [V] int32, kernel taps uk/vk
// [V, S] f32, first layer k0 [V] int32 (clipped to [0, K - Sw]) and w taps
// wk [V, Sw] f32. Output complex64 [K, N, N]:
//   out[k, iu0 + a, iv0 + b] += (uk[v, a] * s) * vk[v, b],
//   s = wk[v, k - k0] * (vre, vim)[v],   0 <= k - k0 < Sw,
// taps outside [0, N)^2 dropped; a slot whose s is 0 adds nothing to that
// half. BF16 rounds the operands of the product as the TPU's single-pass
// dot does: bf16(uk * s) * bf16(vk), uk * s rounded once in f32 first.
// Every product is rounded on its own (no FMA), in the plain version's
// order; only the order of the sums differs.
//
// What bounds it on an H100. At the bucketed fallback's largest task
// (14,336 slots x 9 layers, N 64, S 8, Sw 4) the inputs and the 295 KB
// output are ~1.8 MB, half a microsecond at the memory's rate, and the
// 3.5M tap products a few microseconds of issue spread over the card. So
// a call is bounded by latency and by balance: the task's slots crowd
// into a few rows (one cell takes up to ~1,000 of them), and runs of
// consecutive slots, a row's channels, share their cell and first layer.
// A CTA's fixed costs (zeroing, the final sums, a cluster's barriers) are
// microseconds, so the grid is kept to about one CTA an SM.
//
// Design: output ownership, one launch, no atomics. A tile, 4 rows of W
// columns (W = N where it fits, else the narrowest even split) of P
// consecutive layers (as many as fit: all 9 at N 64), is owned by a
// cluster of C CTAs (C = 1, 2, 4 or 8, so that the grid is about one CTA
// an SM) and written whole, zeros included; every cell of the output
// belongs to one tile, so the output needs no zeroing. The cluster's 8 C
// warps split the task's slots by chunks of 32 (chunk j to warp j mod
// 8 C). A warp tests 4 chunks at a time (rows, columns and layer window
// meet the tile), appends its hits to a ring in shared memory, and copies
// up to 32 hits' records (the tile rows' uk, vk, wk, vre, vim, iv0, k0)
// into its staging area, waiting for the copies before it adds them. Lane
// (l, b) of each pass over the S x Sw pairs takes layer k0 + l and column
// iv0 + b of each hit on the tile's rows, and sums the hits of a run (one
// first column and first layer) in registers, adding the sums into the
// warp's private copy of the tile when the run ends: plain shared loads
// and stores, no two lanes on one cell. Each CTA then adds its 8 copies in
// warp order, and the cluster adds those sums, each CTA a slice of the
// tile, in rank order through distributed shared memory: the order of
// every cell's sum is fixed, so two calls give equal bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "taps.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = 8;                    // private copies a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;                    // chunks tested together
constexpr int kRing = 256;                   // hits a warp holds
constexpr int kBatch = 32;                   // most hits staged at a time
constexpr int kRows = 4;                     // tile rows
constexpr int kPad = 8;                      // cells past a row, a layer
constexpr int kMaxCluster = 8;
constexpr int kMaxSmemBytes = 232448;        // 227 KB, opt-in

struct SparseArgs {
  const float* vre;
  const float* vim;
  const int* iu0;
  const int* iv0;
  const int* k0;
  const float* uk;     // [V, S]
  const float* vk;     // [V, S]
  const float* wk;     // [V, Sw]
  int total;
  int support;
  int w_support;
  int num_layers;
  int size;
  int width;           // W: tile columns
  int col_tiles;
  int planes;          // P: tile layers
  int batch;           // hits staged at a time (<= kBatch)
  int rec;             // staging record floats (odd)
  float2* out;         // complex64 [K, N, N]
};

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float2 add2(float2 s, float2 x) {
  return make_float2(__fadd_rn(s.x, x.x), __fadd_rn(s.y, x.y));
}

// The term of uk value u, scale s and vk value vkb: (u * s) * vk, or its
// bf16 form; 0 where s is.
template <bool BF16>
__device__ __forceinline__ float term(float u, float s, float vkb) {
  const float us = __fmul_rn(u, s);
  const float x = BF16 ? __fmul_rn(round_bf16(us), round_bf16(vkb))
                       : __fmul_rn(us, vkb);
  return s != 0.0f ? x : 0.0f;
}

// One warp's hits on its copy of the tile. A staged record: [the tile
// rows' uk (kRows, 0 off the slot's rows)][vk row (S)][wk row (Sw)][vre,
// vim, iv0, k0 (clipped)].
template <bool BF16>
struct Walk {
  const SparseArgs& a;
  int r0, r1, c0, c1, p0, p1, stride, pstride, kmax;
  float2* mine;        // [P][pstride]: kRows rows of stride cells a layer
  float* stage;        // [batch][rec]
  // This pass's pair: layer la of the window, column lb of the support.
  int la, lb;
  bool on;
  // The current run (first column, first layer) and its sums on the
  // tile's rows.
  int key_iv, key_k;
  float acc_re[kRows];
  float acc_im[kRows];

  __device__ __forceinline__ void pair(int idx) {
    on = idx < a.support * a.w_support;
    la = on ? idx / a.support : 0;
    lb = on ? idx - la * a.support : 0;
  }

  __device__ __forceinline__ void flush() {
    const int col = key_iv + lb;
    const int p = key_k + la;
    if (key_iv != INT32_MIN && on && col >= c0 && col < c1 && p >= p0 &&
        p < p1) {
      float2* cell = mine + (p - p0) * pstride + (col - c0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r < r1 && (acc_re[r] != 0.0f || acc_im[r] != 0.0f)) {
          float2 c = cell[r * stride];
          c.x = __fadd_rn(c.x, acc_re[r]);
          c.y = __fadd_rn(c.y, acc_im[r]);
          cell[r * stride] = c;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc_re[r] = 0.0f;
      acc_im[r] = 0.0f;
    }
    key_iv = INT32_MIN;
  }

  // Copy slot v's record to `at`; the copies land by cp_async_wait_all.
  __device__ __forceinline__ void stage_hit(int v, float* at) {
    const int S = a.support;
    const int Sw = a.w_support;
    const int iu = __ldg(a.iu0 + v);
    const float* uk = a.uk + static_cast<int64_t>(v) * S;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = r0 + r - iu;
      const bool in = t >= 0 && t < S;
      cp_async4(at + r, in ? uk + t : uk, in);
    }
    const float* vk = a.vk + static_cast<int64_t>(v) * S;
    for (int b = 0; b < S; ++b) cp_async4(at + kRows + b, vk + b, true);
    const float* wk = a.wk + static_cast<int64_t>(v) * Sw;
    float* tail = at + kRows + S;
    for (int l = 0; l < Sw; ++l) cp_async4(tail + l, wk + l, true);
    tail += Sw;
    cp_async4(tail, a.vre + v, true);
    cp_async4(tail + 1, a.vim + v, true);
    cp_async4(tail + 2, a.iv0 + v, true);
    tail[3] = __int_as_float(min(max(__ldg(a.k0 + v), 0), kmax));
  }

  // Add the n staged hits, in order: each pass over the pairs, runs
  // summed in registers (across calls where one pass covers the pairs).
  __device__ __forceinline__ void add(int n, int passes) {
    const int S = a.support;
    const int key_at = kRows + S + a.w_support;
    for (int ps = 0; ps < passes; ++ps) {
      if (passes > 1) pair(ps * 32 + (threadIdx.x & 31));
      const float* q = stage;
      for (int j = 0; j < n; ++j, q += a.rec) {
        const float* tail = q + key_at;
        const int iv = __float_as_int(tail[2]);
        const int k = __float_as_int(tail[3]);
        if (iv != key_iv || k != key_k) {        // uniform
          flush();
          key_iv = iv;
          key_k = k;
        }
        const float w = q[kRows + S + la];
        const float sre = __fmul_rn(w, tail[0]);
        const float sim = __fmul_rn(w, tail[1]);
        const float vkb = on ? q[kRows + lb] : 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc_re[r] = __fadd_rn(acc_re[r], term<BF16>(q[r], sre, vkb));
          acc_im[r] = __fadd_rn(acc_im[r], term<BF16>(q[r], sim, vkb));
        }
      }
      if (passes > 1) flush();
    }
  }
};

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
sparse_grid_kernel(const __grid_constant__ SparseArgs a) {
  extern __shared__ __align__(16) float2 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int N = a.size;
  const int S = a.support;
  const int stride = ((a.width + 1) & ~1) + kPad;  // float2 a tile row
  const int pstride = kRows * stride + kPad;       // float2 a tile layer
  const int copy = a.planes * pstride;             // float2 a copy (even)
  const int tile = static_cast<int>(blockIdx.x) / C;
  const int r0 = tile / a.col_tiles * kRows;
  const int c0 = tile % a.col_tiles * a.width;
  const int p0 = static_cast<int>(blockIdx.y) * a.planes;

  float* stage_all = reinterpret_cast<float*>(smem + kWarps * copy);
  int* ring = reinterpret_cast<int*>(stage_all + kWarps * a.batch * a.rec) +
              warp * kRing;
  Walk<BF16> walk{a};
  walk.r0 = r0;
  walk.r1 = min(r0 + kRows, N);
  walk.c0 = c0;
  walk.c1 = min(c0 + a.width, N);
  walk.p0 = p0;
  walk.p1 = min(p0 + a.planes, a.num_layers);
  walk.stride = stride;
  walk.pstride = pstride;
  walk.kmax = a.num_layers - a.w_support;
  walk.mine = smem + warp * copy;
  walk.stage = stage_all + warp * a.batch * a.rec;
  walk.pair(lane);
  walk.key_iv = INT32_MIN;
  walk.key_k = 0;
  walk.flush();                                  // clears the sums
  for (int i = lane * 2; i < copy; i += 64) {
    *reinterpret_cast<float4*>(walk.mine + i) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int passes = (S * a.w_support + 31) / 32;
  const bool cols = a.col_tiles > 1;

  // Chunks of 32 slots: chunk j to warp j mod (8 C) of the cluster.
  const int step = C * kWarps;
  const int chunks = (a.total + 31) / 32;
  unsigned head = 0, tail = 0;                   // the ring's hits
  for (int j0 = rank * kWarps + warp;; j0 += kGroup * step) {
    if (j0 < chunks) {
      int iu[kGroup], iv[kGroup], kz[kGroup];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int64_t v = (static_cast<int64_t>(j0) + s * step) * 32 + lane;
        const bool in = v < a.total;
        iu[s] = in ? __ldg(a.iu0 + v) : 0;
        iv[s] = in && cols ? __ldg(a.iv0 + v) : 0;
        kz[s] = in ? __ldg(a.k0 + v) : 0;
      }
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const int64_t v = (static_cast<int64_t>(j0) + s * step) * 32 + lane;
        const int k = min(max(kz[s], 0), walk.kmax);
        const bool hit = v < a.total && iu[s] < walk.r1 &&
                         iu[s] + S > r0 && k < walk.p1 &&
                         k + a.w_support > p0 &&
                         (!cols || (iv[s] < walk.c1 && iv[s] + S > c0));
        const unsigned m = __ballot_sync(kAll, hit);
        if (hit) {
          ring[(tail + __popc(m & ((1u << lane) - 1))) & (kRing - 1)] =
              static_cast<int>(v);
        }
        tail += __popc(m);
      }
    }
    // Stage and add a batch at a time; after the last group, the rest.
    const bool last = j0 + kGroup * step >= chunks;
    while (tail - head >= static_cast<unsigned>(a.batch) ||
           (last && tail != head)) {
      const int n = static_cast<int>(
          min(static_cast<unsigned>(a.batch), tail - head));
      __syncwarp();
      if (lane < n) {
        walk.stage_hit(ring[(head + lane) & (kRing - 1)],
                       walk.stage + lane * a.rec);
      }
      cp_async_wait_all();
      __syncwarp();
      walk.add(n, passes);
      head += n;
    }
    if (last) break;
  }
  if (passes == 1) walk.flush();

  // The tile: each CTA adds its copies into copy 0 in warp order, then
  // each takes a slice of the tile and adds the cluster's copies 0 in
  // rank order, all of a cell's loads in flight before its adds.
  __syncthreads();
  const int wt = walk.c1 - c0;
  const int band = (walk.r1 - r0) * wt;
  const int cells = (walk.p1 - p0) * band;
  auto offset = [&](int q, int* p, int* r, int* c) {
    *p = q / band;
    *r = (q - *p * band) / wt;
    *c = q - *p * band - *r * wt;
    return *p * pstride + *r * stride + *c;
  };
  for (int q = tid; q < cells; q += kThreads) {
    int p, r, c;
    const int off = offset(q, &p, &r, &c);
    float2 x[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x[w] = smem[w * copy + off];
    float2 s = x[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = add2(s, x[w]);
    smem[off] = s;
  }
  if (C > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int per = (cells + C - 1) / C;
  const int q1 = min(cells, (rank + 1) * per);
  for (int q = rank * per + tid; q < q1; q += kThreads) {
    int p, r, c;
    const int off = offset(q, &p, &r, &c);
    float2 x[kMaxCluster];
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) {
      if (g < C) {
        x[g] = (C > 1 ? cluster.map_shared_rank(smem, g) : smem)[off];
      }
    }
    float2 s = x[0];
#pragma unroll
    for (int g = 1; g < kMaxCluster; ++g) {
      if (g < C) s = add2(s, x[g]);
    }
    a.out[(static_cast<int64_t>(p0 + p) * N + r0 + r) * N + c0 + c] = s;
  }
  // No CTA leaves while another reads its copies.
  if (C > 1) cluster.sync();
}

// The opt-in shared-memory limit, set once a process and device.
template <bool BF16>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sparse_grid_kernel<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool BF16>
cudaError_t launch_sparse(const SparseArgs& a, int cluster, int groups,
                          size_t smem, cudaStream_t s) {
  const cudaError_t err = allow_smem<BF16>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.size + kRows - 1) / kRows *
                                           a.col_tiles * cluster),
                     static_cast<unsigned>(groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sparse_grid_kernel<BF16>, a);
}

// Shared memory of one layer of the 8 copies of a tile W columns wide.
size_t plane_bytes(int width) {
  return sizeof(float2) * kWarps *
         (kRows * (((width + 1) & ~1) + kPad) + kPad);
}

}  // namespace

extern "C" {

// K20: grid the slots' sparse w taps (k0 [V], wk [V, Sw]) into `out`,
// complex64 [K, N, N], every cell written; `bf16` selects the bf16 mode.
// Any N >= 1 (wide planes split into column tiles), K <= 65535 and S, Sw
// whose staging record fits half the shared memory. Returns the
// cudaError_t of the launch (0 on success).
int sdp_torch_sparse_grid(const float* vre, const float* vim,
                          const int* iu0, const int* iv0, const int* k0,
                          const float* uk, const float* vk, const float* wk,
                          int64_t total, int support, int w_support,
                          int num_layers, int size, int bf16, float* out,
                          void* stream) {
  if (support < 1 || num_layers < 1 || num_layers > 65535 || size < 1 ||
      size > (1 << 24) || w_support < 1 || w_support > num_layers ||
      total < 0 || total > INT32_MAX - 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ring = sizeof(int) * kWarps * kRing;
  const int rec = (kRows + support + w_support + 4) | 1;
  const size_t per_hit = sizeof(float) * kWarps * rec;
  const int64_t fit = kMaxSmemBytes / 2 / per_hit;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int batch = fit < kBatch ? static_cast<int>(fit) : kBatch;
  const size_t budget = kMaxSmemBytes - ring - per_hit * batch;
  // The whole width where one layer fits, else the narrowest even split.
  int width = size;
  int col_tiles = 1;
  if (plane_bytes(size) > budget) {
    const int most =
        static_cast<int>((budget / (sizeof(float2) * kWarps) - kPad) / kRows -
                         kPad) & ~1;
    col_tiles = (size + most - 1) / most;
    width = ((size + col_tiles - 1) / col_tiles + 1) & ~1;
    col_tiles = (size + width - 1) / width;
  }
  int planes = static_cast<int>(budget / plane_bytes(width));
  planes = planes < num_layers ? planes : num_layers;
  const int groups = (num_layers + planes - 1) / planes;
  const int64_t tiles =
      static_cast<int64_t>((size + kRows - 1) / kRows) * col_tiles * groups;
  // About one CTA an SM: clusters of up to 8 share the tiles' slots, but
  // no more CTAs than the slots keep busy (4 chunks a warp).
  int64_t cluster = sm_count() / tiles;
  const int64_t busy = total / (32 * kWarps * kGroup);
  cluster = cluster > busy ? busy : cluster;
  cluster = cluster > kMaxCluster ? kMaxCluster : (cluster < 1 ? 1 : cluster);
  while (cluster & (cluster - 1)) cluster &= cluster - 1;   // 1, 2, 4, 8
  if (tiles / groups * cluster > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = plane_bytes(width) * planes + per_hit * batch + ring;
  const SparseArgs a{vre, vim, iu0, iv0, k0, uk, vk, wk,
                     static_cast<int>(total), support, w_support,
                     num_layers, size, width, col_tiles, planes, batch, rec,
                     reinterpret_cast<float2*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(cluster);
  const cudaError_t err =
      bf16 ? launch_sparse<true>(a, c, groups, smem, s)
           : launch_sparse<false>(a, c, groups, smem, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
