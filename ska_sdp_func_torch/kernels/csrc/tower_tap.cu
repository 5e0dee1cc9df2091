// W-towers all-layer tap gridding / degridding kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels grid_all_layers_pallas (K16) and
// degrid_all_layers_pallas (K17) of ska_sdp_func_tpu/kernels/pallas_tap.py
// (their shared bodies _grid_kernel / _degrid_kernel):
//   - K16 -> tower_grid_tasks_kernel
//   - K17 -> tower_degrid_tasks_kernel
// (the sparse all-layer grid K20 is sparse_tap.cu's).
//
// Inputs are flat per-slot taps (shared with the plain PyTorch versions in
// tower_tap.py): iu0/iv0 [V] int32 sub-grid cells, uk/vk [V, S] f32 kernel
// taps, and the w-kernel value of each slot on each layer, weights [V, Kw]
// f32 (zero outside its Sw layers).
//
// K16/K17 take a whole sorted stream of tasks at once. A task table int32
// [T, 4] holds, per task and in slot order, (start, count, K_t, base): its
// slots [start, start + count), its layer count K_t <= Kw, and the first of
// its K_t planes in one output stack. A null table is one task over every
// slot with K_t = Kw and base 0 (the one-task wrappers). For each task
//
//   grid:   stack[base + k, iu0+a, iv0+b] += (uk[v,a] * s) * vk[v,b],
//           s = w[v,k] * (vre, vim)[v], summed over the task's slots;
//   degrid: vis[v] = sum_k w[v,k] * sum_{a,b} uk[v,a] vk[v,b]
//                    * stack[base + k, iu0+a, iv0+b]        (re and im),
//
// with the stack complex64 [sum_t K_t, N, N] (interleaved re, im). Taps
// outside [0, N)^2 are dropped, as the TPU band build drops them.
//
// Precision. f32 throughout by default (the Pallas kernels'
// Precision.HIGHEST); only the order of the sums differs. BF16 is the
// TPU's single-pass bf16 dot (Precision.DEFAULT, the Pallas `fast` mode),
// rounding exactly the operands of its dots: grid, bf16(uk * s) *
// bf16(vk), with uk * s rounded once in f32 first; degrid, (bf16(uk) *
// bf16(cell)) * vk, vk and the w weight in f32. Each bf16 product is exact
// in f32 and the sums are f32. The mode is a template argument.
//
// What bounds it on an H100. The TPU kernels rebuilt the scatter as dense
// [N, B] x [B, N] band products for the MXU (2 N^2 flops per slot and
// layer, of which only S^2 = 64 are not zero), one pallas_call per task,
// and XLA put the per-task loop around them at no launch cost. On the card
// the sparse form is the cheap one: 2 S^2 flops and ~120 bytes per slot
// and active layer, so a whole fallback call (218 tasks, ~1.16M slots on
// the bench data) is bound by its bytes, tens of microseconds, and a launch
// per task (with the host work around it) is what costs. So each kernel
// takes every task of a call in one launch.
//
// Grid design: one CTA of 16 warps per output plane (task, layer k), in
// the order of a layer map int32 [sum K_t, 2] of (task row, k) that the
// caller gives (largest tasks first, so they do not form the tail). The
// CTA holds the plane's re and im halves in shared memory, rows padded to
// a stride of 8 mod 32 floats so that the 4 x 8 taps a warp adds at once
// fall on 32 distinct banks. Each warp takes 32 of the task's slots at a
// time: lane i reads slot i's weight for k, visibility and cells. A slot
// is active on Sw of the task's K_t layers and a row's channels share
// their layers, so most chunks have no active slot and cost those few
// loads. Otherwise the warp stages the chunk in its own corner of shared
// memory: each slot's s = w * (vre, vim) and cell, and the uk and vk rows
// of its active slots (contiguous: coalesced loads, all in flight at
// once). Then every lane walks the 32 staged slots in order with
// broadcast reads and sums its S^2/32 taps of each in registers.
// Consecutive slots are neighbouring channels of one row and mostly share
// their cell, so a lane adds its sums into the plane (shared-memory
// atomics: other warps add into the same cells) only when the cell moves.
// Then the CTA writes its whole plane pair with plain coalesced float2
// stores, zeros included: no global atomics and no memset of the stack.
// A plane pair that does not fit beside the staging (N > 140 at S = 8)
// skips shared memory: the stack is zeroed by one memset and each lane
// adds its sums straight into it with float2 global atomics. (Staging
// the chunk first and summing in registers is what keeps a slot from
// waiting on its own loads and from paying an atomic a tap.) A lane holds
// 2 taps of a slot up to support 8 and 8 up to 16; a wider support walks
// the task's slots again for each further 256 taps. Up to S = 54 the 16
// warps' staged rows fit in shared memory; past it a body stages only
// each slot's (s, cell) and reads its uk and vk rows from global memory
// (L1) where they are used, as the degrid kernel's any-support body does,
// so any support grids.
//
// Degrid design: one thread per slot of the whole stream. It finds its
// slot's task by a binary search of the table's starts (broadcast loads of
// a few hundred bytes; the lanes of a warp, neighbouring slots, mostly
// take one path), loads its S + S taps, and for each of the task's layers
// with a non-zero weight gathers its S x S cells as float2 from the
// complex64 stack (L2-resident), all of a layer's loads independent and
// in flight at once; one float2 store. Neighbouring slots mostly fall on
// the same cells, so a warp's gathers mostly coincide (a support over 8
// reads its tap rows from memory where they are used). Every slot of the
// stream is written (zero where no task holds it), in slot order. (A
// thread a slot, rather than a warp, keeps all of a slot's gathers in
// flight at once and needs no reduction across lanes.)

#include <cuda_runtime.h>

#include <cstdint>

#include "taps.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoCell = INT32_MIN;         // a staged slot with no weight
constexpr int kTaskGridThreads = 512;     // 16 warps
constexpr int kTaskGridWarps = kTaskGridThreads / 32;
constexpr int kDegridThreads = 256;       // one slot a thread
constexpr int kMaxSmem = 232448;          // 227 KB, opt-in

struct TaskRow {
  int start;
  int count;
  int num_layers;
  int base;
};

__device__ __forceinline__ TaskRow task_row(const int* table, int t,
                                            int64_t total, int w_cols) {
  if (table == nullptr) {
    return TaskRow{0, static_cast<int>(total), w_cols, 0};
  }
  const int4 r = reinterpret_cast<const int4*>(table)[t];
  return TaskRow{r.x, r.y, r.z, r.w};
}

__device__ __forceinline__ void atomic_add2(float2* p, float x, float y) {
#if CUDART_VERSION >= 12010
  atomicAdd(p, make_float2(x, y));   // one vector atomic (sm_90, global)
#else
  atomicAdd(&p->x, x);
  atomicAdd(&p->y, y);
#endif
}

// The shared-memory row stride of an N-wide plane: N padded up to 8 mod 32.
__host__ __device__ __forceinline__ int padded_stride(int size) {
  return size + ((8 - size % 32) + 32) % 32;
}

// Floats of one warp's staged chunk of 32 slots: each slot's (s_re, s_im,
// u0, v0), then (ROWS) its uk and vk rows, 2S floats padded to an odd pitch.
__host__ __device__ __forceinline__ int stage_floats(int support,
                                                     bool rows) {
  return 32 * 4 + (rows ? 32 * (2 * support + 1) : 0);
}

struct TaskGridArgs {
  const float* vre;
  const float* vim;
  const int* iu0;
  const int* iv0;
  const float* uk;
  const float* vk;
  const float* w;          // weights [V, w_cols]
  const int* table;        // [T, 4] or null (one task, every slot)
  const int* layer_map;    // [planes, 2] (task row, k) or null (k = CTA)
  int64_t total;
  int support;
  int w_cols;
  int size;
  float2* out;             // complex64 [planes, N, N]
};

// MAXS (8 or 16): each lane holds TPL = MAXS^2 / 32 of a slot's taps, so a
// pass over the task's slots takes 32 TPL taps of each: one pass up to
// support MAXS, ceil(S^2 / 256) passes past 16. The MAXS = 16 body keeps
// 32 more registers of sums and cells a lane: one CTA an SM, not two.
// ROWS stages the active slots' uk and vk rows in shared memory (supports
// up to 54); without it the lanes read them from global memory (L1).
template <bool SMEM, bool BF16, int MAXS, bool ROWS>
__global__ void __launch_bounds__(kTaskGridThreads, MAXS <= 8 ? 2 : 1)
tower_grid_tasks_kernel(const TaskGridArgs a) {
  constexpr int TPL = MAXS * MAXS / 32;
  // [re plane | im plane] (N x stride each, when SMEM), then each warp's
  // staged slots: 32 (s_re, s_im, u0, v0) and 32 uk, vk rows.
  extern __shared__ float smem[];

  int t = 0;
  int k = blockIdx.x;
  if (a.layer_map != nullptr) {
    const int2 m = reinterpret_cast<const int2*>(a.layer_map)[blockIdx.x];
    t = m.x;
    k = m.y;
  }
  const TaskRow task = task_row(a.table, t, a.total, a.w_cols);
  const int size = a.size;
  const int support = a.support;
  const int stride = padded_stride(size);
  const int pitch = 2 * support + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* p_re = smem;
  float* p_im = smem + size * stride;
  float4* scal = reinterpret_cast<float4*>(
      smem + (SMEM ? 2 * size * stride : 0) +
      warp * stage_floats(support, ROWS));
  float* stage = reinterpret_cast<float*>(scal + 32);
  float2* dst = a.out + static_cast<int64_t>(task.base + k) * size * size;

  if (SMEM) {
    for (int i = tid; i < 2 * size * stride; i += kTaskGridThreads) {
      smem[i] = 0.0f;
    }
    __syncthreads();
  }

  // Each pass: this lane's taps t = tap0 + lane + 32 i, row a = t / S,
  // column b = t % S.
  const int taps = support * support;
  const int passes = MAXS <= 8 ? 1 : (taps + 32 * TPL - 1) / (32 * TPL);
  for (int pass = 0; pass < passes; ++pass) {
    const int tap0 = 32 * TPL * pass;
    int tap_a[TPL];
    int tap_b[TPL];
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      const int tap = min(tap0 + lane + 32 * i, taps - 1);
      tap_a[i] = tap / support;
      tap_b[i] = tap % support;
    }

    // Each lane's running sums for its taps' cells: consecutive slots of a
    // row are neighbouring channels, which mostly fall on the same sub-grid
    // cell, so the sums are added into the plane only when the cell moves.
    float acc_re[TPL];
    float acc_im[TPL];
    int at_u = 0;
    int at_v = 0;
    bool held = false;
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const int u = at_u + tap_a[i];
        const int c = at_v + tap_b[i];
        if (tap0 + lane + 32 * i < taps && u >= 0 && u < size &&
            c >= 0 && c < size) {
          if (SMEM) {
            atomicAdd(&p_re[u * stride + c], acc_re[i]);
            atomicAdd(&p_im[u * stride + c], acc_im[i]);
          } else {
            atomic_add2(&dst[u * size + c], acc_re[i], acc_im[i]);
          }
        }
      }
    };

    const int64_t end = static_cast<int64_t>(task.start) + task.count;
    for (int64_t chunk = task.start + 32 * warp; chunk < end;
         chunk += 32 * kTaskGridWarps) {
      const int64_t v = chunk + lane;
      const bool in = v < end;
      const float wt = in ? a.w[v * a.w_cols + k] : 0.0f;
      const float vr = in ? a.vre[v] : 0.0f;
      const float vi = in ? a.vim[v] : 0.0f;
      const int u0 = in ? a.iu0[v] : 0;
      const int v0 = in ? a.iv0[v] : 0;
      const unsigned active = __ballot_sync(kFull, wt != 0.0f);
      if (active == 0) continue;               // uniform across the warp
      // Stage the chunk (its rows contiguous: coalesced loads, all in flight
      // at once): each slot's s and cell (an inactive slot's u0 =
      // kNoCell, "no move"; a cell may lie off the plane, u0 < 0), and the
      // uk and vk rows of the active slots (zero for the others, which then
      // add exact zeros).
      __syncwarp();
      scal[lane] = wt != 0.0f
                       ? make_float4(wt * vr, wt * vi, __int_as_float(u0),
                                     __int_as_float(v0))
                       : make_float4(0.0f, 0.0f, __int_as_float(kNoCell),
                                     0.0f);
      const int n =
          static_cast<int>(min(static_cast<int64_t>(32), end - chunk));
      for (int e = lane; ROWS && e < 32 * support; e += 32) {
        const int slot = e / support;
        const int j = e - slot * support;
        const bool on = slot < n && ((active >> slot) & 1u);
        stage[slot * pitch + j] = on ? a.uk[chunk * support + e] : 0.0f;
        stage[slot * pitch + support + j] =
            on ? a.vk[chunk * support + e] : 0.0f;
      }
      __syncwarp();
      // Every lane walks the 32 slots in order (broadcast reads, no branch
      // but the rare move of the cell, so the reads of several slots are in
      // flight together).
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const float4 q = scal[j];
        const int cu = __float_as_int(q.z);
        const int cv = __float_as_int(q.w);
        if (cu != kNoCell &&                                   // uniform
            (!held || cu != at_u || cv != at_v)) {
          if (held) flush();
          held = true;
          at_u = cu;
          at_v = cv;
#pragma unroll
          for (int i = 0; i < TPL; ++i) {
            acc_re[i] = 0.0f;
            acc_im[i] = 0.0f;
          }
        }
        // Unstaged rows: an inactive slot (or one past the task's end) is
        // skipped, uniformly across the warp.
        if (!ROWS && cu == kNoCell) continue;
        const float* u_row = ROWS ? stage + j * pitch
                                  : a.uk + (chunk + j) * support;
        const float* v_row = ROWS ? u_row + support
                                  : a.vk + (chunk + j) * support;
#pragma unroll
        for (int i = 0; i < TPL; ++i) {
          const float ua = u_row[tap_a[i]];
          const float vb = v_row[tap_b[i]];
          if (BF16) {
            // bf16 x bf16 is exact in f32: the product is the dot's term.
            const float vrb = round_bf16(vb);
            acc_re[i] += __fmul_rn(round_bf16(__fmul_rn(ua, q.x)), vrb);
            acc_im[i] += __fmul_rn(round_bf16(__fmul_rn(ua, q.y)), vrb);
          } else {
            acc_re[i] += (ua * q.x) * vb;
            acc_im[i] += (ua * q.y) * vb;
          }
        }
      }
    }
    if (held) flush();
  }

  if (SMEM) {
    __syncthreads();
    for (int i = tid; i < size * size; i += kTaskGridThreads) {
      const int cell = (i / size) * stride + i % size;
      dst[i] = make_float2(p_re[cell], p_im[cell]);
    }
  }
}

// One thread per slot. MAXS = 8 holds the slot's taps in registers for
// supports up to 8; MAXS = 0 takes any support, reading each tap row from
// global memory (L1) where it is used. (A 16-wide register body took 1.79
// ms at support 12 over the bench stream on an H100, more than this one's
// 1.66 ms at support 20.)
template <bool BF16, int MAXS>
__global__ void __launch_bounds__(kDegridThreads, 4)
tower_degrid_tasks_kernel(const float2* __restrict__ layers,
                          const int* __restrict__ iu0,
                          const int* __restrict__ iv0,
                          const float* __restrict__ uk,
                          const float* __restrict__ vk,
                          const float* __restrict__ weights,
                          const int* __restrict__ table, int num_tasks,
                          int64_t total, int support, int w_cols, int size,
                          float2* __restrict__ out) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kDegridThreads +
                    threadIdx.x;
  if (v >= total) return;

  // The task holding slot v: the last row whose start is <= v (the lanes
  // of a warp, neighbouring slots, mostly take one path).
  int t = 0;
  if (table != nullptr) {
    int lo = 0;
    int hi = num_tasks - 1;
    t = -1;
    while (lo <= hi) {
      const int mid = (lo + hi) >> 1;
      if (table[4 * mid] <= v) {
        t = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
  }
  const TaskRow task = t < 0 ? TaskRow{0, 0, 0, 0}
                             : task_row(table, t, total, w_cols);
  if (t < 0 || v >= static_cast<int64_t>(task.start) + task.count) {
    out[v] = make_float2(0.0f, 0.0f);
    return;
  }

  const int u0 = iu0[v];
  const int w0 = iv0[v];
  const float* uk_v = uk + v * support;
  const float* vk_v = vk + v * support;
  constexpr int R = MAXS > 0 ? MAXS : 1;
  float ua[R];   // f32: uk; bf16: bf16(uk)
  float vb[R];
  if (MAXS > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      ua[j] = j < support ? uk_v[j] : 0.0f;
      vb[j] = j < support ? vk_v[j] : 0.0f;
      if (BF16) ua[j] = round_bf16(ua[j]);
    }
  }
  // The taps inside [0, N)^2: rows a_lo .. a_hi - 1, columns b_lo ..
  // b_hi - 1.
  const int a_lo = max(0, -u0);
  const int a_hi = min(support, size - u0);
  const int b_lo = max(0, -w0);
  const int b_hi = min(support, size - w0);
  // One term: f32, tap = uk * vk times the cell; bf16, the bf16 dot's
  // term bf16(uk) * bf16(cell), exact in f32, then the f32 product with vk.
  auto add = [](float u, float w, float2 x, float& pr, float& pi) {
    if (BF16) {
      pr = fmaf(__fmul_rn(u, round_bf16(x.x)), w, pr);
      pi = fmaf(__fmul_rn(u, round_bf16(x.y)), w, pi);
    } else {
      const float tap = u * w;
      pr = fmaf(tap, x.x, pr);
      pi = fmaf(tap, x.y, pi);
    }
  };

  const int64_t plane = static_cast<int64_t>(size) * size;
  float re = 0.0f;
  float im = 0.0f;
  for (int k = 0; k < task.num_layers; ++k) {
    const float wt = weights[v * w_cols + k];
    if (wt == 0.0f) continue;
    const float2* cells = layers + (task.base + k) * plane +
                          static_cast<int64_t>(u0) * size + w0;
    float pr = 0.0f;
    float pi = 0.0f;
    if (MAXS > 0) {
#pragma unroll
      for (int ia = 0; ia < R; ++ia) {
        if (ia < a_lo || ia >= a_hi) continue;
#pragma unroll
        for (int ib = 0; ib < R; ++ib) {
          if (ib < b_lo || ib >= b_hi) continue;
          add(ua[ia], vb[ib], cells[ia * size + ib], pr, pi);
        }
      }
    } else {
      for (int ia = a_lo; ia < a_hi; ++ia) {
        const float u = BF16 ? round_bf16(uk_v[ia]) : uk_v[ia];
        for (int ib = b_lo; ib < b_hi; ++ib) {
          add(u, vk_v[ib], cells[ia * size + ib], pr, pi);
        }
      }
    }
    re = fmaf(wt, pr, re);
    im = fmaf(wt, pi, im);
  }
  out[v] = make_float2(re, im);
}

// Shared-memory bytes of the 16 warps' staging (ROWS: with tap rows).
inline size_t grid_stage_bytes(int support, bool rows) {
  return sizeof(float) * kTaskGridWarps * stage_floats(support, rows);
}

template <bool BF16, int MAXS, bool ROWS>
cudaError_t launch_grid_tasks(const TaskGridArgs& a, int planes,
                              cudaStream_t s) {
  const size_t stage = grid_stage_bytes(a.support, ROWS);
  const size_t smem =
      sizeof(float) * 2 * a.size * padded_stride(a.size) + stage;
  if (stage > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= static_cast<size_t>(kMaxSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        tower_grid_tasks_kernel<true, BF16, MAXS, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tower_grid_tasks_kernel<true, BF16, MAXS, ROWS>
        <<<planes, kTaskGridThreads, smem, s>>>(a);
  } else {
    cudaError_t err = cudaMemsetAsync(
        a.out, 0, sizeof(float2) * planes * a.size * a.size, s);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        tower_grid_tasks_kernel<false, BF16, MAXS, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(stage));
    if (err != cudaSuccess) return err;
    tower_grid_tasks_kernel<false, BF16, MAXS, ROWS>
        <<<planes, kTaskGridThreads, stage, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_grid_tasks(const TaskGridArgs& a, int planes,
                              cudaStream_t s) {
  if (a.support <= 8) return launch_grid_tasks<BF16, 8, true>(a, planes, s);
  if (grid_stage_bytes(a.support, true) <= static_cast<size_t>(kMaxSmem)) {
    return launch_grid_tasks<BF16, 16, true>(a, planes, s);
  }
  return launch_grid_tasks<BF16, 16, false>(a, planes, s);
}

template <bool BF16, int MAXS>
void launch_degrid_tasks(const float2* l, const int* iu0, const int* iv0,
                         const float* uk, const float* vk, const float* w,
                         const int* table, int num_tasks, int64_t total,
                         int support, int w_cols, int size, float2* o,
                         cudaStream_t s) {
  const unsigned ctas = static_cast<unsigned>(
      (total + kDegridThreads - 1) / kDegridThreads);
  tower_degrid_tasks_kernel<BF16, MAXS><<<ctas, kDegridThreads, 0, s>>>(
      l, iu0, iv0, uk, vk, w, table, num_tasks, total, support, w_cols, size,
      o);
}

template <bool BF16>
cudaError_t launch_degrid_tasks(const float2* l, const int* iu0,
                                const int* iv0, const float* uk,
                                const float* vk, const float* w,
                                const int* table, int num_tasks,
                                int64_t total, int support, int w_cols,
                                int size, float2* o, cudaStream_t s) {
  if (support <= 8) {
    launch_degrid_tasks<BF16, 8>(l, iu0, iv0, uk, vk, w, table, num_tasks,
                                 total, support, w_cols, size, o, s);
  } else {
    launch_degrid_tasks<BF16, 0>(l, iu0, iv0, uk, vk, w, table, num_tasks,
                                 total, support, w_cols, size, o, s);
  }
  return cudaGetLastError();
}

bool bad_task_args(int64_t total, int support, int w_cols, int size,
                   const int* table) {
  return support < 1 || w_cols < 1 || size < 1 ||
         (table != nullptr && total > INT32_MAX);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success); `bf16`
// selects the bf16 mode.
//
// K16: grid the tasks of `table` ([num_tasks, 4], or null: one task over
// every slot with K = w_cols) into `out`, complex64 [planes, N, N]; CTA i
// takes the plane layer_map[i] = (task row, k) (null: k = i, one task).
// The stack needs no zeroing: every plane of it is written.
int sdp_torch_tower_grid_tasks(const float* vre, const float* vim,
                               const int* iu0, const int* iv0,
                               const float* uk, const float* vk,
                               const float* weights, const int* table,
                               const int* layer_map, int planes,
                               int64_t total, int support, int w_cols,
                               int size, int bf16, float* out, void* stream) {
  if (planes <= 0) return 0;
  if (bad_task_args(total, support, w_cols, size, table) ||
      (table == nullptr) != (layer_map == nullptr) ||
      (table == nullptr && planes != w_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TaskGridArgs a{vre, vim, iu0, iv0, uk, vk, weights, table, layer_map,
                       total, support, w_cols, size,
                       reinterpret_cast<float2*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_grid_tasks<true>(a, planes, s)
                               : launch_grid_tasks<false>(a, planes, s));
}

// K17: degrid every slot of the stream from `layers`, complex64
// [planes, N, N], into `out`, complex64 [total] (zero where no task of
// `table` holds the slot; a null table is one task over every slot).
int sdp_torch_tower_degrid_tasks(const float* layers, const int* iu0,
                                 const int* iv0, const float* uk,
                                 const float* vk, const float* weights,
                                 const int* table, int num_tasks,
                                 int64_t total, int support, int w_cols,
                                 int size, int bf16, float* out,
                                 void* stream) {
  if (total <= 0) return 0;
  if (bad_task_args(total, support, w_cols, size, table) ||
      (table != nullptr && num_tasks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* l = reinterpret_cast<const float2*>(layers);
  float2* o = reinterpret_cast<float2*>(out);
  return static_cast<int>(
      bf16 ? launch_degrid_tasks<true>(l, iu0, iv0, uk, vk, weights, table,
                                       num_tasks, total, support, w_cols,
                                       size, o, s)
           : launch_degrid_tasks<false>(l, iu0, iv0, uk, vk, weights, table,
                                        num_tasks, total, support, w_cols,
                                        size, o, s));
}

}  // extern "C"
