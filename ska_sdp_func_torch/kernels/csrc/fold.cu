// Bucket-window fold of the streaming engine's non-packable branch for
// Hopper (sm_90a): per-bucket windows -> complex per-task tower layers.
//
// Replaces two Pallas TPU kernels of ska_sdp_func_tpu/kernels/packed_tap.py
// with one gather kernel, fold_windows_kernel:
//   - fold_groups_pallas (_fold_groups_kernel): each (task, slab) group's
//     octet windows summed at their 8-row offsets, unvisited buckets
//     skipped, the last octet's straddle half clipped;
//   - fold_layers_pallas (_fold_layers_kernel): each task's slabs folded
//     onto absolute layers, layer k summing slab s = k - l of window plane
//     l for l < Sw.
//
// Layout (shared with the plain PyTorch versions in fold.py): windows
// wins [2 Sw][T S O][16][L] f32, plane h Sw + l (h = 0 re, 1 im), bucket
// (t S + s) O + g, window row r is sub-grid row 8 g + r; visited [T S O]
// (bool); out [T][K][8 O][L] complex64 (re, im interleaved). Output cell
// (t, k, row, lane), g1 = row / 8, r1 = row % 8:
//   out = sum_{l < Sw, 0 <= s = k - l < S}
//           ( [g1 > 0 and visited (t, s, g1 - 1)] wins[., (t,s,g1-1), r1 + 8]
//           + [visited (t, s, g1)]                wins[., (t,s,g1), r1] )
// summed in the Pallas kernels' order (octets ascending within a slab,
// then window planes l ascending), so it equals the two plain versions
// composed bit for bit. An unvisited window is never read: it may hold
// anything (the streaming plan also marks every bucket of an overflowed
// chunk unvisited).
//
// What bounds it on an H100: bytes, the visited windows read once and the
// layers written once (one add per window cell read). At the non-packable
// dense stream (T 45, S 8, O 16, Sw 4, L 128; 1237 of 5760 buckets
// visited) that is ~81 MB read and 65 MB written. The design: a CTA per
// (octet g1, layer k, task t), the launch grid itself, so no thread divides
// a 64-bit index; the CTA's at most 2 Sw flags (visited (t, k - l, g1 - 1)
// and (t, k - l, g1)) are read once into shared memory and tested
// uniformly, so an unvisited window costs no load and an octet of rows with
// no visited window is written as zeros after the flags alone; a warp
// covers a row's lanes as float4s (single floats where L % 4 != 0 or the
// windows are not 16-byte aligned), issues every load of two window planes
// before their adds, and writes re and im interleaved as two 16-byte
// stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWinRows = 16;
constexpr int kRows = 8;           // output rows a CTA: one octet
// Window planes whose loads go together, and CTAs an SM: the loads of all
// four planes at window j's Sw took so many registers that two CTAs fitted
// an SM, too few to hide the flags' and the windows' latency; two planes at
// a time fit four CTAs and ran faster.
constexpr int kPlanesAtOnce = 2;
constexpr int kCtasPerSm = 4;
constexpr int kMaxGrid = 65535;    // grid y and z

struct FoldArgs {
  const float* wins;
  const bool* visited;
  int t0;                          // the launch's first task
  int num_tasks, num_slabs, num_octets, w_support, num_layers, lanes;
  float2* out;
};

template <int VEC>
struct Lanes;

template <>
struct Lanes<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ void store(float2* out, T re, T im) {
    float4* o = reinterpret_cast<float4*>(out);
    o[0] = make_float4(re.x, im.x, re.y, im.y);
    o[1] = make_float4(re.z, im.z, re.w, im.w);
  }
};

template <>
struct Lanes<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ void store(float2* out, T re, T im) {
    *out = make_float2(re, im);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) fold_windows_kernel(
    const FoldArgs a) {
  using V = Lanes<VEC>;
  using T = typename V::T;
  extern __shared__ unsigned char flag[];   // [2 Sw]: flag 2 l + h
  const int g1 = blockIdx.x;
  const int k = blockIdx.y;
  const int t = a.t0 + static_cast<int>(blockIdx.z);
  const int S = a.num_slabs;
  const int O = a.num_octets;
  // Flag 2 l + h: window (t, k - l, g1 - 1 + h) is read; no slab k - l or
  // octet -1 reads nothing.
  int any = 0;
  for (int i = threadIdx.x; i < 2 * a.w_support; i += blockDim.x) {
    const int s = k - (i >> 1);
    const int g = g1 - 1 + (i & 1);
    const unsigned char v =
        s >= 0 && s < S && g >= 0 && a.visited[(t * S + s) * O + g];
    flag[i] = v;
    any |= v;
  }
  any = __syncthreads_or(any);
  const int64_t L = a.lanes;
  const int64_t win = kWinRows * L;
  const int64_t plane = static_cast<int64_t>(a.num_tasks) * S * O * win;
  const int64_t half = a.w_support * plane;
  const int l_lo = k - S + 1 > 0 ? k - S + 1 : 0;
  const int l_hi = k < a.w_support - 1 ? k : a.w_support - 1;
  const int quads = a.lanes / VEC;
  float2* out = a.out + ((static_cast<int64_t>(t) * a.num_layers + k) * O +
                         g1) * kRows * L;
  for (int e = threadIdx.x; e < kRows * quads; e += blockDim.x) {
    const int r1 = e / quads;
    const int lane0 = (e - r1 * quads) * VEC;
    T re = V::zero();
    T im = V::zero();
    if (any) {
      for (int l0 = l_lo; l0 <= l_hi; l0 += kPlanesAtOnce) {
        // [plane][window g1 - 1 re, im; window g1 re, im], loads first.
        T x[kPlanesAtOnce][4];
#pragma unroll
        for (int i = 0; i < kPlanesAtOnce; ++i) {
          const int l = l0 + i;
          if (l <= l_hi) {
            const int64_t cur =
                l * plane +
                static_cast<int64_t>((t * S + k - l) * O + g1) * win +
                r1 * L + lane0;
            if (flag[2 * l]) {
              x[i][0] = V::load(a.wins + cur - win + 8 * L);
              x[i][1] = V::load(a.wins + cur - win + 8 * L + half);
            }
            if (flag[2 * l + 1]) {
              x[i][2] = V::load(a.wins + cur);
              x[i][3] = V::load(a.wins + cur + half);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kPlanesAtOnce; ++i) {
          const int l = l0 + i;
          if (l <= l_hi) {
            T pr = V::zero();
            T pi = V::zero();
            if (flag[2 * l]) {
              pr = V::add(pr, x[i][0]);
              pi = V::add(pi, x[i][1]);
            }
            if (flag[2 * l + 1]) {
              pr = V::add(pr, x[i][2]);
              pi = V::add(pi, x[i][3]);
            }
            re = V::add(re, pr);
            im = V::add(im, pi);
          }
        }
      }
    }
    V::store(out + r1 * L + lane0, re, im);
  }
}

template <int VEC>
int launch(FoldArgs a, int threads, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(a.w_support);
  for (int t0 = 0; t0 < a.num_tasks; t0 += kMaxGrid) {
    a.t0 = t0;
    const int n = a.num_tasks - t0 < kMaxGrid ? a.num_tasks - t0 : kMaxGrid;
    const dim3 grid(a.num_octets, a.num_layers, n);
    fold_windows_kernel<VEC><<<grid, threads, smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). num_layers must be
// num_slabs + w_support - 1, at most 65535, and T S O below 2^31.
int sdp_torch_fold_windows(const float* wins, const bool* visited,
                           int num_tasks, int num_slabs, int num_octets,
                           int w_support, int num_layers, int lanes,
                           float* out, void* stream) {
  if (num_tasks < 1 || num_slabs < 1 || num_octets < 1 || w_support < 1 ||
      num_layers != num_slabs + w_support - 1 || num_layers > kMaxGrid ||
      lanes < 1 ||
      static_cast<int64_t>(num_tasks) * num_slabs * num_octets >=
          (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FoldArgs a{wins, visited, 0, num_tasks, num_slabs, num_octets,
                   w_support, num_layers, lanes,
                   reinterpret_cast<float2*>(out)};
  const bool vec = lanes % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(wins) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int cells = kRows * (vec ? lanes / 4 : lanes);
  const int threads = cells < kThreads ? (cells + 31) / 32 * 32 : kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<4>(a, threads, s) : launch<1>(a, threads, s);
}

}  // extern "C"
