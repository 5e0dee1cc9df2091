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
// What bounds it on an H100, and the design. The Pallas kernels write the
// intermediate [2 Sw, T S, 8 O, L] group fold to device memory and read it
// back; here one thread per output cell gathers its at most 2 Sw window
// cells of each half (neighbouring threads on neighbouring lanes, so every
// read and the interleaved float2 write is coalesced), with no
// intermediate, no atomics and no separate re/im -> complex pass. The work
// is one add per visited window cell, so bytes bound it: the visited
// windows read once and the layers written once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWinRows = 16;

struct FoldArgs {
  const float* wins;
  const bool* visited;
  int num_tasks, num_slabs, num_octets, w_support, num_layers, lanes;
  float2* out;
};

__global__ void __launch_bounds__(kThreads) fold_windows_kernel(FoldArgs a) {
  const int size = 8 * a.num_octets;
  const int64_t cells = static_cast<int64_t>(a.num_tasks) * a.num_layers *
                        size * a.lanes;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= cells) return;
  const int lane = static_cast<int>(idx % a.lanes);
  int64_t rest = idx / a.lanes;
  const int row = static_cast<int>(rest % size);
  rest /= size;
  const int k = static_cast<int>(rest % a.num_layers);
  const int t = static_cast<int>(rest / a.num_layers);
  const int g1 = row >> 3;
  const int r1 = row & 7;
  const int64_t num_buckets = static_cast<int64_t>(a.num_tasks) *
                              a.num_slabs * a.num_octets;
  const int64_t win_elems = static_cast<int64_t>(kWinRows) * a.lanes;
  const int64_t half = static_cast<int64_t>(a.w_support) * num_buckets *
                       win_elems;
  float re = 0.0f;
  float im = 0.0f;
  for (int l = 0; l < a.w_support; ++l) {
    const int s = k - l;
    if (s < 0 || s >= a.num_slabs) continue;
    const int64_t b = (static_cast<int64_t>(t) * a.num_slabs + s) *
                      a.num_octets;
    const float* plane = a.wins + static_cast<int64_t>(l) * num_buckets *
                                      win_elems;
    float pr = 0.0f;
    float pi = 0.0f;
    if (g1 > 0 && a.visited[b + g1 - 1]) {
      const float* w = plane + (b + g1 - 1) * win_elems +
                       static_cast<int64_t>(r1 + 8) * a.lanes + lane;
      pr = __fadd_rn(pr, w[0]);
      pi = __fadd_rn(pi, w[half]);
    }
    if (a.visited[b + g1]) {
      const float* w = plane + (b + g1) * win_elems +
                       static_cast<int64_t>(r1) * a.lanes + lane;
      pr = __fadd_rn(pr, w[0]);
      pi = __fadd_rn(pi, w[half]);
    }
    re = __fadd_rn(re, pr);
    im = __fadd_rn(im, pi);
  }
  a.out[idx] = make_float2(re, im);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int sdp_torch_fold_windows(const float* wins, const bool* visited,
                           int num_tasks, int num_slabs, int num_octets,
                           int w_support, int num_layers, int lanes,
                           float* out, void* stream) {
  if (num_tasks < 1 || num_slabs < 1 || num_octets < 1 || w_support < 1 ||
      num_layers != num_slabs + w_support - 1 || lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FoldArgs a{wins, visited, num_tasks, num_slabs, num_octets,
                   w_support, num_layers, lanes, reinterpret_cast<float2*>(out)};
  const int64_t cells = static_cast<int64_t>(num_tasks) * num_layers * 8 *
                        num_octets * lanes;
  const unsigned ctas = static_cast<unsigned>((cells + kThreads - 1) / kThreads);
  fold_windows_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
