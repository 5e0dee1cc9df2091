// Padded-stream placement (gap insertion) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel place_stream_pallas
// (ska_sdp_func_tpu/kernels/place.py, _place_kernel). Output block i of bv
// slots copies vcnt[i] consecutive entries of each key-sorted payload from
// src0[i] on, and zero-fills the rest:
//   placed[i * bv + r] = sorted[src0[i] + r]  if r < vcnt[i], else 0
// (reads past the payload's end give 0). Payloads are 32-bit words of any
// type (int32 plan words, f32 visibilities), up to kMaxOps per launch.
//
// What bounds it on an H100: a copy, 8 bytes of device-memory traffic per
// slot and payload (read + write). The TPU kernel needed 1024-aligned DMA
// windows and two rotates to realign them; here one CTA per output block
// copies with neighbouring threads on neighbouring words (coalesced reads
// at any src0 and aligned writes), no staging.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 8;

struct Payloads {
  const uint32_t* src[kMaxOps];
  uint32_t* dst[kMaxOps];
};

__global__ void __launch_bounds__(kThreads)
place_stream_kernel(const int* __restrict__ src0,
                    const int* __restrict__ vcnt, Payloads ops, int n_ops,
                    int64_t n, int bv) {
  const int i = blockIdx.x;
  const int64_t s0 = src0[i];
  const int vc = vcnt[i];
  const int64_t o0 = static_cast<int64_t>(i) * bv;
#pragma unroll
  for (int j = 0; j < kMaxOps; ++j) {
    if (j >= n_ops) break;
    const uint32_t* __restrict__ src = ops.src[j];
    uint32_t* __restrict__ dst = ops.dst[j];
    for (int r = threadIdx.x; r < bv; r += kThreads) {
      const int64_t s = s0 + r;
      dst[o0 + r] = (r < vc && s >= 0 && s < n) ? src[s] : 0u;
    }
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int sdp_torch_place_stream(const int* src0, const int* vcnt,
                           void* const* srcs, void* const* dsts, int n_ops,
                           int64_t n, int bv, int num_blocks, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || bv < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks <= 0) return 0;
  Payloads ops{};
  for (int j = 0; j < n_ops; ++j) {
    ops.src[j] = static_cast<const uint32_t*>(srcs[j]);
    ops.dst[j] = static_cast<uint32_t*>(dsts[j]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  place_stream_kernel<<<num_blocks, kThreads, 0, s>>>(src0, vcnt, ops, n_ops,
                                                      n, bv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
