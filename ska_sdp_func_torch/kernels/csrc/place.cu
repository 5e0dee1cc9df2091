// Padded-stream placement (gap insertion) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel place_stream_pallas
// (ska_sdp_func_tpu/kernels/place.py, _place_kernel). Output block i of bv
// slots copies vcnt[i] consecutive entries of each key-sorted payload from
// src0[i] on, and zero-fills the rest:
//   placed[i * bv + r] = sorted[src0[i] + r]  if r < vcnt[i] and
//                                             0 <= src0[i] + r < n, else 0
// (src0 may be anything where vcnt[i] <= 0). Payloads are 32-bit words of
// any type (int32 plan words, f32 visibilities), up to kMaxOps a launch.
//
// What bounds it on an H100: a copy, 8 bytes of device-memory traffic per
// slot and payload (read + write) at most. The TPU kernel needed
// 1024-aligned DMA windows and two rotates to realign them. Here the
// output side is aligned (block i starts at i * bv) and only the source
// side, src0[i], is arbitrary. Persistent CTAs, 8 an SM, walk the output
// as one flat sequence of 16-byte vectors (4 slots of one block, whatever
// bv is, so every lane is busy at any bv): for each vector a thread issues
// every payload's loads before any of its stores, and writes each payload
// as one aligned 16-byte store. A vector's 4 source words are read as
// 4-byte loads, coalesced across the warp (reading the aligned 16-byte
// vectors that hold them and realigning in registers measured 12 % slower
// on an H100: twice the L1 requests where src0 is off the boundary, and 74
// registers against 48), so any src0 and any payload view take the same
// path; words past vcnt or past the payload's ends are not read. When
// bv % 4 != 0 or an output is not 16-byte aligned, the same kernel runs
// word by word (one slot of every payload a thread).

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kMaxOps = 8;

struct Payloads {
  const uint32_t* src[kMaxOps];
  uint32_t* dst[kMaxOps];
};

__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ src,
                                         int64_t s, int r, int vc,
                                         int64_t n) {
  return (r < vc && s >= 0 && s < n) ? __ldg(src + s) : 0u;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
place_stream_kernel(const int* __restrict__ src0,
                    const int* __restrict__ vcnt, const Payloads ops,
                    int n_ops, int64_t n, int bv, uint32_t units) {
  // A unit: 4 slots (a 16-byte vector) of every payload, or one slot.
  const uint32_t per = VEC ? bv / 4 : bv;
  for (uint32_t g = blockIdx.x * kThreads + threadIdx.x; g < units;
       g += gridDim.x * kThreads) {
    const uint32_t i = g / per;
    const int r = static_cast<int>(g - i * per) * (VEC ? 4 : 1);
    const int vc = __ldg(vcnt + i);
    const int64_t s = static_cast<int64_t>(__ldg(src0 + i)) + r;
    const int64_t o = static_cast<int64_t>(i) * bv + r;
    if (VEC) {
      uint4 x[kMaxOps];
#pragma unroll
      for (int j = 0; j < kMaxOps; ++j) {
        if (j < n_ops) {
          const uint32_t* __restrict__ src = ops.src[j];
          x[j] = r < vc ? make_uint4(word(src, s, r, vc, n),
                                     word(src, s + 1, r + 1, vc, n),
                                     word(src, s + 2, r + 2, vc, n),
                                     word(src, s + 3, r + 3, vc, n))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxOps; ++j) {
        if (j < n_ops) *reinterpret_cast<uint4*>(ops.dst[j] + o) = x[j];
      }
    } else {
      uint32_t x[kMaxOps];
#pragma unroll
      for (int j = 0; j < kMaxOps; ++j) {
        if (j < n_ops) x[j] = word(ops.src[j], s, r, vc, n);
      }
#pragma unroll
      for (int j = 0; j < kMaxOps; ++j) {
        if (j < n_ops) ops.dst[j][o] = x[j];
      }
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
  bool vec = bv % 4 == 0;
  for (int j = 0; j < n_ops; ++j) {
    ops.src[j] = static_cast<const uint32_t*>(srcs[j]);
    ops.dst[j] = static_cast<uint32_t*>(dsts[j]);
    vec = vec && reinterpret_cast<uintptr_t>(dsts[j]) % 16 == 0;
  }
  const int64_t slots = static_cast<int64_t>(num_blocks) * bv;
  const int64_t units = vec ? slots / 4 : slots;
  if (units > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t most = static_cast<int64_t>(sm_count()) * kCtasPerSm;
  if (most <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t need = (units + kThreads - 1) / kThreads;
  const int ctas = static_cast<int>(need < most ? need : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    place_stream_kernel<true><<<ctas, kThreads, 0, s>>>(
        src0, vcnt, ops, n_ops, n, bv, static_cast<uint32_t>(units));
  } else {
    place_stream_kernel<false><<<ctas, kThreads, 0, s>>>(
        src0, vcnt, ops, n_ops, n, bv, static_cast<uint32_t>(units));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
