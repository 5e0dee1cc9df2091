// Multi-stream device-memory read probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of bench.py's roofline probe
// (_measure_rooflines.stream_loop, body _read_kernel). That kernel reads
// n_streams [R, C] f32 arrays in (br, bc) blocks and writes, per block,
//   out[8 i + r, 128 j + l] = s * sum_k sum_{rows of block i} x_k[row, bc j + l]
// for l < 128 only. A kernel that read only those 128 columns of each
// block would compute the same function and measure nothing, so this one
// sums EVERY column of each row block over the streams:
//   sums[i][c] = sum_{rows of block i} sum_k s * x_k[row][c]     [R / br, C]
// and the wrapper (read_probe.py) slices and broadcasts the TPU layout
// from it. Every byte of every stream is read exactly once.
//
// What bounds it on an H100: the reads, n_streams * R * C * 4 bytes (805 MB
// at bench's 6 x [4096, 8192]); the sums are 1/br of that. The design: a
// CTA of 32 x 16 threads owns a 128-column tile of one row block; each
// thread reads one float4 per (row, stream) at a stride of 16 rows, so a
// warp reads 512 contiguous bytes per load, and a thread keeps n_streams
// independent loads in flight. The 16 row partials are
// summed in shared memory: no atomics, the result is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 128;                 // columns per CTA (32 float4)
constexpr int kRowThreads = 16;
constexpr int kMaxStreams = 8;

struct Streams {
  const float4* x[kMaxStreams];
};

__global__ void __launch_bounds__(32 * kRowThreads)
read_streams_kernel(Streams s, int n_streams, int cols, int block_rows,
                    float scale, float* __restrict__ sums) {
  __shared__ float4 part[kRowThreads][32];
  const int tx = threadIdx.x;              // float4 column in the tile
  const int ty = threadIdx.y;              // row lane
  const int c4 = blockIdx.x * 32 + tx;     // float4 column
  const int row0 = blockIdx.y * block_rows;
  const int ld4 = cols / 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = ty; r < block_rows; r += kRowThreads) {
    const int64_t off = static_cast<int64_t>(row0 + r) * ld4 + c4;
#pragma unroll
    for (int k = 0; k < kMaxStreams; ++k) {
      if (k < n_streams) {
        const float4 v = __ldg(s.x[k] + off);
        acc.x += v.x * scale;
        acc.y += v.y * scale;
        acc.z += v.z * scale;
        acc.w += v.w * scale;
      }
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float4 t = part[0][tx];
#pragma unroll
    for (int q = 1; q < kRowThreads; ++q) {
      const float4 v = part[q][tx];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    reinterpret_cast<float4*>(sums)[static_cast<int64_t>(blockIdx.y) * ld4
                                    + c4] = t;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). `xs` holds
// n_streams device pointers to [rows, cols] f32 arrays (16-byte aligned);
// sums is [rows / block_rows, cols] f32.
int sdp_torch_read_streams(void* const* xs, int n_streams, int rows,
                           int cols, int block_rows, float scale, float* sums,
                           void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || rows < 1 || cols < 1 ||
      cols % kCols != 0 || block_rows < 1 || rows % block_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Streams s{};
  for (int k = 0; k < n_streams; ++k) {
    s.x[k] = static_cast<const float4*>(xs[k]);
  }
  const dim3 grid(cols / kCols, rows / block_rows);
  const dim3 block(32, kRowThreads);
  read_streams_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n_streams, cols, block_rows, scale, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
