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
// and writes the TPU layout from them beside (out, when given). Every
// byte of every stream is read exactly once.
//
// What bounds it on an H100: the reads, n_streams * R * C * 4 bytes (805 MB
// at bench's 6 x [4096, 8192]); the sums are 1/br of that. The design: a
// CTA of 32 x 16 threads owns a 128-column tile of one row block; each
// thread reads one float4 per (row, stream) at a stride of 16 rows, so a
// warp reads 512 contiguous bytes per load. A thread keeps at least 4
// independent loads in flight whatever n_streams is: UNROLL rows a step
// (4 at one stream, 2 at two or three, 1 from four up), all their loads
// issued before the first add, which runs in row, then stream order as a
// one-row step does (the sums do not depend on UNROLL; rows past the last
// whole step take one-row steps). With one load in flight, one stream read
// at 1.66 TB/s on an H100 80GB HBM3, six at the card's rate. The 16 row
// partials are summed in shared memory: no atomics, the result is
// deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 128;                 // columns per CTA (32 float4)
constexpr int kRowThreads = 16;
constexpr int kMaxStreams = 8;

struct Streams {
  const float4* x[kMaxStreams];
};

// Rows r, r + 16, .., r + 16 (UNROLL - 1) of n_streams <= NMAX streams:
// the loads first, then the adds in row, then stream order.
template <int UNROLL, int NMAX>
__device__ __forceinline__ void add_rows(const Streams& s, int n_streams,
                                         int64_t off, int64_t ld4,
                                         float scale, float4& acc) {
  float4 v[UNROLL][NMAX];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
      if (k < n_streams) {
        v[u][k] = __ldg(s.x[k] + off + u * kRowThreads * ld4);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
      if (k < n_streams) {
        acc.x += v[u][k].x * scale;
        acc.y += v[u][k].y * scale;
        acc.z += v[u][k].z * scale;
        acc.w += v[u][k].w * scale;
      }
    }
  }
}

template <int UNROLL, int NMAX>
__global__ void __launch_bounds__(32 * kRowThreads, UNROLL == 4 ? 4 : 1)
read_streams_kernel(Streams s, int n_streams, int cols, int block_rows,
                    int block_cols, float scale, float* __restrict__ sums,
                    float* __restrict__ out) {
  __shared__ float4 part[kRowThreads][32];
  const int tx = threadIdx.x;              // float4 column in the tile
  const int ty = threadIdx.y;              // row lane
  const int c4 = blockIdx.x * 32 + tx;     // float4 column
  const int row0 = blockIdx.y * block_rows;
  const int64_t ld4 = cols / 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int r = ty;
  for (; r + (UNROLL - 1) * kRowThreads < block_rows;
       r += UNROLL * kRowThreads) {
    add_rows<UNROLL, NMAX>(s, n_streams, (row0 + r) * ld4 + c4, ld4, scale,
                           acc);
  }
  for (; r < block_rows; r += kRowThreads) {
    add_rows<1, NMAX>(s, n_streams, (row0 + r) * ld4 + c4, ld4, scale, acc);
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
    if (out != nullptr) {
      // out[8 i + r][128 j + l] = sums[i][bc j + l] for l < 128, r < 8.
      const int64_t width = static_cast<int64_t>(kCols) * (cols / block_cols);
      const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e;
        const int l = c % block_cols;
        if (l < kCols) {
          float* dst = out + 8 * static_cast<int64_t>(blockIdx.y) * width +
                       static_cast<int64_t>(c / block_cols) * kCols + l;
#pragma unroll
          for (int r = 0; r < 8; ++r) dst[r * width] = v[e];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). `xs` holds
// n_streams device pointers to [rows, cols] f32 arrays (16-byte aligned);
// sums is [rows / block_rows, cols] f32; out, when not null, the TPU
// layout [8 rows / block_rows, 128 cols / block_cols] f32.
int sdp_torch_read_streams(void* const* xs, int n_streams, int rows,
                           int cols, int block_rows, int block_cols,
                           float scale, float* sums, float* out,
                           void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || rows < 1 || cols < 1 ||
      cols % kCols != 0 || block_rows < 1 || rows % block_rows != 0 ||
      block_cols < kCols || cols % block_cols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Streams s{};
  for (int k = 0; k < n_streams; ++k) {
    s.x[k] = static_cast<const float4*>(xs[k]);
  }
  const dim3 grid(cols / kCols, rows / block_rows);
  const dim3 block(32, kRowThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_streams == 1) {
    read_streams_kernel<4, 1><<<grid, block, 0, st>>>(
        s, n_streams, cols, block_rows, block_cols, scale, sums, out);
  } else if (n_streams <= 3) {
    read_streams_kernel<2, 3><<<grid, block, 0, st>>>(
        s, n_streams, cols, block_rows, block_cols, scale, sums, out);
  } else {
    read_streams_kernel<1, kMaxStreams><<<grid, block, 0, st>>>(
        s, n_streams, cols, block_rows, block_cols, scale, sums, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
