// K3 — intensity_readout: detector |u|^2 pooled per class region.
//
// Replaces src/repro/kernels/intensity_readout.py::intensity_readout_pallas
// (def :33, pallas_call :41), driven by ops.intensity_readout.
//
//   out[b, c] = sum_hw masks[c, h, w] * (u_r^2 + u_i^2)
//
// u holds B complex64 fields (interleaved re/im), masks C general f32
// planes (not only 0/1), out is (B, C) f32.
//
// New semantics.  The Pallas kernel sums into one output block across grid
// steps, which is legal only because a TPU grid runs in order.  CUDA blocks
// run concurrently, so this is a deterministic two-pass reduction with no
// atomics: pass 1 gives each block one tile of kReadoutTile pixels of one
// field; every thread sums its pixels in a fixed order, a fixed shuffle tree
// reduces each warp, and one thread per class adds the warp sums in warp
// order into partial[b, tile, c].  Pass 2 adds the tiles of each (b, c) in
// tile order.  The tiling depends on H*W only, so a field's readout is
// bit-identical from run to run and whatever batch it is served in.
//
// Bound on the card: bytes.  Each field is read once (8 bytes a pixel); the
// C mask planes are read by every field but stay in the 50 MB L2 (C=10 at
// 200x200 is 1.6 MB).  A tile per block, rather than a block per field,
// keeps B * H*W / kReadoutTile blocks in flight (640 at B=32, 200x200), so
// the loads of all SMs overlap instead of 32 blocks waiting on latency.
#include "common.cuh"

constexpr int kReadoutThreads = 256;
constexpr int kPixelsPerThread = 8;
constexpr int kReadoutTile = kReadoutThreads * kPixelsPerThread;
constexpr int kClassChunk = 16;  // class accumulators held in registers
constexpr int kWarps = kReadoutThreads / 32;

__global__ void readout_partial_kernel(const float2* __restrict__ u,
                                       const float* __restrict__ masks,
                                       float* __restrict__ partial,
                                       int64_t rows, int64_t hw, int classes,
                                       int tiles) {
  const int tile = blockIdx.x;
  const int64_t base = static_cast<int64_t>(tile) * kReadoutTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ float warp_sums[kWarps][kClassChunk];

  for (int64_t b = blockIdx.y; b < rows; b += gridDim.y) {
    const float2* ub = u + b * hw;
    for (int c0 = 0; c0 < classes; c0 += kClassChunk) {
      const int nc = min(kClassChunk, classes - c0);
      float acc[kClassChunk];
#pragma unroll
      for (int k = 0; k < kClassChunk; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int j = 0; j < kPixelsPerThread; ++j) {
        const int64_t p = base + j * kReadoutThreads + threadIdx.x;
        if (p < hw) {
          const float2 v = ub[p];
          const float inten = v.x * v.x + v.y * v.y;
          const float* m = masks + static_cast<int64_t>(c0) * hw + p;
#pragma unroll
          for (int k = 0; k < kClassChunk; ++k) {
            if (k < nc) acc[k] += m[k * hw] * inten;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kClassChunk; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kClassChunk; ++k) warp_sums[warp][k] = acc[k];
      }
      __syncthreads();
      if (threadIdx.x < nc) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
        partial[(b * tiles + tile) * classes + c0 + threadIdx.x] = s;
      }
      __syncthreads();
    }
  }
}

__global__ void readout_finish_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int64_t rows,
                                      int classes, int tiles) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * classes) return;
  const int64_t b = i / classes;
  const int c = static_cast<int>(i - b * classes);
  const float* p = partial + b * tiles * classes + c;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += p[static_cast<int64_t>(t) * classes];
  out[i] = s;
}

extern "C" int readout_tile_pixels() { return kReadoutTile; }

// partial: caller-allocated scratch of rows * tiles * classes floats, with
// tiles = ceil(hw / readout_tile_pixels()).
extern "C" int intensity_readout(const void* u, const void* masks,
                                 void* partial, void* out, int64_t rows,
                                 int64_t hw, int classes, void* stream,
                                 int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (rows == 0 || classes == 0) return 0;
  const int tiles = static_cast<int>((hw + kReadoutTile - 1) / kReadoutTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 0) {
    const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
    readout_partial_kernel<<<dim3(tiles, static_cast<unsigned>(gy), 1),
                             kReadoutThreads, 0, s>>>(
        static_cast<const float2*>(u), static_cast<const float*>(masks),
        static_cast<float*>(partial), rows, hw, classes, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n = rows * classes;
  const int threads = 128;
  readout_finish_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(out), rows,
                                           classes, tiles);
  return static_cast<int>(cudaGetLastError());
}
