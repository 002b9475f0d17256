// K6 — rope: rotary position embedding, rotate-half convention.
//
// Replaces src/repro/kernels/rope.py::rope_pallas (def :30, pallas_call :36),
// driven by ops.apply_rope; repro.models.layers.apply_rotary reaches it
// under use_pallas=True.
//
//   x: (BN, S, D) rows of D = 2 * half features; cos/sin: (S, half)
//   out[..., :half] = x1 * cos - x2 * sin
//   out[..., half:] = x2 * cos + x1 * sin
//
// x, cos, sin and out share one dtype: float32 or bfloat16 (the LM's
// cfg.dtype), one launcher each.  Each element is read in its dtype,
// computed in float32 and rounded once on the store (the plain version
// rounds after every bf16 product; see ops.apply_rope for the tolerance).
// The backward is the same kernel at -sin.
//
// Bound on the card: bytes (x read and out written once; cos/sin, S*D
// elements, are shared by the BN rows and stay in L2).  Design: a block of
// 32 x 8 threads covers 8 rows; the 32 threads of a warp walk one row's
// pairs, so x1, x2, cos and sin are each read as contiguous runs, and the
// position s = row % S is computed once per row.  The ragged edges (rows,
// half not a multiple of 32) are masked, nothing is padded.
#include "common.cuh"

#include <cuda_bf16.h>

constexpr int kRopeWarpX = 32;
constexpr int kRopeRowsPerBlock = 8;

__device__ __forceinline__ float rope_load(const float* p) { return *p; }
__device__ __forceinline__ float rope_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void rope_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void rope_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x, const T* __restrict__ cs,
                            const T* __restrict__ sn, T* __restrict__ out,
                            int64_t rows, int64_t seq, int64_t half) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRopeRowsPerBlock +
                      threadIdx.y;
  if (row >= rows) return;
  const int64_t s = row % seq;
  const T* xr = x + row * 2 * half;
  T* orow = out + row * 2 * half;
  const T* crow = cs + s * half;
  const T* srow = sn + s * half;
  for (int64_t i = threadIdx.x; i < half; i += kRopeWarpX) {
    const float x1 = rope_load(xr + i);
    const float x2 = rope_load(xr + half + i);
    const float c = rope_load(crow + i);
    const float sv = rope_load(srow + i);
    rope_store(orow + i, x1 * c - x2 * sv);
    rope_store(orow + half + i, x2 * c + x1 * sv);
  }
}

template <typename T>
static int rope_launch(const void* x, const void* cs, const void* sn,
                       void* out, int64_t rows, int64_t seq, int64_t half,
                       void* stream, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (rows == 0 || half == 0) return 0;
  const int64_t blocks = (rows + kRopeRowsPerBlock - 1) / kRopeRowsPerBlock;
  rope_kernel<T><<<static_cast<unsigned>(blocks),
                   dim3(kRopeWarpX, kRopeRowsPerBlock), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(cs),
      static_cast<const T*>(sn), static_cast<T*>(out), rows, seq, half);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rope_f32(const void* x, const void* cs, const void* sn,
                        void* out, int64_t rows, int64_t seq, int64_t half,
                        void* stream, int device) {
  return rope_launch<float>(x, cs, sn, out, rows, seq, half, stream, device);
}

extern "C" int rope_bf16(const void* x, const void* cs, const void* sn,
                         void* out, int64_t rows, int64_t seq, int64_t half,
                         void* stream, int device) {
  return rope_launch<__nv_bfloat16>(x, cs, sn, out, rows, seq, half, stream,
                                    device);
}
