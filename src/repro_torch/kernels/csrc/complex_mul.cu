// K2 — phase_tf_apply: the fused phase rotation + amplitude multiply.
//
// Replaces src/repro/kernels/complex_mul.py::phase_tf_apply_pallas
// (def :91, pallas_call :110), driven by ops.phase_tf_apply.
//
//   out = x * amp * exp(j * theta)
//
// Same plane-stack contract as K1: x holds P*nb complex64 fields
// (interleaved re/im), theta/amp hold P real f32 planes, plane p modulates
// the slab x[p*nb:(p+1)*nb].  The serving path calls it for the final hop's
// TF multiply (theta = arg H, amp = |H|) and, with rfft_first, for layer 0's
// frozen modulation (theta = phase, amp = gamma).
//
// Bound on the card: bytes (8 read + 8 written per element, planes shared
// by nb slabs).  Design as K1: one thread per complex element, float2
// accesses, slab from blockIdx.y, accurate sincosf (no --use_fast_math).
#include "common.cuh"

__global__ void phase_tf_apply_kernel(const float2* __restrict__ x,
                                      const float* __restrict__ theta,
                                      const float* __restrict__ amp,
                                      float2* __restrict__ out, int64_t slabs,
                                      int64_t hw, int64_t nb) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  for (int64_t slab = blockIdx.y; slab < slabs; slab += gridDim.y) {
    const int64_t q = (slab / nb) * hw + pix;
    float s, c;
    sincosf(theta[q], &s, &c);
    const float a = amp[q];
    const float cw = c * a;
    const float sw = s * a;
    const int64_t i = slab * hw + pix;
    const float2 v = x[i];
    out[i] = make_float2(v.x * cw - v.y * sw, v.x * sw + v.y * cw);
  }
}

extern "C" int phase_tf_apply(const void* x, const void* theta,
                              const void* amp, void* out, int64_t slabs,
                              int64_t hw, int64_t nb, void* stream,
                              int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (slabs == 0 || hw == 0) return 0;
  phase_tf_apply_kernel<<<elementwise_grid(hw, slabs), kElementwiseThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(theta),
      static_cast<const float*>(amp), static_cast<float2*>(out), slabs, hw,
      nb);
  return static_cast<int>(cudaGetLastError());
}
