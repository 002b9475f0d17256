// K2 — phase_tf_apply: the fused phase rotation + amplitude multiply (and K4
// — phase_apply, the eager engine's shared-plane modulation, further down).
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

// K4 — phase_apply: the eager engine's phase modulation.
//
// Replaces src/repro/kernels/complex_mul.py::phase_apply_pallas
// (def :60, pallas_call :70), driven by ops.phase_apply.
//
//   out = gamma * u * exp(j * phi)
//
// u holds `fields` complex64 fields (interleaved re/im), phi is ONE real
// f32 plane shared by every field, and gamma is a host scalar passed by
// value (no amplitude plane is read, unlike K2).  The eager
// DiffractiveLayer.modulate calls it on every modulated layer, forward
// and (at -phi) backward.
//
// Bound on the card: bytes (8 read + 8 written per element, plus the 4
// byte phase plane once).  Design: one thread per pixel of a field, float2
// accesses; the plane is shared, so each thread computes its sincosf once
// and walks kPhaseApplyFieldsPerThread fields with the same c/s (grid y
// strides the fields).  Operand order of _phase_apply_kernel: c =
// cos(phi)*gamma, s = sin(phi)*gamma, accurate sincosf (no
// --use_fast_math).
constexpr int64_t kPhaseApplyFieldsPerThread = 4;

__global__ void phase_apply_kernel(const float2* __restrict__ u,
                                   const float* __restrict__ phi,
                                   float2* __restrict__ out, int64_t fields,
                                   int64_t hw, float gamma) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  float s, c;
  sincosf(phi[pix], &s, &c);
  const float cw = c * gamma;
  const float sw = s * gamma;
  for (int64_t f = blockIdx.y; f < fields; f += gridDim.y) {
    const int64_t i = f * hw + pix;
    const float2 v = u[i];
    out[i] = make_float2(v.x * cw - v.y * sw, v.x * sw + v.y * cw);
  }
}

extern "C" int phase_apply(const void* u, const void* phi, void* out,
                           int64_t fields, int64_t hw, float gamma,
                           void* stream, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (fields == 0 || hw == 0) return 0;
  const int64_t rows = (fields + kPhaseApplyFieldsPerThread - 1) /
                       kPhaseApplyFieldsPerThread;
  phase_apply_kernel<<<elementwise_grid(hw, rows), kElementwiseThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(u), static_cast<const float*>(phi),
      static_cast<float2*>(out), fields, hw, gamma);
  return static_cast<int>(cudaGetLastError());
}

// K5 — complex_mul: the plain complex multiply, one (H, W) plane b shared by
// every field of a.
//
// Replaces src/repro/kernels/complex_mul.py::complex_mul_pallas
// (def :30, pallas_call :40), driven by ops.complex_mul.
//
//   out = a * b,  a: (B, H, W) complex64, b: (H, W) complex64
//
// The reference carries split real/imag planes; here both operands are
// complex64 (interleaved re/im), like K1/K2.  Its custom VJP calls the
// same kernel for da = g * conj(b) (the wrapper resolves the conjugate bit
// of b before taking its pointer).  No caller in the model paths: it is
// the ops entry point the reference exposes.
//
// Bound on the card: bytes (8 read + 8 written per element of a, plus the
// shared plane once).  Design as K4: one thread per pixel of a field,
// float2 accesses, the plane's value loaded once per thread and reused for
// kComplexMulFieldsPerThread fields (grid y strides the fields).  Operand
// order of _complex_mul_kernel: re = ar*br - ai*bi, im = ar*bi + ai*br.
constexpr int64_t kComplexMulFieldsPerThread = 4;

__global__ void complex_mul_kernel(const float2* __restrict__ a,
                                   const float2* __restrict__ b,
                                   float2* __restrict__ out, int64_t fields,
                                   int64_t hw) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const float2 w = b[pix];
  for (int64_t f = blockIdx.y; f < fields; f += gridDim.y) {
    const int64_t i = f * hw + pix;
    const float2 v = a[i];
    out[i] = make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
  }
}

extern "C" int complex_mul(const void* a, const void* b, void* out,
                           int64_t fields, int64_t hw, void* stream,
                           int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (fields == 0 || hw == 0) return 0;
  const int64_t rows = (fields + kComplexMulFieldsPerThread - 1) /
                       kComplexMulFieldsPerThread;
  complex_mul_kernel<<<elementwise_grid(hw, rows), kElementwiseThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<float2*>(out), fields, hw);
  return static_cast<int>(cudaGetLastError());
}
