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
// shared plane once): 20.8 MB, 6.21 us at 32x200x200, beside a launch
// floor of about 2.4 us on an H100 SXM (chip_smoke.py's facts phase,
// a 1x1 field).  The first design, one thread per pixel on a (157, 8) grid of
// 256 threads, ran 1.19 waves of the 1056 resident blocks with one 8-byte
// load in flight a thread.  This one:
//  - treats a and out as one flat run of B*H*W elements moved as 16-byte
//    float4 pairs, b's index being i mod H*W (two float2 loads of b, which
//    stays in L2: a pair straddles two fields when H*W is odd);
//  - launches at most the resident capacity (SMs x blocks a SM from the
//    occupancy API) and walks the pairs grid-stride, kComplexMulPairs
//    pairs a thread at a time with all their loads issued before the
//    first store (a compile-time count, so the loop unrolls; one group
//    covers 32x200x200), and b's index stepped by a precomputed
//    (2 * threads) mod H*W, no division in the loop;
//  - takes an a that starts 8 bytes off a 16-byte boundary (a view such
//    as a[1:] of an odd-H*W batch) in the same launch: its first element
//    alone, then aligned pairs, then a lone last element; an out whose
//    phase differs from a's is written as two float2 a pair.
// Operand order of _complex_mul_kernel: re = ar*br - ai*bi,
// im = ar*bi + ai*br (no --use_fast_math).
constexpr int kComplexMulThreads = 256;
// four blocks a SM (at most 64 registers a thread, no spills): 528
// resident blocks, whose 135,168 threads take a 32x200x200 batch's 640,000
// pairs in one group of at most five, all loads in flight at once
constexpr int kComplexMulBlocksPerSM = 4;
constexpr int kComplexMulPairs = 5;

__device__ __forceinline__ float2 cmul(float2 v, float2 w) {
  return make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
}

// n = B*H*W elements; head = 1 when a starts 8 bytes off 16; pair_out when
// out shares a's phase; step = (2 * threads) mod hw.
__global__ void __launch_bounds__(kComplexMulThreads, kComplexMulBlocksPerSM)
complex_mul_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
                   float2* __restrict__ out, int64_t n, uint32_t hw,
                   int head, bool pair_out, uint32_t step) {
  const int64_t pairs = (n - head) >> 1;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q == 0 && head) out[0] = cmul(a[0], b[0]);
  if (q == 1 && ((n - head) & 1)) {
    out[n - 1] = cmul(a[n - 1], b[(n - 1) % hw]);
  }
  const float4* a2 = reinterpret_cast<const float4*>(a + head);
  float4* out2 = reinterpret_cast<float4*>(out + head);
  // the first pair's plane index: head + 2q < 2^32 (q < threads)
  uint32_t p =
      (static_cast<uint32_t>(head) + 2u * static_cast<uint32_t>(q)) % hw;
  for (; q < pairs; q += kComplexMulPairs * threads) {
    float4 v[kComplexMulPairs];
    float2 w0[kComplexMulPairs], w1[kComplexMulPairs];
#pragma unroll
    for (int j = 0; j < kComplexMulPairs; ++j) {
      if (q + j * threads < pairs) {
        v[j] = a2[q + j * threads];
        w0[j] = b[p];
        w1[j] = b[p + 1 == hw ? 0 : p + 1];
      }
      p += step;
      if (p >= hw) p -= hw;
    }
#pragma unroll
    for (int j = 0; j < kComplexMulPairs; ++j) {
      const int64_t k = q + j * threads;
      if (k < pairs) {
        const float2 lo = cmul(make_float2(v[j].x, v[j].y), w0[j]);
        const float2 hi = cmul(make_float2(v[j].z, v[j].w), w1[j]);
        if (pair_out) {
          out2[k] = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          out[head + 2 * k] = lo;
          out[head + 2 * k + 1] = hi;
        }
      }
    }
  }
}

static ResidentBlocks complex_mul_resident;

extern "C" int complex_mul(const void* a, const void* b, void* out,
                           int64_t fields, int64_t hw, void* stream,
                           int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (fields == 0 || hw == 0) return 0;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  if ((pa | po | reinterpret_cast<uintptr_t>(b)) % sizeof(float2) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (hw > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = complex_mul_resident.get(
      complex_mul_kernel, kComplexMulThreads, 0, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = fields * hw;
  const int head = static_cast<int>((pa / sizeof(float2)) & 1);
  const bool pair_out =
      ((po / sizeof(float2)) & 1) == static_cast<uintptr_t>(head);
  const int64_t pairs = (n - head) / 2;
  // at least two threads: thread 1 takes a lone last element
  int64_t blocks = (pairs + kComplexMulThreads - 1) / kComplexMulThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const uint32_t step = static_cast<uint32_t>(
      (2 * blocks * kComplexMulThreads) % hw);
  complex_mul_kernel<<<static_cast<unsigned>(blocks), kComplexMulThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<float2*>(out), n, static_cast<uint32_t>(hw), head, pair_out,
      step);
  return static_cast<int>(cudaGetLastError());
}
