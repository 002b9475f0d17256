// K1 — conj_phase_scale: the elementwise half of the fused spectral hop.
//
// Replaces src/repro/kernels/spectral_hop.py::conj_phase_scale_pallas
// (def :45, pallas_call :62), driven by ops.fused_spectral_hop.
//
//   out = conj(x) * amp * scale * exp(sign * j * theta)
//
// x is a plane-major stack of P*nb complex64 fields (interleaved re/im, the
// layout cuFFT returns), theta/amp are P real f32 planes, and plane p
// modulates the slab x[p*nb:(p+1)*nb] (plane index = slab / nb, as in the
// Pallas BlockSpec index map).  The hop M . ifft2(H . fft2(u)) runs as
// fft2 -> K1(-theta_H, |H|, 1) -> fft2 -> K1(+theta_M, |M|, 1/(H*W)) through
// ifft2(y) = conj(fft2(conj(y))) / (H*W).
//
// Bound on the card: bytes.  Per element it reads 8 bytes of field and
// writes 8, plus 8 bytes of plane that nb slabs share (one sincosf and ten
// flops are far below the H100's f32 rate).  Design: one thread per complex
// element, float2 loads and stores so a warp moves 256 contiguous bytes,
// the slab index from blockIdx.y so no thread divides by H*W.  sincosf is
// the accurate libdevice routine: this file must not be built with
// --use_fast_math, whose __sincosf loses accuracy as |theta| grows.
#include "common.cuh"

__global__ void conj_phase_scale_kernel(const float2* __restrict__ x,
                                        const float* __restrict__ theta,
                                        const float* __restrict__ amp,
                                        float2* __restrict__ out,
                                        int64_t slabs, int64_t hw, int64_t nb,
                                        float scale, float sign_scale) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  for (int64_t slab = blockIdx.y; slab < slabs; slab += gridDim.y) {
    const int64_t q = (slab / nb) * hw + pix;
    float s, c;
    sincosf(theta[q], &s, &c);
    const float a = amp[q];
    // operand order of the Pallas kernel: c = cos*amp*scale,
    // s_ = sin*(amp*(sign*scale))
    const float cw = c * a * scale;
    const float sw = s * (a * sign_scale);
    const int64_t i = slab * hw + pix;
    const float2 v = x[i];
    out[i] = make_float2(v.x * cw + v.y * sw, v.x * sw - v.y * cw);
  }
}

extern "C" int conj_phase_scale(const void* x, const void* theta,
                                const void* amp, void* out, int64_t slabs,
                                int64_t hw, int64_t nb, float scale,
                                float sign_scale, void* stream, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (slabs == 0 || hw == 0) return 0;
  conj_phase_scale_kernel<<<elementwise_grid(hw, slabs), kElementwiseThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(theta),
      static_cast<const float*>(amp), static_cast<float2*>(out), slabs, hw, nb,
      scale, sign_scale);
  return static_cast<int>(cudaGetLastError());
}
