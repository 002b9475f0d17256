// transfer_planes: the free-space transfer planes of a candidate set, built
// on the card in one launch.
//
// Replaces no Pallas kernel: the reference builds every transfer function
// on the host with numpy (diffraction.transfer_function), and so do the
// port's single-model plans.  A design-space sweep scores K fresh
// geometries a set, each with its own L+1 hops, and never reuses one; on
// the host that build (K plans, their planes, the stacks and a pageable
// upload) held the card idle for most of a set.  This kernel writes the
// stacks in place on the card, driven by ops.transfer_planes_batched.
//
// geometry is a (K, 2 + G) f64 table: candidate k's pixel size, wavelength
// and G propagation distances.  Output row r = g * K + k (gap-major, so
// gap g of every candidate is one contiguous (K, n, n) slab) holds H of
// candidate k's gap g on an n x n grid (n = 2 x the plane under `pad`), in
// natural fftfreq order, as one pair of f32 planes: (arg H, |H|) when
// `polar`, (Re H, Im H) otherwise.  Per element, as transfer_function:
//
//   rs:      H = exp(j k z sqrt(1 - (l fx)^2 - (l fy)^2)), and
//            exp(-k |z| sqrt((l fx)^2 + (l fy)^2 - 1)) where evanescent;
//   fresnel: H = exp(j k z) exp(-j pi l z (fx^2 + fy^2));
//   band_limit: H = 0 where |fx| or |fy| > 1 / (l sqrt((2z / (n dx))^2 + 1))
//            (Matsushima & Shimobaba).
//
// The phase reaches k z ~ 5.9e6 rad at z = 0.5 m, where an f32 ulp is
// 0.5 rad: it is computed in f64 and reduced mod 2 pi before it is rounded
// to f32.  Every product and sum is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract one into an FMA: the masks fall on
// the same frequencies as numpy's, and ref.transfer_planes_ref repeats the
// arithmetic operation for operation.  No --use_fast_math (build.py).
//
// Bound on the card: bytes, 8 written per element (61.4 MB for K = 32,
// L + 1 = 6, 200 x 200), beside a few tens of f64 operations each (a sqrt,
// the reduction, a sincos or an exp).  Design: blockIdx.y walks the rows
// and each thread walks kPixelsPerThread pixels of a row, so a row's
// constants (frequency step, band limit, wavenumber) are computed once a
// thread and a row, not once a pixel; coalesced f32 stores; the reduction
// mod 2 pi is Cody-Waite's (q = rint(t / 2 pi), t - q C1 - q C2 with C1 + C2
// = 2 pi in double and q C1 exact for |q| < 2^27), not fmod's loop.
#include "common.cuh"

constexpr double kPi = 0x1.921fb54442d18p+1;
constexpr double kTwoPi = 0x1.921fb54442d18p+2;     // 2.0 * math.pi
constexpr double kTwoPiHi = 0x1.921fb5p+2;          // its top 26 bits
constexpr double kTwoPiLo = 0x1.110b46p-24;         // kTwoPi - kTwoPiHi
constexpr double kInvTwoPi = 0x1.45f306dc9c883p-3;  // 1 / (2.0 * math.pi)
constexpr int kPixelsPerThread = 8;

// t less its nearest multiple of 2 pi, in [-pi, pi] to rounding while
// |t / 2 pi| < 2^27 (8.4e8 rad).
static __device__ double wrap(double t) {
  const double q = rint(__dmul_rn(t, kInvTwoPi));
  return __dsub_rn(__dsub_rn(t, __dmul_rn(q, kTwoPiHi)),
                   __dmul_rn(q, kTwoPiLo));
}

// numpy.fft.fftfreq(n, dx)[i]: the signed integer i (i - n past the
// middle) times 1 / (n dx).
static __device__ double fftfreq(unsigned i, unsigned n, double step) {
  const int m = i < (n - 1) / 2 + 1 ? static_cast<int>(i)
                                    : static_cast<int>(i) - static_cast<int>(n);
  return __dmul_rn(static_cast<double>(m), step);
}

__global__ void transfer_planes_kernel(const double* __restrict__ geometry,
                                       float* __restrict__ a,
                                       float* __restrict__ b,
                                       int64_t candidates, int64_t gaps,
                                       unsigned n, int fresnel,
                                       int band_limit, int polar) {
  const unsigned hw = n * n;
  const int64_t rows = gaps * candidates;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t g = row / candidates, k = row - g * candidates;
    const double* geo = geometry + k * (2 + gaps);
    const double dx = geo[0], lam = geo[1], z = geo[2 + g];
    const double span = __dmul_rn(static_cast<double>(n), dx);
    const double step = __ddiv_rn(1.0, span);
    const double r = __ddiv_rn(__dmul_rn(2.0, z), span);
    const double f_limit = __ddiv_rn(
        1.0, __dmul_rn(lam, __dsqrt_rn(__dadd_rn(__dmul_rn(r, r), 1.0))));
    const double k0 = __ddiv_rn(kTwoPi, lam);
    // fresnel: exp(j k z) exp(j c (fx^2 + fy^2)), c = -(pi l) z
    const double kz = wrap(__dmul_rn(k0, z));
    const double c = -__dmul_rn(__dmul_rn(kPi, lam), z);
    float* out_a = a + row * hw;
    float* out_b = b + row * hw;
    for (unsigned pix = blockIdx.x * blockDim.x + threadIdx.x; pix < hw;
         pix += gridDim.x * blockDim.x) {
      const unsigned i = pix / n;
      const double fx = fftfreq(i, n, step), fy = fftfreq(pix - i * n, n, step);
      double theta = 0.0, amp = 0.0;
      if (!band_limit || (fabs(fx) <= f_limit && fabs(fy) <= f_limit)) {
        if (fresnel) {
          const double r2 = __dadd_rn(__dmul_rn(fx, fx), __dmul_rn(fy, fy));
          theta = wrap(__dadd_rn(kz, __dmul_rn(c, r2)));
          amp = 1.0;
        } else {
          const double lx = __dmul_rn(lam, fx), ly = __dmul_rn(lam, fy);
          const double arg = __dsub_rn(__dsub_rn(1.0, __dmul_rn(lx, lx)),
                                       __dmul_rn(ly, ly));
          if (arg >= 0.0) {
            theta = wrap(__dmul_rn(__dmul_rn(k0, __dsqrt_rn(arg)), z));
            amp = 1.0;
          } else {  // evanescent: exp(-k |z| sqrt(-arg))
            amp = exp(-__dmul_rn(__dmul_rn(k0, __dsqrt_rn(-arg)), fabs(z)));
          }
        }
      }
      if (polar) {
        out_a[pix] = static_cast<float>(theta);
        out_b[pix] = static_cast<float>(amp);
      } else {
        double s, co;
        sincos(theta, &s, &co);
        out_a[pix] = static_cast<float>(__dmul_rn(amp, co));
        out_b[pix] = static_cast<float>(__dmul_rn(amp, s));
      }
    }
  }
}

extern "C" int transfer_planes(const void* geometry, void* a, void* b,
                               int64_t candidates, int64_t gaps, int64_t n,
                               int fresnel, int band_limit, int polar,
                               void* stream, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const int64_t hw = n * n, rows = gaps * candidates;
  if (rows == 0 || hw == 0) return 0;
  if (hw > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = int64_t{kElementwiseThreads} * kPixelsPerThread;
  const dim3 grid(static_cast<unsigned>((hw + per_block - 1) / per_block),
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  transfer_planes_kernel<<<grid, kElementwiseThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(geometry), static_cast<float*>(a),
      static_cast<float*>(b), candidates, gaps, static_cast<unsigned>(n),
      fresnel, band_limit, polar);
  return static_cast<int>(cudaGetLastError());
}
