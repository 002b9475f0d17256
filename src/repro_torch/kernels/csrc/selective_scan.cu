// K7 — selective_scan: the mamba-1 selective-scan forward.
//
// Replaces src/repro/kernels/selective_scan.py::selective_scan_pallas
// (def :48, pallas_call :56), driven by ops.selective_scan.
//
//   h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t ;  y_t = C_t . h_t
//   dt, x, y: (B, S, D); B, C: (B, S, N); A: (D, N); all float32, h_0 = 0
//
// The TPU kernel carries h for a block of D channels in VMEM through a
// fori_loop over t, one grid step per block, in order.  Here blocks run in
// parallel and no block depends on another: each thread owns one (b, d, n)
// state element and keeps h in a register for the whole sequence; the loop
// over t runs inside the block.  LANES = next power of two >= N threads
// share one channel d (16 for falcon-mamba's N = 16; lanes n >= N hold 0),
// and y_t is their __shfl_xor_sync sum, written by lane 0.  B_t and C_t are
// the same for every d of a batch row, so the block stages a tile of
// kScanTile steps of them in shared memory.  The ragged edge of D is
// masked (its threads still join the shuffles); D is not padded.
//
// Bound on the card: at the timed shape (B 8, S 2048, D 8192, N 16) the
// bytes (dt, x read and y written once: 1.61 GB, 0.48 ms at 3.35 TB/s)
// and the B*S*D*N = 2.1e9 exps (the SFU's ex2 rate, 16 a clock per SM)
// are of one order; the sequential dependence through h and the per-step
// shuffle reduction make it latency-bound unless enough blocks are
// resident.  accurate expf (no --use_fast_math).
#include "common.cuh"

constexpr int kScanThreads = 128;
constexpr int kScanTile = 64;

template <int LANES>
__global__ void __launch_bounds__(kScanThreads)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bs, const float* __restrict__ cs,
                      const float* __restrict__ a, float* __restrict__ y,
                      int64_t seq, int64_t dim, int64_t nstate) {
  constexpr int kChannels = kScanThreads / LANES;  // d channels per block
  __shared__ float sb[kScanTile * LANES];
  __shared__ float sc[kScanTile * LANES];
  const int64_t b = blockIdx.y;
  const int n = threadIdx.x % LANES;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kChannels +
                    threadIdx.x / LANES;
  const bool valid_d = d < dim;
  const bool valid = valid_d && n < nstate;
  const float a_dn = valid ? a[d * nstate + n] : 0.0f;
  const float* dt_b = dt + b * seq * dim;
  const float* x_b = x + b * seq * dim;
  const float* bs_b = bs + b * seq * nstate;
  const float* cs_b = cs + b * seq * nstate;
  float* y_b = y + b * seq * dim;
  float h = 0.0f;
  for (int64_t t0 = 0; t0 < seq; t0 += kScanTile) {
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < kScanTile * LANES; k += kScanThreads) {
      const int64_t t = t0 + k / LANES;
      const int nn = k % LANES;
      const bool in = t < seq && nn < nstate;
      sb[k] = in ? bs_b[t * nstate + nn] : 0.0f;
      sc[k] = in ? cs_b[t * nstate + nn] : 0.0f;
    }
    __syncthreads();
    const int steps = static_cast<int>(seq - t0 < kScanTile ? seq - t0
                                                            : kScanTile);
    for (int tt = 0; tt < steps; ++tt) {
      const int64_t i = (t0 + tt) * dim + d;
      const float dt_t = valid_d ? dt_b[i] : 0.0f;
      const float x_t = valid_d ? x_b[i] : 0.0f;
      const float da = expf(dt_t * a_dn);
      h = da * h + (dt_t * x_t) * sb[tt * LANES + n];
      float v = h * sc[tt * LANES + n];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (n == 0 && valid_d) y_b[i] = v;
    }
  }
}

template <int LANES>
static void scan_launch(const void* dt, const void* x, const void* bs,
                        const void* cs, const void* a, void* y, int64_t batch,
                        int64_t seq, int64_t dim, int64_t nstate,
                        cudaStream_t stream) {
  constexpr int kChannels = kScanThreads / LANES;
  const dim3 grid(static_cast<unsigned>((dim + kChannels - 1) / kChannels),
                  static_cast<unsigned>(batch));
  selective_scan_kernel<LANES><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bs), static_cast<const float*>(cs),
      static_cast<const float*>(a), static_cast<float*>(y), seq, dim, nstate);
}

extern "C" int selective_scan(const void* dt, const void* x, const void* bs,
                              const void* cs, const void* a, void* y,
                              int64_t batch, int64_t seq, int64_t dim,
                              int64_t nstate, void* stream, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (batch == 0 || seq == 0 || dim == 0) return 0;
  if (nstate < 1 || nstate > 32 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nstate <= 1) {
    scan_launch<1>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  } else if (nstate <= 2) {
    scan_launch<2>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  } else if (nstate <= 4) {
    scan_launch<4>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  } else if (nstate <= 8) {
    scan_launch<8>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  } else if (nstate <= 16) {
    scan_launch<16>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  } else {
    scan_launch<32>(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s);
  }
  return static_cast<int>(cudaGetLastError());
}
