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
// parallel and none depends on another; the loop over t runs inside the
// block.
//
// What bounds it on the card, at B 8, S 2048, D 8192, N 16 (H100 SXM, 132
// SMs at 1.98 GHz, each SM's 4 schedulers issuing one warp instruction a
// clock; a warp instruction a state-step costs 64.2 us at this shape):
// - the bytes: dt and x read and y written once, 1.61 GB at 3.35 TB/s:
//   481.6 us, the roofline bound of the function (its 17 GFLOP take 256
//   us at the f32 peak);
// - the exps: B*S*D*N = 2.15e9, one MUFU.EX2 each at 16 a clock per SM,
//   8 clocks a warp instruction: 513.5 us, the bound of this design, which
//   puts every exp on the MUFU;
// - the instructions of a state-step, counted in the SASS of the step loop
//   (cuobjdump -sass; chip_smoke.py prints them on a [facts] line).
//   Accurate expf is 8 of them (5 FP32 for the range reduction, an IMAD
//   for 2^j, the MUFU.EX2 and a final FMUL), and dt*a, (dt*x)*B_n and the
//   FMAs of h_n and y add 4: 13.75 issued, 10.06 on the FP32 pipe, an issue
//   bound of 883 us, above the SFU's.  So the exp is one ex2.approx.ftz of
//   dt times A*log2(e), A scaled once a thread: 6.2 issued, 4.06 FP32 (398
//   and 261 us), and the SFU binds.  Its result differs from the plain
//   version's expf by an ulp or two a step; over S 2048 at general A the
//   largest gap measured in y was 4.3e-6 of its max (expf: 6e-7), inside
//   the 1e-5 every hold takes, and it grows with S.  .ftz flushes a
//   subnormal argument or result to zero: an argument that small gives
//   exp 1 either way, and a decay below 2^-126 (1.2e-38) flushed to 0
//   drops less than 1.2e-38 |h_{t-1}| from h_t.
//
// The design, against that:
// - One thread owns a whole (b, d) channel: its N states and A[d, :] sit
//   in registers (a template on NP, N's next power of two; states n >= N
//   have A = 0 and B = C = 0, so they stay 0).  y_t is summed inside the
//   thread in the order n = 0..N-1: no shuffle, no idle lane, and a warp
//   stores 32 neighbouring y values a step (128 bytes).  The N exps of a
//   step do not depend on h: N independent chains a step, and the step
//   loop is unrolled kScanUnroll (4) times so that a warp has the next
//   steps' exps to issue while one step's h and y wait.
// - A block is kScanThreads (128) consecutive channels of one batch row;
//   the grid is (ceil(D / 128), B), so D's ragged edge is the last block's
//   masked threads and nothing is padded.
// - dt and x reach shared memory a tile of kScanTile (16) steps at a
//   time, through cp.async (16 bytes a copy when D % 4 == 0 and both bases
//   are 16-byte aligned, else 4), in a ring of kScanStages (2) stages:
//   while tile k is scanned, tile k + 1 is in flight.  B and C (16 x NP)
//   ride in the same stage; every thread reads them at one address, a
//   broadcast, 16 bytes at a time.  Steps past S and channels past D are
//   zero-filled (cp.async's src-size 0): dt = 0 leaves h as it is, and
//   their y is not stored.
// - Occupancy: at B 8, D 8192 there are 65,536 channel threads, 512 blocks
//   of 128.  A stage is 18 KB at N 16, 36 KB a block; __launch_bounds__
//   holds NP <= 16 to the 128 registers that 4 resident blocks a SM allow:
//   528 slots, one wave, 4 warps a scheduler.  Those warps' MUFUs and
//   their share of HBM are what the card has for this shape.  B 1 fills 64
//   blocks, one warp a scheduler on half the SMs: a single sequence is too
//   little work for one thread a channel (chip_smoke.py prints that case's
//   share of its bound).
#include "common.cuh"

constexpr int kScanThreads = 128;  // channels a block, one thread each
constexpr int kScanTile = 16;  // steps a staged tile
constexpr int kScanStages = 2;  // tiles in the ring
constexpr int kScanUnroll = 4;  // steps a pass of the step loop
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kScanStages >= 2, "the ring needs a tile in flight");
static_assert(kScanTile % 4 == 0, "a stage must start 16 bytes aligned");
static_assert(kScanTile % kScanUnroll == 0, "whole passes a tile");

// floats of one ring stage: the dt and x tiles (kScanTile x kScanThreads),
// then the B and C tiles (kScanTile x NP)
template <int NP>
__host__ __device__ constexpr int scan_stage_floats() {
  return 2 * kScanTile * kScanThreads + 2 * kScanTile * NP;
}

template <int NP>
constexpr size_t scan_smem_bytes() {
  return sizeof(float) * kScanStages * scan_stage_floats<NP>();
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; `in` false zero-fills the destination (src-size
// 0) and reads nothing
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// exp(dt * A) as 2^(dt * a), a being A * log2(e), scaled once a thread
__device__ __forceinline__ float scan_exp(float dt, float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * a));
  return r;
}

// one step's B (or C) row from shared memory, 16 bytes at a time when NP
// allows it: every thread reads the same address, a broadcast
template <int NP>
__device__ __forceinline__ void load_row(float (&v)[NP], const float* p) {
  if constexpr (NP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NP; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) v[i] = p[i];
  }
}

// Issues the cp.asyncs of one tile into `stage`: its first step's dt and
// x of the block's first channel at dt_t and x_t, its B and C at bs_t and
// cs_t; `rows` steps and `cols` channels are in range, the rest zero-filled.
template <int NP>
__device__ __forceinline__ void load_tile(
    float* stage, const float* __restrict__ dt_t,
    const float* __restrict__ x_t, const float* __restrict__ bs_t,
    const float* __restrict__ cs_t, int rows, int cols, int64_t dim,
    int nstate, bool vec) {
  float* sdt = stage;
  float* sx = sdt + kScanTile * kScanThreads;
  float* sb = sx + kScanTile * kScanThreads;
  float* sc = sb + kScanTile * NP;
  if (vec) {  // dim % 4 == 0: a quad of channels is all in or all out
    constexpr int kQuads = kScanThreads / 4;  // quads a row
    constexpr int kRows = kScanThreads / kQuads;  // rows a pass
    const int c = (threadIdx.x % kQuads) * 4;
    const int r = threadIdx.x / kQuads;
    const bool col_in = c < cols;
#pragma unroll
    for (int i = 0; i < kScanTile / kRows; ++i) {
      const int tt = r + i * kRows;
      const bool in = col_in && tt < rows;
      const int64_t off = in ? tt * dim + c : 0;
      copy16(sdt + tt * kScanThreads + c, dt_t + off, in);
      copy16(sx + tt * kScanThreads + c, x_t + off, in);
    }
  } else {
    const int c = threadIdx.x;
    const bool col_in = c < cols;
#pragma unroll
    for (int tt = 0; tt < kScanTile; ++tt) {
      const bool in = col_in && tt < rows;
      const int64_t off = in ? tt * dim + c : 0;
      copy4(sdt + tt * kScanThreads + c, dt_t + off, in);
      copy4(sx + tt * kScanThreads + c, x_t + off, in);
    }
  }
  constexpr int kBC = kScanTile * NP;
#pragma unroll
  for (int j = 0; j < (kBC + kScanThreads - 1) / kScanThreads; ++j) {
    const int e = threadIdx.x + j * kScanThreads;
    if (kBC % kScanThreads == 0 || e < kBC) {
      const int tt = e / NP;
      const int n = e % NP;
      const bool in = tt < rows && n < nstate;
      const int off = in ? tt * nstate + n : 0;
      copy4(sb + e, bs_t + off, in);
      copy4(sc + e, cs_t + off, in);
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kScanThreads, NP <= 16 ? 4 : 1)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bs,
                      const float* __restrict__ cs,
                      const float* __restrict__ a, float* __restrict__ y,
                      int64_t seq, int64_t dim, int nstate, int vec) {
  extern __shared__ __align__(16) float ring[];
  constexpr int kStage = scan_stage_floats<NP>();
  const int c = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kScanThreads;
  const int64_t d = d0 + c;
  const bool valid_d = d < dim;
  const int cols = dim - d0 < kScanThreads ? static_cast<int>(dim - d0)
                                           : kScanThreads;
  const float* dt_b = dt + b * seq * dim + d0;
  const float* x_b = x + b * seq * dim + d0;
  const float* bs_b = bs + b * seq * nstate;
  const float* cs_b = cs + b * seq * nstate;
  float* y_d = y + b * seq * dim + d;

  float a_n[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a_n[n] = valid_d && n < nstate ? a[d * nstate + n] * kLog2e : 0.0f;
    h[n] = 0.0f;
  }

  const int64_t tiles = (seq + kScanTile - 1) / kScanTile;
  // the tile that starts at step t0 into ring stage s
  const auto load = [&](int64_t t0, int s) {
    const int rows = seq - t0 < kScanTile ? static_cast<int>(seq - t0)
                                          : kScanTile;
    load_tile<NP>(ring + s * kStage, dt_b + t0 * dim, x_b + t0 * dim,
                  bs_b + t0 * nstate, cs_b + t0 * nstate, rows, cols, dim,
                  nstate, vec);
  };
#pragma unroll
  for (int s = 0; s < kScanStages - 1; ++s) {
    if (s < tiles) load(s * kScanTile, s);
    copy_commit();  // an empty group keeps the wait count uniform
  }
  for (int64_t k = 0; k < tiles; ++k) {
    copy_wait<kScanStages - 2>();  // tile k has landed
    __syncthreads();  // ... for every thread; and tile k - 1 is consumed
    const int64_t next = k + kScanStages - 1;
    if (next < tiles) load(next * kScanTile, next % kScanStages);
    copy_commit();
    const float* sdt = ring + (k % kScanStages) * kStage;
    const float* sx = sdt + kScanTile * kScanThreads;
    const float* sb = sx + kScanTile * kScanThreads;
    const float* sc = sb + kScanTile * NP;
    const int64_t t0 = k * kScanTile;
    float* yp = y_d + t0 * dim;
    const int rows = seq - t0 < kScanTile ? static_cast<int>(seq - t0)
                                          : kScanTile;
#pragma unroll kScanUnroll
    for (int tt = 0; tt < kScanTile; ++tt) {
      const float dtv = sdt[tt * kScanThreads + c];
      const float dx = dtv * sx[tt * kScanThreads + c];
      float bv[NP], cv[NP];
      load_row<NP>(bv, sb + tt * NP);
      load_row<NP>(cv, sc + tt * NP);
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        h[n] = fmaf(scan_exp(dtv, a_n[n]), h[n], dx * bv[n]);
        acc = fmaf(h[n], cv[n], acc);
      }
      if (valid_d && tt < rows) *yp = acc;
      yp += dim;
    }
  }
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NP>
static cudaError_t scan_launch(const void* dt, const void* x, const void* bs,
                               const void* cs, const void* a, void* y,
                               int64_t batch, int64_t seq, int64_t dim,
                               int64_t nstate, cudaStream_t stream) {
  constexpr size_t smem = scan_smem_bytes<NP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec = dim % 4 == 0 && aligned16(dt) && aligned16(x);
  const dim3 grid(static_cast<unsigned>((dim + kScanThreads - 1) /
                                        kScanThreads),
                  static_cast<unsigned>(batch));
  selective_scan_kernel<NP><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bs), static_cast<const float*>(cs),
      static_cast<const float*>(a), static_cast<float*>(y), seq, dim,
      static_cast<int>(nstate), vec);
  return cudaGetLastError();
}

// NP, the kernel's template argument for N states: N's next power of two
static int scan_np(int64_t nstate) {
  int np = 1;
  while (np < nstate) np *= 2;
  return np;
}

// Dynamic shared memory of a launch at N states (bytes), -1 outside 1..32:
// what the resident-block count of each instantiation has to include.
extern "C" int64_t selective_scan_smem_bytes(int64_t nstate) {
  if (nstate < 1 || nstate > 32) return -1;
  switch (scan_np(nstate)) {
    case 1: return scan_smem_bytes<1>();
    case 2: return scan_smem_bytes<2>();
    case 4: return scan_smem_bytes<4>();
    case 8: return scan_smem_bytes<8>();
    case 16: return scan_smem_bytes<16>();
    default: return scan_smem_bytes<32>();
  }
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
  const auto run = [&](auto launch) {
    return static_cast<int>(
        launch(dt, x, bs, cs, a, y, batch, seq, dim, nstate, s));
  };
  switch (scan_np(nstate)) {
    case 1: return run(scan_launch<1>);
    case 2: return run(scan_launch<2>);
    case 4: return run(scan_launch<4>);
    case 8: return run(scan_launch<8>);
    case 16: return run(scan_launch<16>);
    default: return run(scan_launch<32>);
  }
}
