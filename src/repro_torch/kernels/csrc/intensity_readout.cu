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
// atomics.  It is a product (B x H*W intensities) x (H*W x C masks) with a
// long inner axis, split along the pixels:
//  - pass 1: block (tile, group) takes kReadoutTile pixels of up to 16
//    fields.  It stages the tile's masks in shared memory (cp.async, issued
//    first; 16-byte copies where the rows allow) and the fields'
//    intensities (warp w the fields w and w + 8, each lane 4 float4 = 8
//    pixels a field, all 8 loads in flight), then lane l of warp w sums,
//    for its two fields and every class, its pixels l + 32i (i < 8) in that
//    order: each mask value read from shared memory feeds both fields and
//    each intensity all classes.  A fixed transpose-and-add shuffle tree
//    (31 shuffles for 2 x 16 sums) adds the 32 lanes, and partial[b, c,
//    tile] gets the result;
//  - pass 2 adds each (b, c)'s tiles in tile order (a warp an output: lane l
//    the tiles 4l..4l+3, 128 a round, then a fixed shuffle tree).  It is
//    launched with programmatic stream serialization: pass 1 lets it launch
//    at once, and it waits (griddepcontrol.wait) until pass 1 has finished
//    and its writes are visible, so most of its launch overlaps pass 1.
// Every order depends on H*W (and C) only, never on B, on which warp, lane
// or block took a field, or on its alignment (an 8-byte-aligned field loads
// the same pixels with float2 in place of float4), so a field's readout is
// bit-identical from run to run and whatever batch it is served in.
//
// Bound on the card: bytes.  Each field is read once (8 bytes a pixel, 10.24
// MB at 32x200x200) and the C mask planes once (1.6 MB with C = 10): 11.84
// MB, 3.53 us at 3.35 TB/s.  The first design gave each of its 640 blocks
// one (2048-pixel tile, field), reloaded all C mask tiles in every block
// (51 MB through L2 for 10 MB of field), ran 1.21 waves and finished in a
// second launch.  Here a mask byte crosses L2 once per block (twice in all
// at B = 32), a batch of 32 at 200x200 is 157 tiles x 2 groups = 314 blocks
// in one wave (three blocks a SM are resident), and shared memory is read
// once per mask value and pixel pair of fields, not once per FMA.  Much of
// what remains above the bound is fixed cost: on an H100 SXM the two
// launches take 4.8 us at a 1x1 field, K5's one 2.4 us (chip_smoke.py's
// facts phase).  Classes go in compile-time chunks of kClassChunk (C = 17
// runs two chunks, the second rereading the fields).
#include "common.cuh"

constexpr int kReadoutThreads = 256;
constexpr int kWarps = kReadoutThreads / 32;
constexpr int kReadoutTile = 256;  // pixels a block: 8 a lane
constexpr int kGroupFields = 16;  // fields a block at once: 2 a warp
constexpr int kWarpFields = kGroupFields / kWarps;
constexpr int kColumns = kReadoutTile / 64;  // float4 columns a lane a field
constexpr int kLanePixels = kReadoutTile / 32;
constexpr int kClassChunk = 16;  // class sums held in registers
constexpr int kFinishThreads = 256;

// the tile axis of the partial sums, padded so each (b, c) row of tiles
// starts 16 bytes aligned for pass 2's float4 loads
inline int64_t padded_tiles(int64_t hw) {
  return ((hw + kReadoutTile - 1) / kReadoutTile + 3) & ~int64_t{3};
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One field's pixels of this tile for this lane: x[2i], x[2i+1] are the
// pixels base + 2 (lane + 32 i) and the next one (zero past H*W).
__device__ __forceinline__ void load_columns(const float2* __restrict__ uf,
                                             int64_t base, int64_t hw,
                                             int lane,
                                             float2 (&x)[2 * kColumns]) {
  if (base + kReadoutTile <= hw &&
      (reinterpret_cast<uintptr_t>(uf) & 15) == 0) {
    const float4* u4 = reinterpret_cast<const float4*>(uf + base);
#pragma unroll
    for (int i = 0; i < kColumns; ++i) {
      const float4 t = u4[lane + 32 * i];
      x[2 * i] = make_float2(t.x, t.y);
      x[2 * i + 1] = make_float2(t.z, t.w);
    }
  } else {
    const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kColumns; ++i) {
      const int64_t p = base + 2 * (lane + 32 * i);
      x[2 * i] = p < hw ? uf[p] : zero;
      x[2 * i + 1] = p + 1 < hw ? uf[p + 1] : zero;
    }
  }
}

__device__ __forceinline__ float intensity(float2 v) {
  return __fmaf_rn(v.x, v.x, __fmul_rn(v.y, v.y));
}

// One level of the transpose-and-add tree over kItems sums a lane: a lane
// keeps the lower half of its items if its bit kXor is clear, else the
// upper half, and adds the partner lane's copy of the half it keeps.
template <int kItems, int kXor>
__device__ __forceinline__ void keep_half(float* a, int lane) {
  constexpr int kHalf = kItems / 2;
  const bool up = lane & kXor;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? a[i] : a[i + kHalf];
    const float keep = up ? a[i + kHalf] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, kXor);
  }
}

// The warp's sums of 32 items a lane: 16 + 8 + 4 + 2 + 1 shuffles leave
// item `lane` of the sum over all 32 lanes in a[0].  Every item is added
// over the lanes in the same tree.
__device__ __forceinline__ void warp_sums32(float* a, int lane) {
  keep_half<32, 16>(a, lane);
  keep_half<16, 8>(a, lane);
  keep_half<8, 4>(a, lane);
  keep_half<4, 2>(a, lane);
  keep_half<2, 1>(a, lane);
}

// three blocks a SM (at most 85 registers a thread): 396 resident on 132
// SMs, so a 200x200 batch of 32 fields (157 tiles x 2 groups) runs in one
// wave
__global__ void __launch_bounds__(kReadoutThreads, 3)
readout_partial_kernel(const float2* __restrict__ u,
                       const float* __restrict__ masks,
                       float* __restrict__ partial, int64_t rows, int64_t hw,
                       int classes, int64_t tpad) {
  // pass 2 may launch now; it waits for this grid before reading partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float inten[kGroupFields][kReadoutTile];
  __shared__ float ms[kClassChunk][kReadoutTile];
  const int tile = blockIdx.x;
  const int64_t base = static_cast<int64_t>(tile) * kReadoutTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec_masks = base + kReadoutTile <= hw && hw % 4 == 0 &&
                         (reinterpret_cast<uintptr_t>(masks) & 15) == 0;

  for (int c0 = 0; c0 < classes; c0 += kClassChunk) {
    const int nc = min(kClassChunk, classes - c0);
    __syncthreads();  // no warp still reads the previous chunk's masks
    if (vec_masks) {  // 16-byte copies: 64 a class row
      for (int j = threadIdx.x; j < nc * (kReadoutTile / 4);
           j += kReadoutThreads) {
        const int k = j / (kReadoutTile / 4);
        const int q = 4 * (j % (kReadoutTile / 4));
        cp_async16(&ms[k][q], masks + static_cast<int64_t>(c0 + k) * hw +
                                  base + q);
      }
    } else {
      for (int k = 0; k < nc; ++k) {
        const int64_t p = base + threadIdx.x;
        if (p < hw) {
          cp_async4(&ms[k][threadIdx.x],
                    masks + static_cast<int64_t>(c0 + k) * hw + p);
        } else {
          ms[k][threadIdx.x] = 0.0f;
        }
      }
    }
    for (int64_t f0 = static_cast<int64_t>(blockIdx.y) * kGroupFields;
         f0 < rows; f0 += static_cast<int64_t>(gridDim.y) * kGroupFields) {
      // warp w stages the fields f0 + w + 8 s: 8 float4 loads a lane
      float2 x[kWarpFields][2 * kColumns];
#pragma unroll
      for (int s = 0; s < kWarpFields; ++s) {
        const int64_t f = f0 + warp + kWarps * s;
        if (f < rows) {
          load_columns(u + f * hw, base, hw, lane, x[s]);
        } else {
#pragma unroll
          for (int i = 0; i < 2 * kColumns; ++i) {
            x[s][i] = make_float2(0.0f, 0.0f);
          }
        }
      }
      __syncthreads();  // no warp still reads the previous group's fields
#pragma unroll
      for (int s = 0; s < kWarpFields; ++s) {
        float2* row = reinterpret_cast<float2*>(inten[warp + kWarps * s]);
#pragma unroll
        for (int i = 0; i < kColumns; ++i) {
          row[lane + 32 * i] =
              make_float2(intensity(x[s][2 * i]), intensity(x[s][2 * i + 1]));
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();

      float acc[kWarpFields * kClassChunk];
#pragma unroll
      for (int j = 0; j < kWarpFields * kClassChunk; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < kLanePixels; ++i) {
        const int p = lane + 32 * i;
        float iv[kWarpFields];
#pragma unroll
        for (int s = 0; s < kWarpFields; ++s) {
          iv[s] = inten[warp + kWarps * s][p];
        }
#pragma unroll
        for (int k = 0; k < kClassChunk; ++k) {
          if (k < nc) {
            const float m = ms[k][p];
#pragma unroll
            for (int s = 0; s < kWarpFields; ++s) {
              acc[s * kClassChunk + k] =
                  __fmaf_rn(m, iv[s], acc[s * kClassChunk + k]);
            }
          }
        }
      }
      warp_sums32(acc, lane);
      const int k = lane % kClassChunk;
      const int64_t f = f0 + warp + kWarps * (lane / kClassChunk);
      if (f < rows && k < nc) {
        partial[(f * classes + c0 + k) * tpad + tile] = acc[0];
      }
    }
  }
}

// Pass 2: warp o adds output o's tiles in tile order.
__global__ void __launch_bounds__(kFinishThreads)
readout_finish_kernel(const float* partial, float* __restrict__ out,
                      int64_t outs, int tiles, int64_t tpad) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t o =
      (static_cast<int64_t>(blockIdx.x) * kFinishThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= outs) return;  // whole warps: o is the same across a warp
  const float* p = partial + o * tpad;
  float s = 0.0f;
  for (int t = 4 * lane; t < tiles; t += 128) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p + t));
    s += v.x;
    if (t + 1 < tiles) s += v.y;
    if (t + 2 < tiles) s += v.z;
    if (t + 3 < tiles) s += v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) out[o] = s;
}

static ResidentBlocks readout_resident;

// partial sums the caller allocates: rows x classes x padded tiles floats
extern "C" int64_t readout_scratch_floats(int64_t rows, int64_t hw,
                                          int classes) {
  return rows * classes * padded_tiles(hw);
}

extern "C" int intensity_readout(const void* u, const void* masks,
                                 void* partial, void* out, int64_t rows,
                                 int64_t hw, int classes, void* stream,
                                 int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (rows == 0 || classes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hw == 0) {
    return static_cast<int>(
        cudaMemsetAsync(out, 0, rows * classes * sizeof(float), s));
  }
  if (reinterpret_cast<uintptr_t>(u) % sizeof(float2) != 0 ||
      reinterpret_cast<uintptr_t>(masks) % sizeof(float) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t tiles = (hw + kReadoutTile - 1) / kReadoutTile;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  cudaError_t err = readout_resident.get(
      readout_partial_kernel, kReadoutThreads, 0, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // grid rows: the batch's groups of 32 fields, no more than the resident
  // blocks allow beside the tiles (a block then walks several groups)
  const int64_t groups = (rows + kGroupFields - 1) / kGroupFields;
  int64_t gy = resident / tiles;
  if (gy > groups) gy = groups;
  if (gy > kMaxGridY) gy = kMaxGridY;
  if (gy < 1) gy = 1;
  const int64_t tpad = padded_tiles(hw);
  readout_partial_kernel<<<dim3(static_cast<unsigned>(tiles),
                                static_cast<unsigned>(gy), 1),
                           kReadoutThreads, 0, s>>>(
      static_cast<const float2*>(u), static_cast<const float*>(masks),
      static_cast<float*>(partial), rows, hw, classes, tpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t outs = rows * classes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      (outs * 32 + kFinishThreads - 1) / kFinishThreads));
  cfg.blockDim = dim3(kFinishThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, readout_finish_kernel, static_cast<const float*>(partial),
      static_cast<float*>(out), outs, static_cast<int>(tiles), tpad));
}
