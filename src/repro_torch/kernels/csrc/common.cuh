// Shared helpers for the port's hand-written Hopper kernels.
//
// Each .cu file in this directory builds into its own shared library with a
// plain C interface (nvcc -shared, loaded through ctypes by
// repro_torch/kernels/build.py, which reads the argument types from the
// exported C prototypes here and in each source, so their types must be
// ones in build.py's C_TYPES table).  Every launcher takes
// the PyTorch stream and device index from the Python wrapper, launches on
// that stream under a DeviceGuard, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Makes `device` current for the launch and restores the caller's device
// after it, switching only when they differ: the calling thread's current
// device is PyTorch's to keep, and the common case costs one cudaGetDevice.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// Elementwise plane-stack kernels run one thread per complex element on a
// 2-D grid: x covers the H*W pixels of one field slab, y walks the slabs.
constexpr int kElementwiseThreads = 256;
constexpr int64_t kMaxGridY = 65535;

inline dim3 elementwise_grid(int64_t hw, int64_t slabs) {
  const int64_t gx = (hw + kElementwiseThreads - 1) / kElementwiseThreads;
  const int64_t gy = slabs < kMaxGridY ? slabs : kMaxGridY;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
}

// SMs x resident blocks a SM of one kernel at one block size and shared
// memory size, asked of the occupancy API once per device and kept: a
// launcher that sizes its grid to whole waves reads it on every call.
constexpr int kMaxDevices = 64;

struct ResidentBlocks {
  std::atomic<int> per_device[kMaxDevices] = {};

  template <typename Kernel>
  cudaError_t get(Kernel kernel, int threads, size_t smem, int device,
                  int* out) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    int n = per_device[device].load(std::memory_order_relaxed);
    if (n == 0) {
      int sms = 0, per_sm = 0;
      cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
      }
      if (err != cudaSuccess) return err;
      n = sms * (per_sm > 0 ? per_sm : 1);
      per_device[device].store(n, std::memory_order_relaxed);
    }
    *out = n;
    return cudaSuccess;
  }
};
