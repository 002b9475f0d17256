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
