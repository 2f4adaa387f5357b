// Host-side helpers the launchers of several kernels share: the current
// device, its limits, and a cache of each kernel instance's dynamic
// shared-memory limit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace launch_util {

constexpr int kMaxDevices = 64;

inline int current_device() {
  int device = 0;
  cudaGetDevice(&device);
  return device < kMaxDevices ? device : 0;
}

// the current device's SM count and shared-memory limits, read once
struct Limits {
  int sms = 0;
  int block_bytes = 0;  // a block's shared memory at most (opt-in)
  int sm_bytes = 0;     // an SM's
};

inline const Limits& device_limits() {
  static Limits cache[kMaxDevices];
  const int device = current_device();
  Limits& d = cache[device];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&d.sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
  }
  return d;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, calling
// cudaFuncSetAttribute only when the instance's need on this device grows
// (a launch on the host-bound paths makes no attribute call).
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  constexpr int kInstances = 32;
  static const void* keys[kMaxDevices][kInstances] = {};
  static size_t allowed[kMaxDevices][kInstances] = {};
  const int device = current_device();
  for (int i = 0; i < kInstances; ++i) {
    if (keys[device][i] != nullptr && keys[device][i] != kernel) continue;
    if (keys[device][i] == kernel && smem <= allowed[device][i]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess) {
      keys[device][i] = kernel;
      allowed[device][i] = smem;
    }
    return err;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace launch_util
