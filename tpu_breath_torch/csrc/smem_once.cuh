// Raise a kernel's dynamic shared-memory cap once per device, not at every
// launch: cudaFuncSetAttribute costs the host a few microseconds a call.
#pragma once
#include <cuda_runtime.h>

namespace smem_once {

constexpr int kMaxDevices = 64;

// done[d] holds the cap already set on device d (0: none). Each launcher
// keeps its own array for its own kernel.
inline cudaError_t raise(const void* kernel, int bytes,
                         int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace smem_once
