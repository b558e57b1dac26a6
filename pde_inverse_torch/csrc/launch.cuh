// Raising a kernel's dynamic shared-memory limit, shared by the kernel
// sources: allow_shared sets it on every call; allow_shared_once, for kernels
// whose calls take microseconds, sets it again only when a call needs more
// than it allows, so once per kernel, device and process for a fixed shape.

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace launch {

constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// `allowed` holds, per device, the limit last set for `kernel` (0 at first)
template <typename Kernel>
cudaError_t allow_shared_once(Kernel kernel, size_t smem, int device, size_t (&allowed)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return allow_shared(kernel, smem);
  if (smem <= allowed[device]) return cudaSuccess;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

}  // namespace launch
