// Host-side launch helpers shared by the kernels' C launchers.
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
// multiprocessor count hold per device.  The slabs of a decomposed run
// (fbpic_tpu_torch/parallel/) launch the same kernels on several cards
// from one process, in threads, so both are kept per device, and the
// grant is made under a lock.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace fbpic_launch {

constexpr int MAX_DEVICES = 64;

// Grant `kernel` at least `smem` bytes of dynamic shared memory on the
// current device.  `granted` is the kernel's own table (one entry per
// device).  Returns a cudaError_t as int.
template <typename Kernel>
inline int grant_smem(Kernel kernel, size_t smem, size_t* granted) {
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> guard(lock);
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = smem;
  }
  return static_cast<int>(cudaSuccess);
}

// The current device's multiprocessor count (looked up once per device).
inline int sm_count(int* n_sm) {
  static std::mutex lock;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  std::lock_guard<std::mutex> guard(lock);
  if (n_sm[dev] == 0 &&
      cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    n_sm[dev] = 0;
  return n_sm[dev];
}

}  // namespace fbpic_launch
