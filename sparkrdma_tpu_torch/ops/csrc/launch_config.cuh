// launch_config.cuh — launch configuration shared by the kernel launchers
// that take more than 48 KiB of dynamic shared memory (flash_attn_fwd.cu,
// flash_attn_bwd.cu, flash_attn_fwd_sm90.cu, flash_attn_bwd_sm90.cu,
// flash_attn_fwd_tf32x3.cu, flash_attn_bwd_tf32x3.cu).
//
// cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...) applies to the
// function in the current device's context only. So the flag that saves
// the call on later launches is kept per device: one bit per device index
// from cudaGetDevice. A flag kept once per process would send the first
// launch on a second device out without the raised limit, and a launch
// above 48 KiB would fail there.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The devices on which one kernel's limit has been raised, one bit each.
struct PerDevice {
  std::atomic<uint64_t> done{0};
};

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device (on every launch for device indices >= 64).
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int bytes, PerDevice& devices) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev >= 0 && dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (devices.done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) devices.done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace
