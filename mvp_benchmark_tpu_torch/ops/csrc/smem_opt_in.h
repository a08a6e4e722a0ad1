// A kernel's dynamic shared memory limit (cudaFuncAttributeMaxDynamicShared-
// MemorySize) raised once a device for each size it grows to, for the
// sources whose kernels take more than the default 48 KB (chamfer.cu,
// emd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// One a kernel, as a function-local static beside its launch: the limit
// set so far on each of the first kDevices devices (a device beyond them
// sets it at every launch).
struct SmemOptIn {
  static constexpr int kDevices = 64;
  size_t opted[kDevices] = {};

  cudaError_t raise(const void* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < kDevices && opted[device] >= smem) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && device < kDevices) opted[device] = smem;
    return err;
  }
};

}  // namespace
