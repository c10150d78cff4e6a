// A kernel's dynamic shared-memory limit, set safely across host threads.
//
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize) holds
// one value per kernel for all host threads. Serving threads launch the
// same kernel at several sizes at once (VGG16-BN's seams), so a launcher
// that set it to its own size could lower it under another thread's larger
// launch, which then failed (cudaErrorLaunchOutOfResources). So each launch
// sets it, under a lock, to the largest size asked so far: never lower
// than a launch in flight.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace cpg {

inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> most;  // (kernel, dev)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  int& have = most[{kernel, dev}];
  const int want = bytes > have ? bytes : have;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (err == cudaSuccess) have = want;
  return err;
}

}  // namespace cpg
