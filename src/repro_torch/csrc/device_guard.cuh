// The caller's current device, kept across a launcher's call.
//
// Each launcher takes the device of its tensors and must make it current
// for its launches; a mesh drives shards on several cards from one
// thread, so the launcher must also set the caller's device back on every
// return path.  Otherwise, after a launch on cuda:1, PyTorch's "cuda" and
// current stream on that thread would point at the wrong card.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  bool switched = false;
  cudaError_t err;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
