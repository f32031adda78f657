// An empty kernel: the launch-overhead probe of ops/linkprobe.py.
//
// Replaces the `x + 1` round-trip probe of transferia_tpu/ops/linkprobe.py
// (lines 99 and 117).  It computes nothing, so it is timed, never checked.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int trt_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
