// The C entry point every kernel library exports beside its launcher: the
// message of a CUDA error code, for the Python wrapper's exception. Each
// kernel source is its own shared library and includes this header once
// (directly or through frame.cuh), so each library exports one copy.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* tpu_sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
