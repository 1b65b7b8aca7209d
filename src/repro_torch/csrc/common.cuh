// Shared by every kernel library of the port: the C entry that turns a
// returned cudaError_t into its message for the Python wrapper.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
