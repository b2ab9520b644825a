// Error strings for the Python wrappers: each C entry point returns the
// cudaGetLastError() code of its launches, and the wrapper raises with this
// text when it is not 0.

#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
