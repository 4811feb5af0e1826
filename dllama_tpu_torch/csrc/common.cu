// Error reporting shared by the port's C entry points: each returns
// cudaGetLastError() after its launches, and the Python side turns a
// non-zero code into an exception naming it.
#include <cuda_runtime.h>

extern "C" const char* dllama_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
