// Shared by the port's C entry points: error reporting (each returns
// cudaGetLastError() after its launches, and the Python side turns a
// non-zero code into an exception naming it) and the split-K second pass.
#include "common.cuh"

namespace {

__global__ void sum_splits_kernel(const float* __restrict__ partials, int ksplit, size_t n,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partials[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

namespace dllama {

void sum_splits(const float* partials, int ksplit, size_t n, float* out, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(partials, ksplit, n, out);
}

}  // namespace dllama

extern "C" const char* dllama_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
