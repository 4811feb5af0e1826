// Shared element conversions for the port's kernels.
//
// Activations are bf16 or f32; caches are f32, bf16 or float8_e4m3fn (kind
// codes 0, 1, 2, matching ops.fused_rope_cache.CACHE_KINDS). The float8 cast
// follows the JAX package: a value that rounds past 448 (|x| > 464, or inf)
// becomes NaN — e4m3fn has no infinity — never a saturated +-448.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dllama {

struct F8 {  // float8_e4m3fn storage
  uint8_t bits;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(F8 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.bits, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ F8 from_f32<F8>(float v) {
  F8 out;
  out.bits = (fabsf(v) <= 464.f)
                 ? (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3)
                 : (uint8_t)0x7F;  // NaN (also for NaN and inf inputs)
  return out;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The dequant-matmul kernels' activation element: x[t, k] rounded to bf16
// or, with the fused-norm epilogue (inv != nullptr), bf16(nw[k] * (x[t, k] *
// inv[t])) — ops/norms.py's f32 order, written with __fmul_rn so nvcc cannot
// contract it into an FMA: fused equals unfused bit for bit.
template <typename XT>
__device__ __forceinline__ float act_bf16(const XT* x, int K, int t, size_t k,
                                          const float* inv, const float* nw) {
  float v = to_f32(x[(size_t)t * K + k]);
  if (inv != nullptr) v = __fmul_rn(nw[k], __fmul_rn(v, inv[t]));
  return round_bf16(v);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing. The decode GEMVs stream weights through L2 only (.cg) and
// keep scales, which the chunks of a superblock read again, in L1 (.ca).
// The "memory" clobbers keep the compiler from moving shared memory reads
// across the copies and the waits.
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy16_l1(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[i] = sum over splits of partials[split][i], in split order (defined in
// common.cu): the split-K kernels' fixed-order second pass.
void sum_splits(const float* partials, int ksplit, size_t n, float* out, cudaStream_t st);

}  // namespace dllama
