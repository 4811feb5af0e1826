// Rope + KV-cache write for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/fused_rope_cache.py::_kernel (K5),
// solo form: rotate K in f32 with the cos/sin rows of positions pos..pos+T,
// cast f32 -> activation dtype -> cache dtype, and write exactly T rows of K
// and V into the stacked caches [L, S, kv, hd] at (layer, start..start+T)
// in place; `start` arrives clamped to [0, S - T] by the wrapper.
//
// The rotation is written with explicit intrinsics as the single-rounding
// forms the JAX package's jitted rotation compiles to,
// r0 = fma(x0, c, -(x1 * s)) and r1 = fma(x0, s, x1 * c), so the cache bits
// equal the reference's; the float8 cast turns out-of-range values into NaN
// like the reference (common.cuh).
//
// What bounds it on the H100: launch latency. A decode step moves
// 2 * T * kv * hd elements in and out (8 KB for a bf16 Llama-3-8B token),
// well under a microsecond of memory time.
//
// Design: one thread per rotation pair (t, head, j); it reads the two K
// elements of its pair and the matching two V elements and writes all four
// cache elements. Nothing else of the cache is touched.
#include "common.cuh"

namespace {

template <typename ActT, typename CacheT>
__global__ void rope_cache_kernel(const ActT* __restrict__ k, const ActT* __restrict__ v,
                                  const float* __restrict__ cos, const float* __restrict__ sin,
                                  CacheT* __restrict__ kc, CacheT* __restrict__ vc, int T,
                                  int kv, int hd, int S, int start, int layer, int half_style) {
  const int half = hd / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * kv * half) return;
  const int j = i % half;
  const int th = i / half;
  const int head = th % kv;
  const int t = th / kv;
  const int i0 = half_style ? j : 2 * j;
  const int i1 = half_style ? j + half : 2 * j + 1;
  const size_t src = ((size_t)t * kv + head) * hd;
  const float x0 = dllama::to_f32(k[src + i0]);
  const float x1 = dllama::to_f32(k[src + i1]);
  const float c = cos[t * half + j];
  const float s = sin[t * half + j];
  const float r0 = __fmaf_rn(x0, c, -__fmul_rn(x1, s));
  const float r1 = __fmaf_rn(x0, s, __fmul_rn(x1, c));
  const size_t dst = (((size_t)layer * S + start + t) * kv + head) * hd;
  kc[dst + i0] = dllama::from_f32<CacheT>(dllama::to_f32(dllama::from_f32<ActT>(r0)));
  kc[dst + i1] = dllama::from_f32<CacheT>(dllama::to_f32(dllama::from_f32<ActT>(r1)));
  vc[dst + i0] = dllama::from_f32<CacheT>(dllama::to_f32(v[src + i0]));
  vc[dst + i1] = dllama::from_f32<CacheT>(dllama::to_f32(v[src + i1]));
}

template <typename ActT, typename CacheT>
int launch(const void* k, const void* v, const void* cos, const void* sin, void* kc, void* vc,
           int T, int kv, int hd, int S, int start, int layer, int half_style, cudaStream_t st) {
  const int n = T * kv * (hd / 2);
  const int threads = 128;
  rope_cache_kernel<ActT, CacheT><<<(n + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const ActT*>(k), static_cast<const ActT*>(v), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<CacheT*>(kc), static_cast<CacheT*>(vc), T, kv,
      hd, S, start, layer, half_style);
  return static_cast<int>(cudaGetLastError());
}

template <typename ActT>
int launch_act(int cache_kind, const void* k, const void* v, const void* cos, const void* sin,
               void* kc, void* vc, int T, int kv, int hd, int S, int start, int layer,
               int half_style, cudaStream_t st) {
  switch (cache_kind) {
    case 0:
      return launch<ActT, float>(k, v, cos, sin, kc, vc, T, kv, hd, S, start, layer, half_style, st);
    case 1:
      return launch<ActT, __nv_bfloat16>(k, v, cos, sin, kc, vc, T, kv, hd, S, start, layer,
                                         half_style, st);
    case 2:
      return launch<ActT, dllama::F8>(k, v, cos, sin, kc, vc, T, kv, hd, S, start, layer,
                                      half_style, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// k, v: [T, kv, hd] of kind 0 f32 / 1 bf16; cos, sin: f32 [T, hd/2];
// caches [L, S, kv, hd] of kind 0 f32 / 1 bf16 / 2 f8, written in place.
extern "C" int dllama_rope_cache_update(const void* k, const void* v, const void* cos,
                                        const void* sin, void* k_cache, void* v_cache, int T,
                                        int kv, int hd, int S, int start, int layer,
                                        int half_style, int act_kind, int cache_kind,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act_kind) {
    case 0:
      return launch_act<float>(cache_kind, k, v, cos, sin, k_cache, v_cache, T, kv, hd, S, start,
                               layer, half_style, st);
    case 1:
      return launch_act<__nv_bfloat16>(cache_kind, k, v, cos, sin, k_cache, v_cache, T, kv, hd,
                                       S, start, layer, half_style, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
