// Rope + KV-cache write for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/fused_rope_cache.py::_kernel (K5)
// in the [B, T] form of its _launch: B sequences of T new rows each. Rotate
// K in f32 with each row's cos/sin, cast f32 -> activation dtype -> cache
// dtype, and write exactly T rows of K and V into the stacked caches
// [L, B, S, kv, hd] at (layer, b, start_b..start_b+T) in place, with
// start_b = clamp(pos[b], 0, S - T) read from a device int32 vector — or
// from a host int for every row (the solo form, B = 1, cache [L, S, kv,
// hd]). The batched form is T = 1 (clamp to [0, S - 1]); the spec-verify
// form is the general [B, T].
//
// The rotation is written with explicit intrinsics as the single-rounding
// forms the JAX package's jitted rotation compiles to,
// r0 = fma(x0, c, -(x1 * s)) and r1 = fma(x0, s, x1 * c), so the cache bits
// equal the reference's; the float8 cast turns out-of-range values into NaN
// like the reference (common.cuh).
//
// What bounds it on the H100: launch latency. A decode step moves
// 2 * B * T * kv * hd elements in and out (8 KB per bf16 Llama-3-8B
// sequence and token), well under a microsecond of memory time.
//
// Design: one thread per rotation pair (b, t, head, j); it reads the two K
// elements of its pair and the matching two V elements and writes all four
// cache elements. Nothing else of the cache is touched.
#include "common.cuh"

namespace {

template <typename ActT, typename CacheT>
__global__ void rope_cache_kernel(const ActT* __restrict__ k, const ActT* __restrict__ v,
                                  const float* __restrict__ cos, const float* __restrict__ sin,
                                  CacheT* __restrict__ kc, CacheT* __restrict__ vc, int B,
                                  int T, int kv, int hd, int S, const int* __restrict__ pos_dev,
                                  int pos, int layer, int half_style) {
  const int half = hd / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * T * kv * half) return;
  const int j = i % half;
  const int th = i / half;
  const int head = th % kv;
  const int bt = th / kv;  // b * T + t
  const int t = bt % T;
  const int b = bt / T;
  const int start = min(max(pos_dev != nullptr ? pos_dev[b] : pos, 0), S - T);
  const int i0 = half_style ? j : 2 * j;
  const int i1 = half_style ? j + half : 2 * j + 1;
  const size_t src = ((size_t)bt * kv + head) * hd;
  const float x0 = dllama::to_f32(k[src + i0]);
  const float x1 = dllama::to_f32(k[src + i1]);
  const float c = cos[(size_t)bt * half + j];
  const float s = sin[(size_t)bt * half + j];
  const float r0 = __fmaf_rn(x0, c, -__fmul_rn(x1, s));
  const float r1 = __fmaf_rn(x0, s, __fmul_rn(x1, c));
  const size_t dst = ((((size_t)layer * B + b) * S + start + t) * kv + head) * hd;
  kc[dst + i0] = dllama::from_f32<CacheT>(dllama::to_f32(dllama::from_f32<ActT>(r0)));
  kc[dst + i1] = dllama::from_f32<CacheT>(dllama::to_f32(dllama::from_f32<ActT>(r1)));
  vc[dst + i0] = dllama::from_f32<CacheT>(dllama::to_f32(v[src + i0]));
  vc[dst + i1] = dllama::from_f32<CacheT>(dllama::to_f32(v[src + i1]));
}

struct Launch {
  const void *k, *v, *cos, *sin;
  void *kc, *vc;
  int B, T, kv, hd, S;
  const int* pos_dev;
  int pos, layer, half_style;
};

template <typename ActT, typename CacheT>
int launch(const Launch& a, cudaStream_t st) {
  const int n = a.B * a.T * a.kv * (a.hd / 2);
  const int threads = 128;
  rope_cache_kernel<ActT, CacheT><<<(n + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const ActT*>(a.k), static_cast<const ActT*>(a.v),
      static_cast<const float*>(a.cos), static_cast<const float*>(a.sin),
      static_cast<CacheT*>(a.kc), static_cast<CacheT*>(a.vc), a.B, a.T, a.kv, a.hd, a.S,
      a.pos_dev, a.pos, a.layer, a.half_style);
  return static_cast<int>(cudaGetLastError());
}

template <typename ActT>
int launch_act(int cache_kind, const Launch& a, cudaStream_t st) {
  switch (cache_kind) {
    case 0: return launch<ActT, float>(a, st);
    case 1: return launch<ActT, __nv_bfloat16>(a, st);
    case 2: return launch<ActT, dllama::F8>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// k, v: [B, T, kv, hd] of kind 0 f32 / 1 bf16; cos, sin: f32 [B, T, hd/2];
// caches [L, B, S, kv, hd] of kind 0 f32 / 1 bf16 / 2 f8, written in place
// at rows clamp(pos_dev[b], 0, S - T) (device int32 [B]) or, with pos_dev
// null, clamp(pos, 0, S - T) for every b.
extern "C" int dllama_rope_cache_update(const void* k, const void* v, const void* cos,
                                        const void* sin, void* k_cache, void* v_cache, int B,
                                        int T, int kv, int hd, int S, const void* pos_dev,
                                        int pos, int layer, int half_style, int act_kind,
                                        int cache_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch a{k, v, cos, sin, k_cache, v_cache, B, T, kv, hd, S,
                 static_cast<const int*>(pos_dev), pos, layer, half_style};
  switch (act_kind) {
    case 0: return launch_act<float>(cache_kind, a, st);
    case 1: return launch_act<__nv_bfloat16>(cache_kind, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
