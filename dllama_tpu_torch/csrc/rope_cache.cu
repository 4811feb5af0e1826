// Rope of q and K plus the K/V cache write of a decode step, for Hopper
// (sm_90a): one launch per layer.
//
// Replaces the TPU kernel dllama_tpu/ops/fused_rope_cache.py::_kernel (K5,
// rope of K and the cache write, through _launch for its solo, batched and
// verify forms) together with the rope of q that the JAX package computes
// beside it in plain jnp (dllama_tpu/models/llama.py apply_rope), which XLA
// fuses next to the kernel on the TPU.
//
// Function, for each row r = (b, t) of B sequences of T rows:
// - q_out[r] = rotate(q[r]) in the activation dtype;
// - K rotated in f32, cast f32 -> activation dtype -> cache dtype, and V
//   cast to the cache dtype, written at (layer, b, w) of the stacked caches
//   [L, B, S, kv, hd] in place, w = clamp(p, 0, S - T) + t with p =
//   pos_dev[b] (device int32 [B]) or the host int pos for every row;
// - the angle is table row w (angle_at_write: the solo form, whose table
//   slice clamps with the write) or clamp(p + t, 0, R - 1) (the batched and
//   verify forms, whose table gather clamps at the table's end). In the
//   verify form the two rows part near the end of the cache.
// The rotation is written with explicit intrinsics as the single-rounding
// forms the JAX package's jitted rotation compiles to,
// r0 = fma(x0, c, -(x1 * s)) and r1 = fma(x0, s, x1 * c), so q_out and the
// cache carry the reference's bits; the float8 cast turns out-of-range
// values into NaN like the reference (common.cuh). No other element of the
// cache is touched.
//
// What bounds it on the H100: launches. A Llama-3-8B decode row moves
// ~24 KB (q, k, v in, q_out and the cache rows out, the table rows), a few
// nanoseconds at 3.35 TB/s, against a launch of ~1.3 us. A kernel of K and
// V alone leaves each layer some twenty small PyTorch kernels around it:
// q's rope (casts, products, a stack), the cos/sin gathers and the copies
// of the strided k and v slices of the fused qkv projection.
//
// Design: one launch does the layer's whole epilogue and reads its inputs
// where they lie: q, k and v through their own row strides (the fused
// [rows, dim + 2 kv_dim] projection or three separate ones), the f32 rope
// tables at each row's own angle row, the position from the device vector
// (nothing read back, so a CUDA graph can capture it). grid.y is the row;
// a thread takes one run of 4 rotation pairs of one q or K head (8
// adjacent elements interleaved, or 4 at j and 4 at j + hd/2 for the half
// style), or 8 adjacent elements of one V head, loaded and stored as 16-
// or 8-byte vectors where every operand is aligned. No shared memory, no
// host sync; q_out is the only allocation (the wrapper's).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPairs = 4;  // rotation pairs a thread: 8 elements of a head

struct Args {
  const void *q, *k, *v;
  long long q_rs, k_rs, v_rs;  // row strides, in elements
  const float *cos, *sin;      // [R, hd / 2]
  void *q_out, *kc, *vc;
  int B, row0, cache_rows;  // sequence b writes cache row row0 + b of cache_rows
  int T, H, kv, hd, S, R;
  const int* pos_dev;
  int pos, layer, half_style, angle_at_write;
};

// kBytes from src to dst as 16-, 8- or 4-byte vectors, both aligned to them
template <int kBytes>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src) {
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      static_cast<uint4*>(dst)[i] = static_cast<const uint4*>(src)[i];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      static_cast<uint2*>(dst)[i] = static_cast<const uint2*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
  }
}

// N elements at p as floats, through vector loads under kVec
template <bool kVec, int N, typename T>
__device__ __forceinline__ void load_run(const T* p, float (&out)[N]) {
  alignas(16) T tmp[N];
  if constexpr (kVec) {
    copy_bytes<static_cast<int>(N * sizeof(T))>(tmp, p);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) tmp[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = dllama::to_f32(tmp[i]);
}

// N floats stored at p as T, through vector stores under kVec
template <bool kVec, int N, typename T>
__device__ __forceinline__ void store_run(T* p, const float (&in)[N]) {
  alignas(16) T tmp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tmp[i] = dllama::from_f32<T>(in[i]);
  if constexpr (kVec) {
    copy_bytes<static_cast<int>(N * sizeof(T))>(p, tmp);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = tmp[i];
  }
}

// The thread's 4 pairs of run u of one head at x: (x0[i], x1[i]) are
// elements (8u + 2i, 8u + 2i + 1) interleaved, or (4u + i, 4u + i + hd/2)
// half style
template <bool kVec, typename T>
__device__ __forceinline__ void load_pairs(const T* x, int u, int half, bool half_style,
                                           float (&x0)[kPairs], float (&x1)[kPairs]) {
  if (half_style) {
    load_run<kVec>(x + kPairs * u, x0);
    load_run<kVec>(x + half + kPairs * u, x1);
  } else {
    float e[2 * kPairs];
    load_run<kVec>(x + 2 * kPairs * u, e);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      x0[i] = e[2 * i];
      x1[i] = e[2 * i + 1];
    }
  }
}

template <bool kVec, typename T>
__device__ __forceinline__ void store_pairs(T* x, int u, int half, bool half_style,
                                            const float (&r0)[kPairs],
                                            const float (&r1)[kPairs]) {
  if (half_style) {
    store_run<kVec>(x + kPairs * u, r0);
    store_run<kVec>(x + half + kPairs * u, r1);
  } else {
    float e[2 * kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      e[2 * i] = r0[i];
      e[2 * i + 1] = r1[i];
    }
    store_run<kVec>(x + 2 * kPairs * u, e);
  }
}

template <typename ActT, typename CacheT, bool kVec>
__global__ void __launch_bounds__(kThreads)
rope_cache_kernel(const Args a) {
  const int units = a.hd / (2 * kPairs);  // runs a head
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (a.H + 2 * a.kv) * units) return;
  const int head = i / units, u = i - head * units;
  const int r = blockIdx.y;  // b * T + t
  const int b = r / a.T, t = r - b * a.T;
  const int p = a.pos_dev != nullptr ? a.pos_dev[b] : a.pos;
  const int w = min(max(p, 0), a.S - a.T) + t;
  const size_t dst =
      ((((size_t)a.layer * a.cache_rows + a.row0 + b) * a.S + w) * a.kv) * a.hd;
  const int half = a.hd / 2;

  if (head >= a.H + a.kv) {  // V: convert and store
    const int h = head - a.H - a.kv;
    float e[2 * kPairs];
    load_run<kVec>(static_cast<const ActT*>(a.v) + r * a.v_rs + (size_t)h * a.hd +
                       2 * kPairs * u, e);
    store_run<kVec>(static_cast<CacheT*>(a.vc) + dst + (size_t)h * a.hd + 2 * kPairs * u, e);
    return;
  }

  const int arow = a.angle_at_write ? w : min(max(p + t, 0), a.R - 1);
  float c[kPairs], s[kPairs];
  load_run<kVec>(a.cos + (size_t)arow * half + kPairs * u, c);
  load_run<kVec>(a.sin + (size_t)arow * half + kPairs * u, s);
  const bool is_q = head < a.H;
  const ActT* x = is_q ? static_cast<const ActT*>(a.q) + r * a.q_rs + (size_t)head * a.hd
                       : static_cast<const ActT*>(a.k) + r * a.k_rs + (size_t)(head - a.H) * a.hd;
  float x0[kPairs], x1[kPairs], r0[kPairs], r1[kPairs];
  load_pairs<kVec>(x, u, half, a.half_style, x0, x1);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    r0[j] = __fmaf_rn(x0[j], c[j], -__fmul_rn(x1[j], s[j]));
    r1[j] = __fmaf_rn(x0[j], s[j], __fmul_rn(x1[j], c[j]));
  }
  if (is_q) {
    store_pairs<kVec>(static_cast<ActT*>(a.q_out) + ((size_t)r * a.H + head) * a.hd, u, half,
                      a.half_style, r0, r1);
    return;
  }
  // K: f32 -> activation dtype -> cache dtype
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    r0[j] = dllama::to_f32(dllama::from_f32<ActT>(r0[j]));
    r1[j] = dllama::to_f32(dllama::from_f32<ActT>(r1[j]));
  }
  store_pairs<kVec>(static_cast<CacheT*>(a.kc) + dst + (size_t)(head - a.H) * a.hd, u, half,
                    a.half_style, r0, r1);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename ActT, typename CacheT>
int launch(const Args& a, cudaStream_t st) {
  // every run starts at a multiple of 4 elements of a 16-aligned row and head
  const bool vec = a.hd % 16 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.q_out) && aligned16(a.kc) && aligned16(a.vc) &&
                   aligned16(a.cos) && aligned16(a.sin) &&
                   (a.q_rs * sizeof(ActT)) % 16 == 0 && (a.k_rs * sizeof(ActT)) % 16 == 0 &&
                   (a.v_rs * sizeof(ActT)) % 16 == 0;
  const int n = (a.H + 2 * a.kv) * (a.hd / (2 * kPairs));
  const dim3 grid((n + kThreads - 1) / kThreads, a.B * a.T);
  if (vec)
    rope_cache_kernel<ActT, CacheT, true><<<grid, kThreads, 0, st>>>(a);
  else
    rope_cache_kernel<ActT, CacheT, false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename ActT>
int launch_act(int cache_kind, const Args& a, cudaStream_t st) {
  switch (cache_kind) {
    case 0: return launch<ActT, float>(a, st);
    case 1: return launch<ActT, __nv_bfloat16>(a, st);
    case 2: return launch<ActT, dllama::F8>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: rows b * T + t of H, kv and kv heads of hd elements, kind 0 f32 /
// 1 bf16, each at its own row stride (elements; heads adjacent within a
// row); cos, sin: f32 [R, hd / 2]; q_out: [B * T, H, hd] contiguous, the
// activation kind; caches [L, cache_rows, S, kv, hd] of kind 0 f32 / 1 bf16 /
// 2 f8, sequence b at cache row row0 + b (rows [row0, row0 + B) of the whole
// contiguous cache), written in place at positions clamp(p, 0, S - T) + t, p = pos_dev[b] (device
// int32 [B]) or, with pos_dev null, pos; the angle row as in the header
// (angle_at_write 1: the write row). hd % 8 == 0, 1 <= T <= S, R >= 1.
extern "C" int dllama_rope_cache_update(const void* q, long long q_rs, const void* k,
                                        long long k_rs, const void* v, long long v_rs,
                                        const void* cos, const void* sin, void* q_out,
                                        void* k_cache, void* v_cache, int B, int row0,
                                        int cache_rows, int T, int H,
                                        int kv, int hd, int S, int R, const void* pos_dev,
                                        int pos, int layer, int half_style, int angle_at_write,
                                        int act_kind, int cache_kind, void* stream) {
  if (hd % (2 * kPairs) || T < 1 || T > S || R < 1 || B < 1 || B * T > 65535 || row0 < 0 ||
      row0 + B > cache_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_rs, k_rs, v_rs, static_cast<const float*>(cos),
               static_cast<const float*>(sin), q_out, k_cache, v_cache, B, row0, cache_rows, T,
               H, kv, hd, S, R,
               static_cast<const int*>(pos_dev), pos, layer, half_style, angle_at_write};
  switch (act_kind) {
    case 0: return launch_act<float>(cache_kind, a, st);
    case 1: return launch_act<__nv_bfloat16>(cache_kind, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
