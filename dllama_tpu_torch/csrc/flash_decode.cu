// Flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/flash_decode.py::_kernel (K4), solo
// form: online-softmax GQA decode attention over the live cache prefix only,
// reading the stacked cache [L, S, kv, hd] in place at `layer`.
//
// Function: for query row r = t * group + g of kv head h (query head
// h * group + g), out = softmax_n(q . k_n * scale) . v_n over cache
// positions n <= pos + t, with scale = rsqrt(hd) (passed in by the
// wrapper), masked scores -1e30, everything in f32; bf16, f32 and
// float8_e4m3fn caches are upcast to f32.
//
// What bounds it on the H100: bytes — 2 * (pos + T) * kv * hd cache elements
// per layer and token (4.1 MB for a bf16 Llama-3-8B layer at pos 1000, about
// 1.2 us at 3.35 TB/s), with ~4 flops per cache element.
//
// Design: one block per kv head (the TPU grid's (row, head) program; solo
// decode has one row), 8 warps. The TPU walks 256-position blocks in
// order with a double-buffered DMA; here the 8 warps take interleaved
// 32-position tiles of the live prefix at once, so 8 tiles' loads are in
// flight, and each warp keeps its own online-softmax state (m, l, acc) for up
// to 8 query rows in registers: lane n scores position n of the tile (its
// K row read with 16-byte loads), the probabilities go to the lanes by
// shuffle, and each lane accumulates hd/32 output dims from coalesced V
// rows. The warps' states are merged in shared memory at the end. Positions
// past pos + T — including a ragged last tile when S is not a multiple of
// the tile — are masked in the kernel, never read. Only kv blocks run per
// layer (8 for Llama-3-8B), so the card is mostly idle: splitting the
// sequence across blocks is the first thing to make this fast.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;     // query rows per pass held in registers
constexpr int kMaxDpl = 8;   // output dims per lane: hd <= 256
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 16 bytes of cache elements -> floats
template <typename CacheT>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec16<dllama::F8> {
  static constexpr int n = 16;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dllama::F8 b;
      b.bits = (uint8_t)(w[i / 4] >> (8 * (i % 4)));
      f[i] = dllama::to_f32(b);
    }
  }
};

template <typename CacheT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const CacheT* __restrict__ kc,
                    const CacheT* __restrict__ vc, float* __restrict__ out, int T, int H,
                    int hd, int S, int kv, int pos, int layer, float scale) {
  extern __shared__ float smem[];
  const int group = H / kv;
  const int R = T * group;
  const int h = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qs = smem;                              // [kRows, hd]
  float* accs = qs + kRows * hd;                 // [kWarps, kRows, hd]
  float* ms = accs + kWarps * kRows * hd;        // [kWarps, kRows]
  float* ls = ms + kWarps * kRows;               // [kWarps, kRows]

  const int live = min(pos + T, S);
  const size_t row_stride = (size_t)kv * hd;
  const CacheT* kbase = kc + (size_t)layer * S * row_stride + (size_t)h * hd;
  const CacheT* vbase = vc + (size_t)layer * S * row_stride + (size_t)h * hd;
  constexpr int kVec = Vec16<CacheT>::n;

  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int rp = min(kRows, R - r0);
    for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float v = 0.f;
      if (r < rp) {
        const int row = r0 + r, t = row / group, g = row - t * group;
        v = q[((size_t)t * H + (size_t)h * group + g) * hd + d];
      }
      qs[i] = v;
    }
    __syncthreads();

    float m[kRows], l[kRows], acc[kRows][kMaxDpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -1e30f;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxDpl; ++j) acc[r][j] = 0.f;
    }

    for (int n0 = warp * 32; n0 < live; n0 += kWarps * 32) {
      const int key = n0 + lane;
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      if (key < live) {
        const CacheT* krow = kbase + (size_t)key * row_stride;
        for (int d0 = 0; d0 < hd; d0 += kVec) {
          float kf[kVec];
          Vec16<CacheT>::unpack(*reinterpret_cast<const uint4*>(krow + d0), kf);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rp) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) s[r] = fmaf(qs[r * hd + d0 + e], kf[e], s[r]);
            }
          }
        }
      }
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rp) break;
        const bool valid = key < live && key <= pos + (r0 + r) / group;
        const float sc = valid ? s[r] * scale : -1e30f;
        const float m_new = fmaxf(m[r], warp_max(sc));
        p[r] = valid ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < kMaxDpl; ++j) acc[r][j] *= alpha;
      }
      const int nk = min(32, live - n0);
      for (int n = 0; n < nk; ++n) {
        const CacheT* vrow = vbase + (size_t)(n0 + n) * row_stride;
        float vv[kMaxDpl];
#pragma unroll
        for (int j = 0; j < kMaxDpl; ++j) {
          const int d = lane + 32 * j;
          vv[j] = d < hd ? dllama::to_f32(vrow[d]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= rp) break;
          const float pn = __shfl_sync(kFull, p[r], n);
#pragma unroll
          for (int j = 0; j < kMaxDpl; ++j) acc[r][j] = fmaf(pn, vv[j], acc[r][j]);
        }
      }
    }

    // merge the warps' online-softmax states
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        ms[warp * kRows + r] = m[r];
        ls[warp * kRows + r] = l[r];
      }
#pragma unroll
      for (int j = 0; j < kMaxDpl; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) accs[((size_t)warp * kRows + r) * hd + d] = acc[r][j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rp * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float mx = -1e30f;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kRows + r]);
      float lsum = 0.f, a = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(ms[w * kRows + r] - mx);
        lsum = fmaf(ls[w * kRows + r], f, lsum);
        a = fmaf(accs[((size_t)w * kRows + r) * hd + d], f, a);
      }
      const int row = r0 + r, t = row / group, g = row - t * group;
      out[((size_t)t * H + (size_t)h * group + g) * hd + d] = a / lsum;
    }
    __syncthreads();
  }
}

template <typename CacheT>
int launch(const void* q, const void* kc, const void* vc, void* out, int T, int H, int hd,
           int S, int kv, int pos, int layer, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)kRows * hd + (size_t)kWarps * kRows * hd +
                                       2 * kWarps * kRows);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<CacheT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<CacheT><<<kv, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const CacheT*>(kc),
      static_cast<const CacheT*>(vc), static_cast<float*>(out), T, H, hd, S, kv, pos, layer,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: f32 [T, H, hd]; caches [L, S, kv, hd] of kind 0 f32 / 1 bf16 / 2 f8;
// out: f32 [T, H, hd]. hd % 16 == 0 and hd <= 256 (checked by the wrapper).
extern "C" int dllama_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                   void* out, int T, int H, int hd, int S, int kv, int pos,
                                   int layer, float scale, int cache_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cache_kind) {
    case 0: return launch<float>(q, k_cache, v_cache, out, T, H, hd, S, kv, pos, layer, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, out, T, H, hd, S, kv, pos, layer, scale,
                                   st);
    case 2:
      return launch<dllama::F8>(q, k_cache, v_cache, out, T, H, hd, S, kv, pos, layer, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
