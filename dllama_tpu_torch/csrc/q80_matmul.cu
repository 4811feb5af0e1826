// Q80 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/qmatmul.py::_q80_kernel (K3, via
// q80_matmul and q80_matmul_stacked, with its fused-rmsnorm epilogue); the
// layer-stacked launcher is a pointer offset (the caller passes w[layer]).
//
// Function: out[t, o] (f32) = sum_k bf16(x[t, k]) * bf16(f32(w[k, o]) *
// delta[k / 32, o]), accumulated in f32. w is int8 [K, O] (O contiguous),
// delta f32 [K/32, O]: the reference's Q80 blocks of 32 input rows, K
// zero-padded to a multiple of 256 by ops/qmatmul.py pack_q80. With the
// fused-norm epilogue (inv != nullptr) x arrives raw (bf16 or f32) and each
// staged element is bf16(nw * (x * inv)) (common.cuh act_bf16).
//
// What bounds it on the H100: bytes. Decode (T = 1) reads 1.125 B per
// weight (1 B of int8 + 0.125 B of f32 scales); at 3.35 TB/s the weights of
// a Llama-3-8B token (8.44 GB) take 2.52 ms. Prefill at large T is bound by
// the dequant and the f32 FMAs on the CUDA cores (no tensor cores yet).
//
// Design: K1's (q40_matmul.cu). One thread per 4 adjacent output columns,
// so a warp reads 128 contiguous bytes of a weight row (char4 per thread)
// and each 32-row block's scales as float4; 128 threads cover 512 columns.
// The activation rows of the block's K range are staged in shared memory as
// f32 values of bf16, 512 rows per pass, and read as warp-wide broadcasts.
// K is split across blocks (grid.y, in 64-row units, by the same split_plan
// as K1) and the partials are summed in a fixed order; T is tiled in blocks
// of up to 8 rows (grid.z).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // output columns per thread
constexpr int kBlockCols = kThreads * kCols;  // 512 (ops/qmatmul.py _BLOCK_COLS)
constexpr int kChunk = 8;                     // 64-row units staged per pass

template <typename XT, int TT, bool kVec>
__global__ void __launch_bounds__(kThreads)
q80_matmul_kernel(const XT* __restrict__ x, int T, int K, const int8_t* __restrict__ w,
                  const float* __restrict__ s, int O, int units_per_split,
                  const float* __restrict__ inv, const float* __restrict__ nw,
                  float* __restrict__ out) {
  __shared__ float xs[TT][kChunk * 64];

  const int t0 = blockIdx.z * TT;
  const int nunits = K / 64;
  const int u_begin = blockIdx.y * units_per_split;
  const int u_end = min(nunits, u_begin + units_per_split);
  const int o0 = blockIdx.x * kBlockCols + threadIdx.x * kCols;

  float acc[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;
  }

  for (int c0 = u_begin; c0 < u_end; c0 += kChunk) {
    const int width = min(kChunk, u_end - c0) * 64;
    for (int i = threadIdx.x; i < TT * width; i += kThreads) {
      const int t = i / width;
      const int k = i - t * width;
      xs[t][k] = (t0 + t < T) ? dllama::act_bf16(x, K, t0 + t, (size_t)c0 * 64 + k, inv, nw)
                              : 0.f;
    }
    __syncthreads();
    if (o0 < O) {
      for (int b = 0; b < width / 32; ++b) {  // 32-row blocks of this pass
        const size_t blk = (size_t)c0 * 2 + b;
        const size_t srow = blk * O + o0;
        float sc[kCols];
        if (kVec) {
          const float4 a = *reinterpret_cast<const float4*>(s + srow);
          sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) sc[c] = (o0 + c < O) ? s[srow + c] : 0.f;
        }
        const int8_t* wrow = w + blk * 32 * O + o0;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          int q[kCols];
          if (kVec) {
            const char4 v = *reinterpret_cast<const char4*>(wrow + (size_t)j * O);
            q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) q[c] = (o0 + c < O) ? wrow[(size_t)j * O + c] : 0;
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float wd = __bfloat162float(__float2bfloat16_rn((float)q[c] * sc[c]));
#pragma unroll
            for (int t = 0; t < TT; ++t) acc[t][c] = fmaf(xs[t][b * 32 + j], wd, acc[t][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (o0 >= O) return;
  float* dst = out + (size_t)blockIdx.y * T * O;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t0 + t >= T) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (o0 + c < O) dst[(size_t)(t0 + t) * O + o0 + c] = acc[t][c];
  }
}

struct Args {
  int T, K, O, units_per_split;
  const int8_t* w;
  const float *s, *inv, *nw;
  float* dst;
};

template <typename XT, int TT, bool kVec>
void launch(dim3 grid, cudaStream_t st, const XT* x, const Args& a) {
  q80_matmul_kernel<XT, TT, kVec><<<grid, kThreads, 0, st>>>(
      x, a.T, a.K, a.w, a.s, a.O, a.units_per_split, a.inv, a.nw, a.dst);
}

template <typename XT>
void launch_tt(int tt, bool vec, dim3 grid, cudaStream_t st, const XT* x, const Args& a) {
  switch (tt) {
    case 1: vec ? launch<XT, 1, true>(grid, st, x, a) : launch<XT, 1, false>(grid, st, x, a); break;
    case 2: vec ? launch<XT, 2, true>(grid, st, x, a) : launch<XT, 2, false>(grid, st, x, a); break;
    case 4: vec ? launch<XT, 4, true>(grid, st, x, a) : launch<XT, 4, false>(grid, st, x, a); break;
    default: vec ? launch<XT, 8, true>(grid, st, x, a) : launch<XT, 8, false>(grid, st, x, a); break;
  }
}

}  // namespace

// x: [T, K] (K = the packed K, a multiple of 64, zero-padded), bf16 (x_f32 =
// 0) or f32 (x_f32 = 1, only with the epilogue); w: int8 [K, O]; scales: f32
// [K/32, O]; inv: f32 [T] and norm_w: f32 [K] for the fused-norm epilogue,
// both null without it; out: f32 [T, O]; partials: f32 [ksplit, T, O]
// (unused when ksplit == 1). ksplit and units_per_split (64-row units) come
// from ops/qmatmul.py split_plan.
extern "C" int dllama_q80_matmul(const void* x, int x_f32, int T, int K, const void* w,
                                 const void* scales, int O, const void* inv, const void* norm_w,
                                 int ksplit, int units_per_split, void* partials, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0 &&
                   (reinterpret_cast<uintptr_t>(scales) % 16) == 0;
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit, (T + tt - 1) / tt);
  const Args a{T, K, O, units_per_split, static_cast<const int8_t*>(w),
               static_cast<const float*>(scales), static_cast<const float*>(inv),
               static_cast<const float*>(norm_w),
               static_cast<float*>(ksplit > 1 ? partials : out)};
  if (x_f32)
    launch_tt<float>(tt, vec, grid, st, static_cast<const float*>(x), a);
  else
    launch_tt<__nv_bfloat16>(tt, vec, grid, st, static_cast<const __nv_bfloat16*>(x), a);
  if (ksplit > 1)
    dllama::sum_splits(static_cast<const float*>(partials), ksplit, (size_t)T * O,
                       static_cast<float*>(out), st);
  return static_cast<int>(cudaGetLastError());
}
