// Q40 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/qmatmul.py::_q40_kernel (K1, the
// dequant-matmul) and ::_q40_corr_kernel (K2, the nosub correction), with the
// layer-stacked launchers reduced to a pointer offset (the caller passes the
// view w[layer]).
//
// Function: out[t, o] (f32) = sum_k bf16(x[t, k]) * bf16(dequant(W)[k, o]),
// accumulated in f32. W is the packed layout of ops/qmatmul.py: uint8
// [K/2, O], byte 32s+j holds row 64s+j (low nibble, scale s_lo[s, o]) and row
// 64s+32+j (high nibble, s_hi[s, o]). Dequant is (q - 8) * delta; under nosub
// it is q * delta and the exact correction
// 8 * sum_s (blocksum_lo_s(x) * s_lo[s, o] + blocksum_hi_s(x) * s_hi[s, o])
// is accumulated beside the product and subtracted at the end, from the
// scale values already in registers — K2 re-read the scale planes from
// device memory on the TPU.
//
// What bounds it on the H100: bytes. Decode (T = 1) reads 0.625 B per
// weight (0.5 B of nibbles + 0.125 B of f32 scales) and does ~4 operations
// per weight; at 3.35 TB/s the weights of a Llama-3-8B token (4.69 GB) take
// 1.40 ms. Prefill at large T is bound by the dequant and the f32 FMAs on
// the CUDA cores (no tensor cores yet).
//
// Design: one thread per 4 adjacent output columns, so a warp reads 128
// contiguous bytes of a packed row (uchar4 per thread) and the scales as
// float4. A block of 128 threads covers 512 columns; the bf16 x rows of the
// block's K range are staged in shared memory as f32 (8 superblocks per
// pass) and read as warp-wide broadcasts. K is split across blocks
// (grid.y) until about four blocks per SM are in flight — decode of wo has
// only 8 column blocks — and the splits' partial sums are added in a fixed
// order by a second small kernel, so results do not depend on scheduling.
// T is tiled in blocks of up to 8 rows (grid.z), each re-reading the
// weights: simple, not fast, for prefill.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kBlockCols = kThreads * kCols;   // 512 (ops/qmatmul.py _BLOCK_COLS)
constexpr int kChunkSb = 8;                    // 64-row superblocks staged per pass

template <int TT, bool kVec>
__global__ void __launch_bounds__(kThreads)
q40_matmul_kernel(const __nv_bfloat16* __restrict__ x, int T, int K,
                  const uint8_t* __restrict__ w, const float* __restrict__ s_lo,
                  const float* __restrict__ s_hi, int O, int sb_per_split,
                  int nosub, float* __restrict__ out) {
  __shared__ float xs[TT][kChunkSb * 64];
  __shared__ float bsum[TT][kChunkSb * 2];

  const int t0 = blockIdx.z * TT;
  const int nsb = K / 64;
  const int sb_begin = blockIdx.y * sb_per_split;
  const int sb_end = min(nsb, sb_begin + sb_per_split);
  const int o0 = blockIdx.x * kBlockCols + threadIdx.x * kCols;
  const float sub = nosub ? 0.f : 8.f;

  float acc[TT][kCols];
  float corr[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[t][c] = 0.f;
      corr[t][c] = 0.f;
    }
  }

  for (int c0 = sb_begin; c0 < sb_end; c0 += kChunkSb) {
    const int nc = min(kChunkSb, sb_end - c0);
    const int width = nc * 64;
    for (int i = threadIdx.x; i < TT * width; i += kThreads) {
      const int t = i / width;
      const int k = i - t * width;
      xs[t][k] = (t0 + t < T)
                     ? __bfloat162float(x[(size_t)(t0 + t) * K + (size_t)c0 * 64 + k])
                     : 0.f;
    }
    __syncthreads();
    if (nosub) {
      for (int i = threadIdx.x; i < TT * nc * 2; i += kThreads) {
        const int t = i / (nc * 2);
        const int b = i - t * (nc * 2);
        float s = 0.f;
        for (int j = 0; j < 32; ++j) s += xs[t][b * 32 + j];
        bsum[t][b] = s;
      }
      __syncthreads();
    }
    if (o0 < O) {
      for (int sb = 0; sb < nc; ++sb) {
        const int s = c0 + sb;
        const size_t srow = (size_t)s * O + o0;
        float slo[kCols], shi[kCols];
        if (kVec) {
          const float4 a = *reinterpret_cast<const float4*>(s_lo + srow);
          const float4 b = *reinterpret_cast<const float4*>(s_hi + srow);
          slo[0] = a.x; slo[1] = a.y; slo[2] = a.z; slo[3] = a.w;
          shi[0] = b.x; shi[1] = b.y; shi[2] = b.z; shi[3] = b.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            slo[c] = (o0 + c < O) ? s_lo[srow + c] : 0.f;
            shi[c] = (o0 + c < O) ? s_hi[srow + c] : 0.f;
          }
        }
        const uint8_t* wrow = w + (size_t)s * 32 * O + o0;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          uint32_t bytes[kCols];
          if (kVec) {
            const uchar4 v = *reinterpret_cast<const uchar4*>(wrow + (size_t)j * O);
            bytes[0] = v.x; bytes[1] = v.y; bytes[2] = v.z; bytes[3] = v.w;
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              bytes[c] = (o0 + c < O) ? wrow[(size_t)j * O + c] : 0u;
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float wl = dllama::round_bf16(((float)(bytes[c] & 15u) - sub) * slo[c]);
            const float wh = dllama::round_bf16(((float)(bytes[c] >> 4) - sub) * shi[c]);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              acc[t][c] = fmaf(xs[t][sb * 64 + j], wl, acc[t][c]);
              acc[t][c] = fmaf(xs[t][sb * 64 + 32 + j], wh, acc[t][c]);
            }
          }
        }
        if (nosub) {
#pragma unroll
          for (int t = 0; t < TT; ++t) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              corr[t][c] = fmaf(bsum[t][2 * sb], slo[c], corr[t][c]);
              corr[t][c] = fmaf(bsum[t][2 * sb + 1], shi[c], corr[t][c]);
            }
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
      if (o0 + c < O) dst[(size_t)(t0 + t) * O + o0 + c] = acc[t][c] - 8.f * corr[t][c];
  }
}

// out[i] = sum over splits of partials[split][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partials, int ksplit, size_t n,
                                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partials[(size_t)k * n + i];
  out[i] = s;
}

template <int TT, bool kVec>
void launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int T, int K, const uint8_t* w,
            const float* s_lo, const float* s_hi, int O, int sb_per_split, int nosub,
            float* dst) {
  q40_matmul_kernel<TT, kVec><<<grid, kThreads, 0, st>>>(x, T, K, w, s_lo, s_hi, O,
                                                         sb_per_split, nosub, dst);
}

template <int TT>
void launch_tt(bool vec, dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int T, int K,
               const uint8_t* w, const float* s_lo, const float* s_hi, int O,
               int sb_per_split, int nosub, float* dst) {
  if (vec)
    launch<TT, true>(grid, st, x, T, K, w, s_lo, s_hi, O, sb_per_split, nosub, dst);
  else
    launch<TT, false>(grid, st, x, T, K, w, s_lo, s_hi, O, sb_per_split, nosub, dst);
}

}  // namespace

// x: bf16 [T, K] (K = the packed K, zero-padded); w: uint8 [K/2, O];
// s_lo, s_hi: f32 [K/64, O]; out: f32 [T, O]; partials: f32 [ksplit, T, O]
// (unused when ksplit == 1). ksplit and sb_per_split come from
// ops/qmatmul.py split_plan.
extern "C" int dllama_q40_matmul(const void* x, int T, int K, const void* w, const void* s_lo,
                                 const void* s_hi, int O, int nosub, int ksplit,
                                 int sb_per_split, void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi)) %
                    16) == 0;
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit, (T + tt - 1) / tt);
  float* dst = static_cast<float*>(ksplit > 1 ? partials : out);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* lo = static_cast<const float*>(s_lo);
  const auto* hi = static_cast<const float*>(s_hi);
  switch (tt) {
    case 1: launch_tt<1>(vec, grid, st, xb, T, K, wb, lo, hi, O, sb_per_split, nosub, dst); break;
    case 2: launch_tt<2>(vec, grid, st, xb, T, K, wb, lo, hi, O, sb_per_split, nosub, dst); break;
    case 4: launch_tt<4>(vec, grid, st, xb, T, K, wb, lo, hi, O, sb_per_split, nosub, dst); break;
    default: launch_tt<8>(vec, grid, st, xb, T, K, wb, lo, hi, O, sb_per_split, nosub, dst); break;
  }
  if (ksplit > 1) {
    const size_t n = (size_t)T * O;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partials), ksplit, n,
                                              static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
