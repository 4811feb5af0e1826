// Q40 weights times Q80-quantized activations as an integer dot, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/qkernel_experiments.py::_q40_int8_kernel
// (K7, via variant_e): the reference's own production arithmetic,
// matmulQ40vQ80 — activations quantized per 32-block to int8, weights as
// 4-bit nibbles, an integer dot per block, scaled afterwards.
//
// Function: out[t, o] (f32) = sum over 32-row blocks b of
// f32(dot_b) * (sx[t, b] * s_b[o]), dot_b = sum_{k in b} xq[t, k] *
// nibble(k, o) in int32, with nibbles 0..15 (no -8: the caller subtracts
// 8 * sum_b sx[t, b] * sum_{k in b} xq[t, k] * s_b[o] outside, as the JAX
// experiment does). xq is int8 [T, K] with f32 scales sx [T, K/32]; the
// weights are ops/qmatmul.py's packed Q40 layout (uint8 [K/2, O], byte 32s+j
// holds rows 64s+j and 64s+32+j, scales s_lo/s_hi f32 [K/64, O]). A block's
// dot is at most 32 * 127 * 15 = 60,960 in magnitude, exact in int32 and in
// f32. The scale product is taken first, then times the dot, then added,
// each rounded on its own (__fmul_rn/__fadd_rn), in JAX's order.
//
// What bounds it on the H100: bytes, as K1 (0.625 B per weight at T = 1);
// the int8 activation is a quarter of a bf16 row.
//
// Design: K1's (q40_matmul.cu) with the dot in int32. One thread per 4
// adjacent output columns (uchar4 of nibble pairs per row, float4 scales),
// 128 threads per block covering 512 columns; xq rows of the block's K range
// staged in shared memory as int32 and read as warp broadcasts; a plain
// int32 multiply-add per nibble (right first; __dp4a after a byte transpose
// of 4 K-rows is the faster form). K split across blocks by split_plan with
// a fixed-order sum of the partials; T tiled by up to 8 rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kBlockCols = kThreads * kCols;
constexpr int kChunkSb = 8;  // 64-row superblocks staged per pass

template <int TT, bool kVec>
__global__ void __launch_bounds__(kThreads)
q40_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx, int T, int K,
                const uint8_t* __restrict__ w, const float* __restrict__ s_lo,
                const float* __restrict__ s_hi, int O, int sb_per_split,
                float* __restrict__ out) {
  __shared__ int xs[TT][kChunkSb * 64];
  __shared__ float sxs[TT][kChunkSb * 2];

  const int t0 = blockIdx.z * TT;
  const int nsb = K / 64;
  const int sb_begin = blockIdx.y * sb_per_split;
  const int sb_end = min(nsb, sb_begin + sb_per_split);
  const int o0 = blockIdx.x * kBlockCols + threadIdx.x * kCols;

  float acc[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;
  }

  for (int c0 = sb_begin; c0 < sb_end; c0 += kChunkSb) {
    const int nc = min(kChunkSb, sb_end - c0);
    const int width = nc * 64;
    for (int i = threadIdx.x; i < TT * width; i += kThreads) {
      const int t = i / width;
      const int k = i - t * width;
      xs[t][k] = (t0 + t < T) ? (int)xq[(size_t)(t0 + t) * K + (size_t)c0 * 64 + k] : 0;
    }
    for (int i = threadIdx.x; i < TT * nc * 2; i += kThreads) {
      const int t = i / (nc * 2);
      const int b = i - t * (nc * 2);
      sxs[t][b] = (t0 + t < T) ? sx[(size_t)(t0 + t) * (K / 32) + (size_t)c0 * 2 + b] : 0.f;
    }
    __syncthreads();
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
        int dlo[TT][kCols], dhi[TT][kCols];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dlo[t][c] = 0;
            dhi[t][c] = 0;
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
            const int lo = (int)(bytes[c] & 15u);
            const int hi = (int)(bytes[c] >> 4);
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              dlo[t][c] += xs[t][sb * 64 + j] * lo;
              dhi[t][c] += xs[t][sb * 64 + 32 + j] * hi;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[t][c] = __fadd_rn(acc[t][c], __fmul_rn((float)dlo[t][c],
                                                       __fmul_rn(sxs[t][2 * sb], slo[c])));
            acc[t][c] = __fadd_rn(acc[t][c], __fmul_rn((float)dhi[t][c],
                                                       __fmul_rn(sxs[t][2 * sb + 1], shi[c])));
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

template <int TT>
void launch_tt(bool vec, dim3 grid, cudaStream_t st, const int8_t* xq, const float* sx, int T,
               int K, const uint8_t* w, const float* s_lo, const float* s_hi, int O,
               int sb_per_split, float* dst) {
  if (vec)
    q40_int8_kernel<TT, true><<<grid, kThreads, 0, st>>>(xq, sx, T, K, w, s_lo, s_hi, O,
                                                         sb_per_split, dst);
  else
    q40_int8_kernel<TT, false><<<grid, kThreads, 0, st>>>(xq, sx, T, K, w, s_lo, s_hi, O,
                                                          sb_per_split, dst);
}

}  // namespace

// xq: int8 [T, K] (K = the packed K, zero-padded); sx: f32 [T, K/32]; w:
// uint8 [K/2, O]; s_lo, s_hi: f32 [K/64, O]; out: f32 [T, O]; partials: f32
// [ksplit, T, O] (unused when ksplit == 1). ksplit and sb_per_split come
// from ops/qmatmul.py split_plan.
extern "C" int dllama_q40_int8_matmul(const void* xq, const void* sx, int T, int K,
                                      const void* w, const void* s_lo, const void* s_hi, int O,
                                      int ksplit, int sb_per_split, void* partials, void* out,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi)) %
                    16) == 0;
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit, (T + tt - 1) / tt);
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* lo = static_cast<const float*>(s_lo);
  const auto* hi = static_cast<const float*>(s_hi);
  float* dst = static_cast<float*>(ksplit > 1 ? partials : out);
  switch (tt) {
    case 1: launch_tt<1>(vec, grid, st, x8, sxf, T, K, wb, lo, hi, O, sb_per_split, dst); break;
    case 2: launch_tt<2>(vec, grid, st, x8, sxf, T, K, wb, lo, hi, O, sb_per_split, dst); break;
    case 4: launch_tt<4>(vec, grid, st, x8, sxf, T, K, wb, lo, hi, O, sb_per_split, dst); break;
    default: launch_tt<8>(vec, grid, st, x8, sxf, T, K, wb, lo, hi, O, sb_per_split, dst); break;
  }
  if (ksplit > 1)
    dllama::sum_splits(static_cast<const float*>(partials), ksplit, (size_t)T * O,
                       static_cast<float*>(out), st);
  return static_cast<int>(cudaGetLastError());
}
