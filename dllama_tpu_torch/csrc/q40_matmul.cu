// Q40 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/qmatmul.py::_q40_kernel (K1, the
// dequant-matmul, with its fused-rmsnorm epilogue) and ::_q40_corr_kernel
// (K2, the nosub correction), with the layer-stacked launchers reduced to a
// pointer offset (the caller passes the view w[layer]); and, as a launch
// mode, scripts/qkernel_experiments.py::_q40_nosub_kernel (K6: the nosub
// dot with no correction at all, which the experiment applies outside).
//
// Function: out[t, o] (f32) = sum_k bf16(x[t, k]) * bf16(dequant(W)[k, o]),
// accumulated in f32. W is the packed layout of ops/qmatmul.py: uint8
// [K/2, O], byte 32s+j holds row 64s+j (low nibble, scale s_lo[s, o]) and row
// 64s+32+j (high nibble, s_hi[s, o]). Dequant is (q - 8) * delta; under nosub
// it is q * delta and the exact correction
// 8 * sum_s (blocksum_lo_s(x) * s_lo[s, o] + blocksum_hi_s(x) * s_hi[s, o])
// is subtracted, from the scale values already on chip — K2 re-read the
// scale planes from device memory on the TPU. With the fused-norm epilogue
// (inv != nullptr) x arrives raw (bf16 or f32) and each staged element is
// bf16(nw * (x * inv)) (common.cuh act_bf16); the correction's block sums
// then sum that normalized tile, as the JAX package's _q40_normed does.
//
// Two kernels, dispatched by T in ops/qmatmul.py q40_plan.
//
// Decode (T <= 8, ops/qmatmul.py GEMV_MAX_T): q40_matmul_kernel below, on
// the CUDA cores. What bounds it on the H100: bytes — decode (T = 1) reads
// 0.625 B per weight (0.5 B of nibbles + 0.125 B of f32 scales) and does ~4
// operations per weight; at 3.35 TB/s the weights of a Llama-3-8B token
// (4.69 GB) take 1.40 ms. One thread per 4 adjacent output columns, so a
// warp reads 128 contiguous bytes of a packed row (uchar4 per thread) and
// the scales as float4. A block of 128 threads covers 512 columns (256
// threads and 1024 columns in K6's wide mode, the experiment's stand-in for
// a 2048-lane TPU tile); the bf16 x rows of the block's K range are staged
// in shared memory as f32 (8 superblocks per pass) and read as warp-wide
// broadcasts. K is split across blocks (grid.y) until about four blocks per
// SM are in flight — decode of wo has only 8 column blocks — and the
// splits' partial sums are added in a fixed order by a second small kernel,
// so results do not depend on scheduling.
//
// Prefill (T > 8): the tensor-core tile of dq_tile.cuh with the Q40 front
// end (nibble dequant; the nosub correction added per superblock from the
// staged block sums and scales), dllama_q40_tile below.
#include "common.cuh"
#include "dq_tile.cuh"

namespace {

constexpr int kCols = 4;     // output columns per thread
constexpr int kChunkSb = 8;  // 64-row superblocks staged per pass

using dllama::tile::kNosubCorrect;
using dllama::tile::kNosubRaw;
using dllama::tile::kSub;

template <typename XT, int TT, bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads)
q40_matmul_kernel(const XT* __restrict__ x, int T, int K, const uint8_t* __restrict__ w,
                  const float* __restrict__ s_lo, const float* __restrict__ s_hi, int O,
                  int sb_per_split, int mode, const float* __restrict__ inv,
                  const float* __restrict__ nw, float* __restrict__ out) {
  constexpr int kBlockCols = kThreads * kCols;
  __shared__ float xs[TT][kChunkSb * 64];
  __shared__ float bsum[TT][kChunkSb * 2];

  const int nsb = K / 64;
  const int sb_begin = blockIdx.y * sb_per_split;
  const int sb_end = min(nsb, sb_begin + sb_per_split);
  const int o0 = blockIdx.x * kBlockCols + threadIdx.x * kCols;
  const float sub = mode == kSub ? 8.f : 0.f;
  const bool correct = mode == kNosubCorrect;

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
      xs[t][k] = t < T ? dllama::act_bf16(x, K, t, (size_t)c0 * 64 + k, inv, nw) : 0.f;
    }
    __syncthreads();
    if (correct) {
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
        if (correct) {
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
    if (t >= T) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (o0 + c < O) dst[(size_t)t * O + o0 + c] = acc[t][c] - 8.f * corr[t][c];
  }
}

struct Args {
  int T, K, O, sb_per_split, mode;
  const uint8_t* w;
  const float *s_lo, *s_hi, *inv, *nw;
  float* dst;
};

template <typename XT, int TT, bool kVec, int kThreads>
void launch(dim3 grid, cudaStream_t st, const XT* x, const Args& a) {
  q40_matmul_kernel<XT, TT, kVec, kThreads><<<grid, kThreads, 0, st>>>(
      x, a.T, a.K, a.w, a.s_lo, a.s_hi, a.O, a.sb_per_split, a.mode, a.inv, a.nw, a.dst);
}

template <typename XT, int kThreads>
void launch_tt(int tt, bool vec, dim3 grid, cudaStream_t st, const XT* x, const Args& a) {
  switch (tt) {
    case 1: vec ? launch<XT, 1, true, kThreads>(grid, st, x, a)
                : launch<XT, 1, false, kThreads>(grid, st, x, a); break;
    case 2: vec ? launch<XT, 2, true, kThreads>(grid, st, x, a)
                : launch<XT, 2, false, kThreads>(grid, st, x, a); break;
    case 4: vec ? launch<XT, 4, true, kThreads>(grid, st, x, a)
                : launch<XT, 4, false, kThreads>(grid, st, x, a); break;
    default: vec ? launch<XT, 8, true, kThreads>(grid, st, x, a)
                 : launch<XT, 8, false, kThreads>(grid, st, x, a); break;
  }
}

// Validated by the Python wrappers (1 <= T <= 8); ksplit and sb_per_split
// come from ops/qmatmul.py split_plan with the block's column count.
int run(const void* x, int x_f32, int T, int K, const void* w, const void* s_lo,
        const void* s_hi, int O, int mode, const void* inv, const void* nw, int wide,
        int ksplit, int sb_per_split, void* partials, void* out, void* stream) {
  if (T < 1 || T > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = wide ? 256 : 128;
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi)) %
                    16) == 0;
  const dim3 grid((O + threads * kCols - 1) / (threads * kCols), ksplit);
  const Args a{T, K, O, sb_per_split, mode, static_cast<const uint8_t*>(w),
               static_cast<const float*>(s_lo), static_cast<const float*>(s_hi),
               static_cast<const float*>(inv), static_cast<const float*>(nw),
               static_cast<float*>(ksplit > 1 ? partials : out)};
  if (x_f32)
    launch_tt<float, 128>(tt, vec, grid, st, static_cast<const float*>(x), a);
  else if (wide)
    launch_tt<__nv_bfloat16, 256>(tt, vec, grid, st, static_cast<const __nv_bfloat16*>(x), a);
  else
    launch_tt<__nv_bfloat16, 128>(tt, vec, grid, st, static_cast<const __nv_bfloat16*>(x), a);
  if (ksplit > 1)
    dllama::sum_splits(static_cast<const float*>(partials), ksplit, (size_t)T * O,
                       static_cast<float*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 (+K2), the decode kernel, 1 <= T <= 8. x: [T, K] (K = the packed K,
// zero-padded), bf16 (x_f32 = 0) or f32 (x_f32 = 1, only with the epilogue);
// w: uint8 [K/2, O]; s_lo, s_hi: f32 [K/64, O]; inv: f32 [T] and norm_w: f32
// [K] for the fused-norm epilogue, both null without it; out: f32 [T, O];
// partials: f32 [ksplit, T, O] (unused when ksplit == 1).
extern "C" int dllama_q40_matmul(const void* x, int x_f32, int T, int K, const void* w,
                                 const void* s_lo, const void* s_hi, int O, int nosub,
                                 const void* inv, const void* norm_w, int ksplit,
                                 int sb_per_split, void* partials, void* out, void* stream) {
  return run(x, x_f32, T, K, w, s_lo, s_hi, O, nosub ? kNosubCorrect : kSub, inv, norm_w, 0,
             ksplit, sb_per_split, partials, out, stream);
}

// K6: the nosub dot with no correction, 1 <= T <= 8; x bf16 [T, K]. wide =
// 1: 1024 columns per block.
extern "C" int dllama_q40_nosub_matmul(const void* x, int T, int K, const void* w,
                                       const void* s_lo, const void* s_hi, int O, int wide,
                                       int ksplit, int sb_per_split, void* partials, void* out,
                                       void* stream) {
  return run(x, 0, T, K, w, s_lo, s_hi, O, kNosubRaw, nullptr, nullptr, wide, ksplit,
             sb_per_split, partials, out, stream);
}

// K1 (+K2) and K6, the prefill tile (dq_tile.cuh), any T >= 1. Operands as
// for dllama_q40_matmul, except mode: 0 sub, 1 nosub with the correction,
// 2 nosub without it (K6); x 16-byte aligned; ksplit and sb_per_split from
// ops/qmatmul.py tile_plan.
extern "C" int dllama_q40_tile(const void* x, int x_f32, int T, int K, const void* w,
                               const void* s_lo, const void* s_hi, int O, int mode,
                               const void* inv, const void* norm_w, int ksplit, int sb_per_split,
                               void* partials, void* out, void* stream) {
  if (mode < kSub || mode > kNosubRaw) return static_cast<int>(cudaErrorInvalidValue);
  const dllama::tile::Params p{x, T, K, O, static_cast<const uint8_t*>(w),
                               static_cast<const float*>(s_lo), static_cast<const float*>(s_hi),
                               mode, static_cast<const float*>(inv),
                               static_cast<const float*>(norm_w), sb_per_split, nullptr};
  return dllama::tile::run<dllama::tile::Q40Front>(p, x_f32, ksplit,
                                                   static_cast<float*>(partials),
                                                   static_cast<float*>(out),
                                                   static_cast<cudaStream_t>(stream));
}
