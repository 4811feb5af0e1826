// Q80 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/qmatmul.py::_q80_kernel (K3, via
// q80_matmul and q80_matmul_stacked, with its fused-rmsnorm epilogue); the
// stacked launcher is a pointer offset where the index is a host number
// (the caller passes w[layer]) and the expert-indexed form below where it
// lies in device memory.
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
// a Llama-3-8B token (8.44 GB) take 2.52 ms.
//
// Two kernels, dispatched by T in ops/qmatmul.py q80_plan.
//
// Decode (T <= 8, ops/qmatmul.py GEMV_MAX_T): a GEMV. One thread owns 16
// adjacent columns and loads a weight row's 16 bytes of them in one
// instruction; a warp spans a 512-column tile's row, and the 8 warps of a
// block take interleaved groups of 4 rows. Loads are double-buffered in
// registers: a group's 4 rows and its 32-row block's 16 scales (four
// float4) are loaded while the group before is used, and the first group's
// while the activation rows of the block's K range are staged, once, in
// shared memory as f32 values of bf16 — 16-32 KB of weights per block in
// flight, two blocks per SM at T = 1. Per weight: the int8 goes to f32 with
// a byte permute into 2^23 + (q + 128) and one subtraction (exact, and no
// conversion instruction), q * delta rounds to f32, pairs round to bf16 with one
// __floats2bfloat162_rn, a shift or mask widens each back to f32, and one
// FMA per activation row adds it in. K is split across blocks (grid.y,
// ops/qmatmul.py gemv_plan) where a width has few column tiles, as far as
// one wave of resident blocks holds (a second wave would double the time of
// a byte-bound launch); the warps' sums are added in warp order, and the last block of a column tile to
// arrive (arrival counter + __threadfence) adds the splits' partials in
// split order and resets its counter to 0 — one launch, and a result that
// does not depend on the order the blocks ran in.
//
// Prefill (T > 8): the tensor-core tile of dq_tile.cuh with the Q80 front
// end (int8 * delta to bf16), dllama_q80_tile below.
//
// Expert-indexed decode (dllama_q80_gemv_indexed): the GEMV over n_sel
// planes of a stack [N, K, O] whose indices ids[j] lie in device memory —
// the port of q80_matmul_stacked's traced plane index. A third grid axis
// runs over j; each block reads ids[j] once and offsets its pointers, and
// the arithmetic, split plan and split-K sum are the GEMV's own, so output
// j is bit for bit the launch on the view w[base + ids[j]]. An id outside
// [0, n_ids) reads nothing and gives NaN in output j.
#include "common.cuh"
#include "dq_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// The decode GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvCols = 16;                      // adjacent columns per thread
constexpr int kGemvTileCols = 32 * kGemvCols;      // 512 (ops/qmatmul.py _GEMV_COLS)
constexpr int kGemvRows = 4;                       // rows per group: loads a thread issues at once

// the 16 int8 weights of row `row` at columns o0..o0+15 (zeros past O)
template <bool kVec>
__device__ __forceinline__ uint4 load_row16(const int8_t* __restrict__ w, size_t row, int O,
                                            int o0) {
  const int8_t* p = w + row * O + o0;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
    if (o0 + c < O) v[c / 4] |= (uint32_t)(uint8_t)p[c] << (8 * (c % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// rows `row`..`row + kU - 1` of the thread's 16 columns, and their 32-row
// block's 16 scales (a group never straddles a block)
template <int kU, bool kVec>
__device__ __forceinline__ void gemv_load(const int8_t* __restrict__ w,
                                          const float* __restrict__ s, int O, int o0,
                                          size_t row, uint4 (&q)[kU], float (&sc)[kGemvCols]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) q[u] = load_row16<kVec>(w, row + u, O, o0);
  const float* srow = s + (row / 32) * O + o0;
  if (kVec) {
#pragma unroll
    for (int c = 0; c < kGemvCols; c += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(srow + c));
      sc[c] = a.x; sc[c + 1] = a.y; sc[c + 2] = a.z; sc[c + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) sc[c] = o0 + c < O ? srow[c] : 0.f;
  }
}

// acc[t][c] += x[t][r + u] * bf16(q[u][c] * sc[c]) over the group's rows
template <int TT, int kU>
__device__ __forceinline__ void gemv_fma(const float* xs, int xstride, int r,
                                         const uint4 (&q)[kU], const float (&sc)[kGemvCols],
                                         float (&acc)[TT][kGemvCols]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    float xv[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) xv[t] = xs[t * xstride + r + u];
    // byte b of word i is column 4i + b; b ^ 0x80 = q + 128
    const uint32_t wd[4] = {q[u].x ^ 0x80808080u, q[u].y ^ 0x80808080u,
                            q[u].z ^ 0x80808080u, q[u].w ^ 0x80808080u};
#pragma unroll
    for (int c = 0; c < kGemvCols; c += 2) {
      // 2^23 + (q + 128), exactly, then q
      const float q0 = __uint_as_float(__byte_perm(wd[c / 4], 0x4B000000u,
                                                   0x7540u | (c % 4))) - 8388736.f;
      const float q1 = __uint_as_float(__byte_perm(wd[c / 4], 0x4B000000u,
                                                   0x7540u | (c % 4 + 1))) - 8388736.f;
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(q0 * sc[c], q1 * sc[c + 1]);
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(&b2);
      const float w0 = __uint_as_float(bits << 16);
      const float w1 = __uint_as_float(bits & 0xffff0000u);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        acc[t][c] = fmaf(xv[t], w0, acc[t][c]);
        acc[t][c + 1] = fmaf(xv[t], w1, acc[t][c + 1]);
      }
    }
  }
}

// kIndexed: the expert-indexed form, plane base + ids[blockIdx.z] of the
// stack (see the file's head); otherwise ids and the strides are unused.
template <typename XT, int TT, bool kVec, bool kIndexed>
__global__ void __launch_bounds__(kGemvThreads, TT == 1 ? 2 : 1)
q80_gemv_kernel(const XT* __restrict__ x, int T, int K, const int8_t* __restrict__ w,
                const float* __restrict__ s, int O, int rows_per_split,
                const float* __restrict__ inv, const float* __restrict__ nw,
                float* __restrict__ partials, int* __restrict__ counters,
                float* __restrict__ out, const int* __restrict__ ids, int base, int n_ids,
                size_t w_stride, size_t s_stride, size_t x_stride) {
  extern __shared__ __align__(16) float gsm[];
  const int tile = blockIdx.x, split = blockIdx.y, ksplit = gridDim.y;
  if (kIndexed) {
    const int j = blockIdx.z, e = ids[j];
    out += (size_t)j * T * O;
    if (e < 0 || e >= n_ids) {  // no such expert: read nothing, output j is NaN
      for (int i = threadIdx.x; i < T * kGemvTileCols; i += kGemvThreads) {
        const int o = tile * kGemvTileCols + i % kGemvTileCols;
        if (o < O) out[(size_t)(i / kGemvTileCols) * O + o] = __int_as_float(0x7fc00000);
      }
      return;
    }
    const size_t plane = (size_t)base + e;
    w += plane * w_stride;
    s += plane * s_stride;
    x += j * x_stride;
    partials += (size_t)j * ksplit * T * O;
    counters += j * gridDim.x;
  }
  const int k0 = split * rows_per_split;
  const int nrows = min(rows_per_split, K - k0);
  float* xs = gsm;                            // [TT, rows_per_split]
  float* red = gsm + TT * rows_per_split;     // [kGemvWarps, kGemvTileCols]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = tile * kGemvTileCols + lane * kGemvCols;
  const int ngroups = o0 < O ? nrows / kGemvRows : 0;

  // warp w takes row groups w, w + 8, ...: the first group's loads fly while
  // x is staged, and each later group's while the one before is used
  uint4 qa[kGemvRows], qb[kGemvRows];
  float sa[kGemvCols], sb[kGemvCols];
  int g = warp;
  if (g < ngroups) gemv_load<kGemvRows, kVec>(w, s, O, o0, (size_t)k0 + g * kGemvRows, qa, sa);

  for (int i = threadIdx.x; i < TT * nrows; i += kGemvThreads) {
    const int t = i / nrows, k = i - t * nrows;
    xs[t * rows_per_split + k] =
        t < T ? dllama::act_bf16(x, K, t, (size_t)k0 + k, inv, nw) : 0.f;
  }
  __syncthreads();

  float acc[TT][kGemvCols];
#pragma unroll
  for (int t = 0; t < TT; ++t) {
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[t][c] = 0.f;
  }
  while (g < ngroups) {
    const int g2 = g + kGemvWarps;
    if (g2 < ngroups)
      gemv_load<kGemvRows, kVec>(w, s, O, o0, (size_t)k0 + g2 * kGemvRows, qb, sb);
    gemv_fma<TT, kGemvRows>(xs, rows_per_split, g * kGemvRows, qa, sa, acc);
    if (g2 >= ngroups) break;
    g = g2 + kGemvWarps;
    if (g < ngroups)
      gemv_load<kGemvRows, kVec>(w, s, O, o0, (size_t)k0 + g * kGemvRows, qa, sa);
    gemv_fma<TT, kGemvRows>(xs, rows_per_split, g2 * kGemvRows, qb, sb, acc);
  }

  // the warps' sums in warp order -> this block's partial (or the answer)
  float* dst = ksplit > 1 ? partials + (size_t)split * T * O : out;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t >= T) break;
    float4* mine = reinterpret_cast<float4*>(red + warp * kGemvTileCols + lane * kGemvCols);
#pragma unroll
    for (int c = 0; c < kGemvCols; c += 4)
      mine[c / 4] = make_float4(acc[t][c], acc[t][c + 1], acc[t][c + 2], acc[t][c + 3]);
    __syncthreads();
    for (int c = threadIdx.x; c < kGemvTileCols; c += kGemvThreads) {
      const int o = tile * kGemvTileCols + c;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGemvWarps; ++wi) v += red[wi * kGemvTileCols + c];
      if (o < O) dst[(size_t)t * O + o] = v;
    }
    __syncthreads();
  }
  if (ksplit == 1) return;

  // the last block of this column tile to arrive adds the splits in order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile, 1) == ksplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < T * kGemvTileCols; i += kGemvThreads) {
    const int t = i / kGemvTileCols, o = tile * kGemvTileCols + (i - t * kGemvTileCols);
    if (o >= O) continue;
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < ksplit; ++k) v += __ldcg(partials + ((size_t)k * T + t) * O + o);
    out[(size_t)t * O + o] = v;
  }
  if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next launch
}

struct GemvArgs {
  int T, K, O, rows_per_split;
  const int8_t* w;
  const float *s, *inv, *nw;
  float* partials;
  int* counters;
  float* out;
  // the expert-indexed form's: planes base + ids[j] of n_ids
  const int* ids = nullptr;
  int base = 0, n_ids = 0;
  size_t w_stride = 0, s_stride = 0, x_stride = 0;
};

template <typename XT, int TT, bool kVec, bool kIndexed>
int launch_gemv(dim3 grid, size_t smem, cudaStream_t st, const XT* x, const GemvArgs& a) {
  auto kernel = q80_gemv_kernel<XT, TT, kVec, kIndexed>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kGemvThreads, smem, st>>>(x, a.T, a.K, a.w, a.s, a.O, a.rows_per_split, a.inv,
                                           a.nw, a.partials, a.counters, a.out, a.ids, a.base,
                                           a.n_ids, a.w_stride, a.s_stride, a.x_stride);
  return 0;
}

template <typename XT, int TT, bool kIndexed>
int launch_gemv_vec(bool vec, dim3 grid, size_t smem, cudaStream_t st, const XT* x,
                    const GemvArgs& a) {
  return vec ? launch_gemv<XT, TT, true, kIndexed>(grid, smem, st, x, a)
             : launch_gemv<XT, TT, false, kIndexed>(grid, smem, st, x, a);
}

template <typename XT, bool kIndexed = false>
int launch_gemv_tt(int tt, bool vec, dim3 grid, size_t smem, cudaStream_t st, const XT* x,
                   const GemvArgs& a) {
  switch (tt) {
    case 1: return launch_gemv_vec<XT, 1, kIndexed>(vec, grid, smem, st, x, a);
    case 2: return launch_gemv_vec<XT, 2, kIndexed>(vec, grid, smem, st, x, a);
    case 4: return launch_gemv_vec<XT, 4, kIndexed>(vec, grid, smem, st, x, a);
    default: return launch_gemv_vec<XT, 8, kIndexed>(vec, grid, smem, st, x, a);
  }
}

// resident blocks per SM of the GEMV for T rows at its largest shared memory
template <typename XT, int TT>
int gemv_occupancy() {
  const size_t smem = sizeof(float) * (16384 + kGemvWarps * kGemvTileCols);
  auto kernel = q80_gemv_kernel<XT, TT, true, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kGemvThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// How many GEMV blocks for T rows (1 <= T <= 8) one SM holds at once (for
// ops/qmatmul.py gemv_plan); a negative value is minus a CUDA error code.
extern "C" int dllama_q80_gemv_blocks_per_sm(int T, int x_f32) {
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  switch (tt) {
    case 1: return x_f32 ? gemv_occupancy<float, 1>() : gemv_occupancy<__nv_bfloat16, 1>();
    case 2: return x_f32 ? gemv_occupancy<float, 2>() : gemv_occupancy<__nv_bfloat16, 2>();
    case 4: return x_f32 ? gemv_occupancy<float, 4>() : gemv_occupancy<__nv_bfloat16, 4>();
    default: return x_f32 ? gemv_occupancy<float, 8>() : gemv_occupancy<__nv_bfloat16, 8>();
  }
}

// The decode GEMV, 1 <= T <= 8. Operands as for dllama_q80_tile below,
// except: rows_per_split (a multiple of 64) and ksplit come from
// ops/qmatmul.py gemv_plan, rows_per_split * (T rounded up to a power of two)
// <= 16384; partials: f32 [ksplit, T, O] (unused when ksplit == 1);
// counters: int32 [>= ceil(O / 512)], zero, and left zero — launches that
// share them must not overlap.
extern "C" int dllama_q80_gemv(const void* x, int x_f32, int T, int K, const void* w,
                               const void* scales, int O, const void* inv, const void* norm_w,
                               int ksplit, int rows_per_split, void* partials, void* counters,
                               void* out, void* stream) {
  if (T < 1 || T > 8 || rows_per_split % 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kGemvCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(scales) % 16) == 0;
  const dim3 grid((O + kGemvTileCols - 1) / kGemvTileCols, ksplit);
  const size_t smem = sizeof(float) * ((size_t)tt * rows_per_split + kGemvWarps * kGemvTileCols);
  const GemvArgs a{T, K, O, rows_per_split, static_cast<const int8_t*>(w),
                   static_cast<const float*>(scales), static_cast<const float*>(inv),
                   static_cast<const float*>(norm_w), static_cast<float*>(partials),
                   static_cast<int*>(counters), static_cast<float*>(out)};
  const int rc = x_f32 ? launch_gemv_tt<float>(tt, vec, grid, smem, st,
                                               static_cast<const float*>(x), a)
                       : launch_gemv_tt<__nv_bfloat16>(tt, vec, grid, smem, st,
                                                       static_cast<const __nv_bfloat16*>(x), a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K3, the expert-indexed decode GEMV, 1 <= T <= 8: out[j] = x_j @
// dequant(plane base + ids[j]) for j < n_sel. x: bf16 [n_sel, T, K] at
// x_stride elements per j (0: one x for every j); w: int8 [N, K, O],
// scales: f32 [N, K/32, O], at w_stride bytes and s_stride floats per
// plane; ids: int32 [n_sel] in device memory, each in [0, n_ids) (else
// output j is NaN), base + n_ids <= N; ksplit and rows_per_split from
// ops/qmatmul.py q80_plan for one plane; partials: f32 [n_sel, ksplit, T,
// O] (unused when ksplit == 1); counters: int32 [>= n_sel * ceil(O /
// 512)], zero, left zero; out: f32 [n_sel, T, O].
extern "C" int dllama_q80_gemv_indexed(const void* x, long long x_stride, int T, int K,
                                       const void* w, const void* scales, int O,
                                       long long w_stride, long long s_stride, const void* ids,
                                       int base, int n_ids, int n_sel, int ksplit,
                                       int rows_per_split, void* partials, void* counters,
                                       void* out, void* stream) {
  if (T < 1 || T > 8 || rows_per_split % 64 || n_sel < 1 || n_sel > 65535 || n_ids < 1 ||
      base < 0 || x_stride < 0 || w_stride < 0 || s_stride < 0 || ids == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  const bool vec = (O % kGemvCols) == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) | (uintptr_t)w_stride) % 16) == 0 &&
                   ((reinterpret_cast<uintptr_t>(scales) | (uintptr_t)(4 * s_stride)) % 16) == 0;
  const dim3 grid((O + kGemvTileCols - 1) / kGemvTileCols, ksplit, n_sel);
  const size_t smem = sizeof(float) * ((size_t)tt * rows_per_split + kGemvWarps * kGemvTileCols);
  GemvArgs a{T, K, O, rows_per_split, static_cast<const int8_t*>(w),
             static_cast<const float*>(scales), nullptr, nullptr, static_cast<float*>(partials),
             static_cast<int*>(counters), static_cast<float*>(out)};
  a.ids = static_cast<const int*>(ids);
  a.base = base;
  a.n_ids = n_ids;
  a.w_stride = (size_t)w_stride;
  a.s_stride = (size_t)s_stride;
  a.x_stride = (size_t)x_stride;
  const int rc = launch_gemv_tt<__nv_bfloat16, true>(tt, vec, grid, smem,
                                                     static_cast<cudaStream_t>(stream),
                                                     static_cast<const __nv_bfloat16*>(x), a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K3, the prefill tile (dq_tile.cuh), any T >= 1. x: [T, K] (K = the packed
// K, a multiple of 64, zero-padded), 16-byte aligned, bf16 (x_f32 = 0) or f32
// (x_f32 = 1, only with the epilogue); w: int8 [K, O]; scales: f32 [K/32, O];
// inv: f32 [T] and norm_w: f32 [K] for the fused-norm epilogue, both null
// without it; out: f32 [T, O]; partials: f32 [ksplit, T, O] (unused when
// ksplit == 1). ksplit and sb_per_split (64-row k-tiles) come from
// ops/qmatmul.py tile_plan.
extern "C" int dllama_q80_tile(const void* x, int x_f32, int T, int K, const void* w,
                               const void* scales, int O, const void* inv, const void* norm_w,
                               int ksplit, int sb_per_split, void* partials, void* out,
                               void* stream) {
  const dllama::tile::Params p{x, T, K, O, static_cast<const uint8_t*>(w),
                               static_cast<const float*>(scales), nullptr, dllama::tile::kSub,
                               static_cast<const float*>(inv),
                               static_cast<const float*>(norm_w), sb_per_split, nullptr};
  return dllama::tile::run<dllama::tile::Q80Front>(p, x_f32, ksplit,
                                                   static_cast<float*>(partials),
                                                   static_cast<float*>(out),
                                                   static_cast<cudaStream_t>(stream));
}
