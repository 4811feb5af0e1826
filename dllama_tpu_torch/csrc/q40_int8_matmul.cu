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
// holds rows 64s+j and 64s+32+j, scales s_lo/s_hi f32 [K/64, O]), so the
// low nibbles of superblock s are block 2s and the high nibbles block
// 2s + 1. A block's dot is at most 32 * 127 * 15 = 60,960 in magnitude,
// exact in int32 and in f32. Each block adds f32(dot) * (sx * s) to the
// sum, the scale product first, each step rounded on its own
// (__fmul_rn/__fadd_rn), low block before high, in JAX's order.
//
// What bounds it on the H100: bytes, as K1 (0.625 B per weight at T = 1:
// 28.2 MB at K 4096, O 11008, 8.4 us at 3.35 TB/s); the int8 activation is
// a quarter of a bf16 row. The first port, a CUDA-core int32 multiply-add
// per nibble with K split into a second sum_splits launch, took 6x that.
//
// Design: the skeleton of K1's decode GEMV (q40_matmul.cu q40_gemv_kernel)
// with the products on the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. One k32 step is exactly one Q80
// block of one nibble plane: A = 16 columns x the 32 packed rows of a
// superblock as nibbles (w & 0x0F0F0F0F for the low block, (w >> 4) &
// 0x0F0F0F0F for the high), B = the block's 32 int8 activations x 8 rows
// (n = t, zero past T), C = the exact int32 dots.
// - A block is 4 warps along K over one 128-column strip (lane group g
//   owns columns 16g..16g+15); warp r takes superblocks r, r + 4, ... of
//   its split, so the warps share a split's rows evenly.
// - Loads go through a per-warp ring of kStages superblock slots in shared
//   memory, filled with cp.async (weights through L2, scales through L1):
//   lane c of a group copies packed rows 4c..4c+3 and 16+4c..16+4c+3 at its
//   group's 16 columns, the rows its A fragments need (k 4c.. and 16+4c..
//   of the m16n8k32 layout), and a quarter of the group's s_lo and s_hi.
//   The order of k inside a block is free (the dot is exact), so the only
//   reshuffle is a 4 x 4 byte transpose (__byte_perm) turning 4 rows of 4
//   columns into each column's 4 consecutive k: one A register.
// - The activation rows of the block's K range are staged once in shared
//   memory as int8 (4 consecutive k a 32-bit B register, rows padded so the
//   8 lane groups' loads fall in distinct banks) with their block scales.
// - K is split across blocks (grid.y) as far as one wave of resident
//   blocks holds; the warps' sums are added in warp order, and the last
//   block of a column strip to arrive (arrival counter + __threadfence)
//   adds the splits in split order and resets its counter: one launch a
//   call, a result independent of the order the blocks ran in. Rows past
//   8 take further row tiles (grid.z), each with its own counters.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;                // warps along K, one 128-column strip a block
constexpr int kThreads = 32 * kRowWarps;
constexpr int kLaneCols = 16;               // adjacent columns a lane group loads: 16 B a row
constexpr int kBlockCols = 8 * kLaneCols;   // 128: 8 m16 tiles of 2 columns per lane group
constexpr int kMaxT = 8;                    // the n8 of the mma: activation rows a tile
constexpr int kStages = 4;                  // ring slots a warp: superblocks in flight + in use
// A slot: row j (0..7) of every lane, 16 B each in lane order (8 x 128
// words), then each lane group's 16 s_lo and 16 s_hi at a stride of 36
// words — every shared load of a slot is free of bank conflicts
constexpr int kGroupWords = 36;
constexpr int kRowWords = 8 * 128;
constexpr int kSlotWords = kRowWords + 8 * kGroupWords;
constexpr int kMaxStaged = 16384;  // int8 activations a block stages: rows x T (rounded up)

using dllama::copy16;
using dllama::copy16_l1;
using dllama::copy_commit;
using dllama::copy_wait;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

// packed row p of the superblock a lane copies into its slot row j: rows
// 4c..4c+3 (j < 4), then 16+4c..16+4c+3
__device__ __forceinline__ int lane_row(int j, int c) {
  return j < 4 ? 4 * c + j : 12 + 4 * c + j;
}

// the 16 bytes of packed row prow at columns o0..o0+15 (zeros past O)
__device__ __forceinline__ uint4 load_row16(const uint8_t* __restrict__ w, size_t prow, int O,
                                            int o0) {
  const uint8_t* p = w + prow * O + o0;
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c)
    if (o0 + c < O) v[c / 4] |= (uint32_t)p[c] << (8 * (c % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// This lane's share of superblock sb into a ring slot: its 8 packed rows
// at its group's 16 columns o0.. (slot words 128 j + 4 lane) and s_lo, s_hi
// of columns o0 + 4c..+3 (words kRowWords + 36 g + 4c and + 16).
// Vectorized, with cp.async; otherwise (ragged or unaligned planes) by
// plain loads and stores.
template <bool kVec>
__device__ __forceinline__ void fetch_chunk(uint32_t* slot, const uint8_t* __restrict__ w,
                                            const float* __restrict__ s_lo,
                                            const float* __restrict__ s_hi, int O, int o0,
                                            int sb, int lane, int g, int c) {
  float* sc = reinterpret_cast<float*>(slot + kRowWords + kGroupWords * g);
  const size_t p0 = (size_t)sb * 32, srow = (size_t)sb * O + o0 + 4 * c;
  if (kVec) {
    const bool live = o0 < O;
    const int n = live ? 16 : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      copy16(slot + 128 * j + 4 * lane, live ? w + (p0 + lane_row(j, c)) * O + o0 : w, n);
    copy16_l1(sc + 4 * c, live ? s_lo + srow : s_lo, n);
    copy16_l1(sc + 16 + 4 * c, live ? s_hi + srow : s_hi, n);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint4*>(slot + 128 * j + 4 * lane) =
          load_row16(w, p0 + lane_row(j, c), O, o0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = o0 + 4 * c + j < O;
      sc[4 * c + j] = in ? s_lo[srow + j] : 0.f;
      sc[16 + 4 * c + j] = in ? s_hi[srow + j] : 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows a, b, c, d of 4 columns -> col[i] = column i's 4 rows, row a in the
// low byte
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* col) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140), ab23 = __byte_perm(a, b, 0x7362);
  const uint32_t cd01 = __byte_perm(c, d, 0x5140), cd23 = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab01, cd01, 0x5410);
  col[1] = __byte_perm(ab01, cd01, 0x7632);
  col[2] = __byte_perm(ab23, cd23, 0x5410);
  col[3] = __byte_perm(ab23, cd23, 0x7632);
}

// One superblock from its ring slot (sbl: its index in the split). Tile i
// takes the group's columns 2i (fragment row g) and 2i + 1 (row g + 8); for
// each nibble plane one mma gives the exact dots of (column, t) for t = 2c,
// 2c + 1, which are scaled and added: acc[i] = (2i, t0), (2i, t1),
// (2i + 1, t0), (2i + 1, t1).
__device__ __forceinline__ void chunk_use(const uint32_t* slot, const uint32_t* xs,
                                          const float* sxs, int xstride, int nblk, int T,
                                          int sbl, int lane, float (&acc)[8][4]) {
  const int g = lane / 4, c = lane % 4;
  uint32_t ka[kLaneCols], kb[kLaneCols];  // each column's k 4c.. and 16+4c.. bytes
  {
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = *reinterpret_cast<const uint4*>(slot + 128 * j + 4 * lane);
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
      transpose4(word(r[0], wi), word(r[1], wi), word(r[2], wi), word(r[3], wi), ka + 4 * wi);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const uint4*>(slot + 128 * (j + 4) + 4 * lane);
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
      transpose4(word(r[0], wi), word(r[1], wi), word(r[2], wi), word(r[3], wi), kb + 4 * wi);
  }
  const uint32_t* xw = xs + g * xstride + 16 * sbl + c;  // row t = g, k 64 sbl + 4c..
  const bool live = g < T;
  const uint32_t blo0 = live ? xw[0] : 0u, blo1 = live ? xw[4] : 0u;
  const uint32_t bhi0 = live ? xw[8] : 0u, bhi1 = live ? xw[12] : 0u;
  const int t0 = 2 * c, t1 = 2 * c + 1;
  const float sxl0 = t0 < T ? sxs[t0 * nblk + 2 * sbl] : 0.f;
  const float sxh0 = t0 < T ? sxs[t0 * nblk + 2 * sbl + 1] : 0.f;
  const float sxl1 = t1 < T ? sxs[t1 * nblk + 2 * sbl] : 0.f;
  const float sxh1 = t1 < T ? sxs[t1 * nblk + 2 * sbl + 1] : 0.f;
  const float* sc = reinterpret_cast<const float*>(slot + kRowWords + kGroupWords * g);
  constexpr uint32_t kLo = 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t alo[4] = {ka[2 * i] & kLo, ka[2 * i + 1] & kLo, kb[2 * i] & kLo,
                             kb[2 * i + 1] & kLo};
    const uint32_t ahi[4] = {(ka[2 * i] >> 4) & kLo, (ka[2 * i + 1] >> 4) & kLo,
                             (kb[2 * i] >> 4) & kLo, (kb[2 * i + 1] >> 4) & kLo};
    int dlo[4], dhi[4];
    mma_s8(dlo, alo, blo0, blo1);
    mma_s8(dhi, ahi, bhi0, bhi1);
    const float2 lo = *reinterpret_cast<const float2*>(sc + 2 * i);
    const float2 hi = *reinterpret_cast<const float2*>(sc + 16 + 2 * i);
    const float sl[4] = {__fmul_rn(sxl0, lo.x), __fmul_rn(sxl1, lo.x), __fmul_rn(sxl0, lo.y),
                         __fmul_rn(sxl1, lo.y)};
    const float sh[4] = {__fmul_rn(sxh0, hi.x), __fmul_rn(sxh1, hi.x), __fmul_rn(sxh0, hi.y),
                         __fmul_rn(sxh1, hi.y)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn((float)dlo[e], sl[e]));
      acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn((float)dhi[e], sh[e]));
    }
  }
}

// 32-bit words of dynamic shared memory for T rows and a split of `rows`:
// the warps' rings, then the staged activation (int8, rows padded by 4
// words) and block scales, whose space later takes the row-warps' sums
constexpr size_t smem_words(int T, int rows) {
  const size_t staged = (size_t)T * (rows / 4 + 4) + (size_t)T * (rows / 32);
  const size_t sums = (size_t)kRowWarps * T * kBlockCols;
  return (size_t)kRowWarps * kStages * kSlotWords + (staged > sums ? staged : sums);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
q40_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx, int T_all, int K,
                const uint8_t* __restrict__ w, const float* __restrict__ s_lo,
                const float* __restrict__ s_hi, int O, int rows_per_split,
                float* __restrict__ partials, int* __restrict__ counters,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int block = blockIdx.x, split = blockIdx.y, ksplit = gridDim.y;
  const int t_base = blockIdx.z * kMaxT;
  const int T = min(kMaxT, T_all - t_base);  // this tile's rows
  const int k0 = split * rows_per_split;      // a multiple of 64
  const int nrows = min(rows_per_split, K - k0);
  const int nsb = nrows / 64;
  const int xstride = rows_per_split / 4 + 4;  // words
  const int nblk = rows_per_split / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + warp * kStages * kSlotWords;
  float* tail = smem + kRowWarps * kStages * kSlotWords;
  uint32_t* xs = reinterpret_cast<uint32_t*>(tail);  // [T, xstride]: 4 int8 a word
  float* sxs = tail + T * xstride;                    // [T, nblk]
  float* red = tail;                                  // [kRowWarps, T, kBlockCols], after
  const int col0 = g * kLaneCols;
  const int o0 = block * kBlockCols + col0;
  // warp-uniform (mma.sync needs the whole warp): lanes past O copy zeros
  const int nchunks = block * kBlockCols < O ? nsb : 0;

  // warp r takes superblocks r, r + kRowWarps, ...; the first kStages - 1
  // are in flight while x is staged
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    const int q = warp + n * kRowWarps;
    if (q < nchunks)
      fetch_chunk<kVec>(ring + n * kSlotWords, w, s_lo, s_hi, O, o0, k0 / 64 + q, lane, g, c);
    copy_commit();
  }

  const int nw = nrows / 4;
  for (int i = threadIdx.x; i < T * nw; i += kThreads) {
    const int t = i / nw, wi = i - t * nw;
    xs[t * xstride + wi] =
        *reinterpret_cast<const uint32_t*>(xq + (size_t)(t_base + t) * K + k0 + 4 * wi);
  }
  for (int i = threadIdx.x; i < T * (nrows / 32); i += kThreads) {
    const int t = i / (nrows / 32), b = i - t * (nrows / 32);
    sxs[t * nblk + b] = sx[(size_t)(t_base + t) * (K / 32) + k0 / 32 + b];
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int n = 0;; ++n) {
    const int q = warp + n * kRowWarps;
    if (q >= nchunks) break;
    __syncwarp();  // every lane is done with the slot the next copy refills
    const int qn = q + (kStages - 1) * kRowWarps;
    if (qn < nchunks)
      fetch_chunk<kVec>(ring + (n + kStages - 1) % kStages * kSlotWords, w, s_lo, s_hi, O, o0,
                        k0 / 64 + qn, lane, g, c);
    copy_commit();
    copy_wait<kStages - 1>();  // this lane's copies of superblock n have landed
    __syncwarp();              // and every lane's
    chunk_use(ring + n % kStages * kSlotWords, xs, sxs, xstride, nblk, T, q, lane, acc);
  }
  __syncthreads();  // the staged activation is done with: its space takes the sums

  // the row-warps' sums in warp order -> this block's partial (or the answer)
  const int t0 = 2 * c, t1 = 2 * c + 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* r = red + (size_t)warp * T * kBlockCols + col0 + 2 * i;
    if (t0 < T) {
      r[t0 * kBlockCols] = acc[i][0];
      r[t0 * kBlockCols + 1] = acc[i][2];
    }
    if (t1 < T) {
      r[t1 * kBlockCols] = acc[i][1];
      r[t1 * kBlockCols + 1] = acc[i][3];
    }
  }
  __syncthreads();
  float* dst = ksplit > 1 ? partials + (size_t)split * T_all * O : out;
  for (int i = threadIdx.x; i < T * kBlockCols; i += kThreads) {
    const int o = block * kBlockCols + i % kBlockCols;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kRowWarps; ++r) v += red[(size_t)r * T * kBlockCols + i];
    if (o < O) dst[(size_t)(t_base + i / kBlockCols) * O + o] = v;
  }
  if (ksplit == 1) return;

  // the last block of this column strip and row tile to arrive adds the
  // splits in order
  __shared__ int is_last;
  int* counter = counters + blockIdx.z * gridDim.x + block;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == ksplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < T * kBlockCols; i += kThreads) {
    const int t = t_base + i / kBlockCols, o = block * kBlockCols + i % kBlockCols;
    if (o >= O) continue;
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < ksplit; ++k) v += __ldcg(partials + ((size_t)k * T_all + t) * O + o);
    out[(size_t)t * O + o] = v;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

int rows_rounded(int T) { return T > 4 ? 8 : T > 2 ? 4 : T; }

}  // namespace

// K7's resident blocks per SM for T rows (rounded up to a power of two, at
// most 8) at its largest shared memory, for qkernel_experiments.py
// int8_plan. A negative value is minus a CUDA error code.
extern "C" int dllama_q40_int8_blocks_per_sm(int T) {
  const int tt = rows_rounded(T < kMaxT ? T : kMaxT);
  const size_t smem = sizeof(float) * smem_words(tt, kMaxStaged / tt);
  auto kernel = q40_int8_kernel<true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// xq: int8 [T, K] (K = the packed K, zero-padded), 4-byte aligned; sx: f32
// [T, K/32]; w: uint8 [K/2, O]; s_lo, s_hi: f32 [K/64, O]; rows_per_split (a
// multiple of 64) and ksplit from qkernel_experiments.py int8_plan,
// rows_per_split * (min(T, 8) rounded up to a power of two) <= 16384;
// partials: f32 [ksplit, T, O] (unused when ksplit == 1); counters: int32
// [>= ceil(O / 128) * ceil(T / 8)], zero, and left zero — launches that
// share them must not overlap; out: f32 [T, O].
extern "C" int dllama_q40_int8_matmul(const void* xq, const void* sx, int T, int K,
                                      const void* w, const void* s_lo, const void* s_hi, int O,
                                      int ksplit, int rows_per_split, void* partials,
                                      void* counters, void* out, void* stream) {
  const int tt = rows_rounded(T < kMaxT ? T : kMaxT);
  if (T < 1 || K % 64 || rows_per_split % 64 || rows_per_split < 64 || ksplit < 1 ||
      (size_t)tt * rows_per_split > kMaxStaged || (long long)ksplit * rows_per_split < K ||
      reinterpret_cast<uintptr_t>(xq) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (O % kLaneCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi)) %
                    16) == 0;
  auto kernel = vec ? q40_int8_kernel<true> : q40_int8_kernel<false>;
  const size_t smem = sizeof(float) * smem_words(T < kMaxT ? T : kMaxT, rows_per_split);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((O + kBlockCols - 1) / kBlockCols, ksplit, (T + kMaxT - 1) / kMaxT);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx), T, K,
      static_cast<const uint8_t*>(w), static_cast<const float*>(s_lo),
      static_cast<const float*>(s_hi), O, rows_per_split, static_cast<float*>(partials),
      static_cast<int*>(counters), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
