// Q40 dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernels dllama_tpu/ops/qmatmul.py::_q40_kernel (K1, the
// dequant-matmul, with its fused-rmsnorm epilogue) and ::_q40_corr_kernel
// (K2, the nosub correction), with the stacked launchers reduced to a
// pointer offset where the index is a host number (the caller passes the
// view w[layer]) and to the expert-indexed form below where it lies in
// device memory; and, as a launch
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
// Decode (T <= 8, ops/qmatmul.py GEMV_MAX_T): q40_gemv_kernel below, a GEMV
// on K3's skeleton (q80_matmul.cu: 16-byte loads of 16 adjacent columns,
// the magic-exponent dequant, paired bf16 rounding, split-K summed in the
// kernel) whose row products run on the tensor cores. What bounds it on the
// H100: bytes at T = 1 — 0.625 B per weight (0.5 B of nibbles + 0.125 B of
// f32 scales), so the weights of a Llama-3-8B token (4.69 GB) take 1.40 ms
// at 3.35 TB/s — and, nearly as closely, the instructions that turn nibbles
// into bf16 weights. K3's form adds one FMA per weight and activation row
// on the CUDA cores to the dequant's few instructions; with the products
// on mma.sync a weight costs the same few instructions at every T <= 8.
// The design:
// - Lane group g (lane / 4) owns columns 16g..16g+15 of its warp's
//   128-column strip; lane c (lane % 4) of the group takes packed rows c and
//   c + 4 of each 8-row chunk. A chunk is one m16n8k16 step per column
//   pair: A = 16 columns x 16 logical rows, where k pair (2c, 2c + 1) is
//   packed row c's low and high nibble rows — one byte, so its two weights
//   round to bf16 together with one __floats2bfloat162_rn and are the A
//   register as they come — and B = the matching activation pairs x 8
//   activation rows (n = t, zero past T), staged once per block in shared
//   memory as (lo, hi) bf16 pairs. 8 mma steps cover a lane's 16 columns;
//   the f32 accumulators hold C = [column][t].
// - Per weight, no conversion instruction and no lone rounding: the nibbles
//   are masked in place (one AND per 4-byte word and nibble half), a byte
//   permute makes the float 2^23 + nibble exactly, one subtraction of
//   2^23 + sub (sub 8, or 0 under nosub) leaves q - sub exactly, q * delta
//   rounds to f32 and the pair to bf16 — q40_dot_ref's weight; the tensor
//   cores multiply exactly and add in f32.
// - Loads go through a ring of kStages chunk slots in shared memory per
//   warp, filled with cp.async: each lane copies its own two 16-byte rows
//   (through L2) and a quarter of its lane group's superblock scales, 16
//   s_lo and 16 s_hi (through L1: the superblock's other chunks read them
//   again), so kStages - 1 chunks are in flight while one is used — double
//   buffering in registers, K3's way, holds too few bytes in flight once
//   the scales take half the buffer. The slot layout keeps every shared
//   load free of bank conflicts. The first chunks fly while the activation
//   of the block's K range is staged (under nosub-correct, each 32-row
//   block's sum taken right there with a warp reduction, kept as -8 * sum).
// - A block's 8 warps cover two 128-column strips, 4 warps along K each:
//   warp r of a strip takes chunk r of every superblock, so the warps of a
//   split share its rows evenly whatever its length. Under nosub-correct
//   one chunk of each superblock (rotating over the 4) adds its correction,
//   -8 * blocksum * scale for each half, into the accumulators from the
//   scales it holds. K6's wide blocks put 8 strips side by side, a warp
//   each (1024 columns).
// - K is split across blocks (grid.y, ops/qmatmul.py gemv_plan in 64-row
//   units) where a width has few column blocks, as far as one wave of
//   resident blocks holds; the warps' sums are added in warp order, and the
//   last block of a column block to arrive (arrival counter +
//   __threadfence) adds the splits' partials in split order and resets its
//   counter to 0 — one launch a call, and a result that does not depend on
//   the order the blocks ran in.
//
// Prefill (T > 8): the tensor-core tile of dq_tile.cuh with the Q40 front
// end (nibble dequant; the nosub correction added per superblock from the
// staged block sums and scales), dllama_q40_tile below.
//
// Expert-indexed decode (dllama_q40_gemv_indexed): the GEMV over n_sel
// planes of a stack [N, K/2, O] (a mixture-of-experts layer's experts)
// whose indices ids[j] lie in device memory — the port of the JAX
// package's q40_matmul_stacked, which takes a traced plane index through
// scalar prefetch. A third grid axis runs over j, where the TPU scans: each
// block reads ids[j] once and offsets its plane, activation, output,
// partial and counter pointers; the arithmetic, split plan and split-K sum
// are the GEMV's own, so output j is bit for bit the launch on the view
// w[base + ids[j]]. An id outside [0, n_ids) reads nothing and gives NaN
// in output j.
#include "common.cuh"
#include "dq_tile.cuh"

namespace {

using dllama::tile::kNosubCorrect;
using dllama::tile::kNosubRaw;
using dllama::tile::kSub;
using dllama::tile::mma_bf16;
using dllama::tile::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = 16;               // adjacent columns a lane loads: 16 bytes of a row
constexpr int kWarpCols = 8 * kLaneCols;    // 128: the m16 fragments' rows of 8 mma steps
constexpr int kChunkRows = 8;               // packed rows a chunk: one k16 step (16 logical rows)
constexpr int kSbChunks = 32 / kChunkRows;  // chunks a 64-row superblock
constexpr int kMaxT = 8;                    // the n8 of the mma: activation rows
constexpr int kRowWarps = 4;                // K1's blocks: 4 warps along K x 2 strips (256 columns)

constexpr int kStages = 4;  // ring slots a warp: chunks in flight + the one in use
// A slot: the lanes' first rows (16 B each, in lane order), their second
// rows, then each lane group's 16 s_lo and 16 s_hi at a stride of 36 words
// — every shared load of a slot is free of bank conflicts
constexpr int kGroupWords = 36;
constexpr int kSlotWords = 2 * 32 * 4 + 8 * kGroupWords;

using dllama::copy16;
using dllama::copy16_l1;
using dllama::copy_commit;
using dllama::copy_wait;

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

// This lane's share of a chunk into a ring slot: packed rows prow and
// prow + 4 at its 16 columns (slot words 4 lane and 128 + 4 lane), and a
// quarter of its lane group's superblock scales — s_lo and s_hi of columns
// 4c..4c+3 (words 256 + 36 g + 4c and + 16). Vectorized, with cp.async;
// otherwise (ragged or unaligned planes) by plain loads and stores.
template <bool kVec>
__device__ __forceinline__ void issue_chunk(uint32_t* slot, const uint8_t* __restrict__ w,
                                            const float* __restrict__ s_lo,
                                            const float* __restrict__ s_hi, int O, int o0,
                                            size_t prow, int lane, int g, int c) {
  uint32_t* wq = slot + 4 * lane;
  float* sc = reinterpret_cast<float*>(slot + 256 + kGroupWords * g);
  const size_t srow = (prow / 32) * O + o0 + 4 * c;
  if (kVec) {
    const bool live = o0 < O;
    const int n = live ? 16 : 0;
    copy16(wq, live ? w + prow * O + o0 : w, n);
    copy16(wq + 128, live ? w + (prow + 4) * O + o0 : w, n);
    copy16_l1(sc + 4 * c, live ? s_lo + srow : s_lo, n);
    copy16_l1(sc + 16 + 4 * c, live ? s_hi + srow : s_hi, n);
  } else {
    *reinterpret_cast<uint4*>(wq) = load_row16(w, prow, O, o0);
    *reinterpret_cast<uint4*>(wq + 128) = load_row16(w, prow + 4, O, o0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = o0 + 4 * c + j < O;
      sc[4 * c + j] = in ? s_lo[srow + j] : 0.f;
      sc[16 + 4 * c + j] = in ? s_hi[srow + j] : 0.f;
    }
  }
}

// byte b of a word as the bf16 pair (lo nibble weight, hi nibble weight):
// wl/wh hold the word's nibbles in place, a byte permute makes the float
// 2^23 + nibble, minus magic (2^23 + sub) leaves q - sub exactly
__device__ __forceinline__ uint32_t dq_pair(uint32_t wl, uint32_t wh, int b, float magic,
                                            float slo, float shi) {
  const float ql = __uint_as_float(__byte_perm(wl, 0x4B000000u, 0x7540u | b)) - magic;
  const float qh = __uint_as_float(__byte_perm(wh, 0x4B000000u, 0x7540u | b)) - magic;
  return pack_bf16(ql * slo, qh * shi);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One chunk from its ring slot: acc[i] += A_i (16 columns x 16 logical
// rows) * B (16 rows x 8 activation rows). mma step i takes the lane's
// columns 2i (fragment row g) and 2i + 1 (row g + 8); k pair (2c, 2c + 1)
// is packed row c's (lo, hi) nibble rows, (2c + 8, 2c + 9) packed row
// c + 4's; B is the activation pairs of those rows for t = g (zero past T).
// Then, if this chunk owns its superblock's correction, -8 * blocksum *
// scale for each half and row.
__device__ __forceinline__ void chunk_use(const uint32_t* slot, const uint32_t* xp,
                                          const float* nbs, int xstride, int nblk, int T, int q,
                                          int lane, float magic, bool correct,
                                          float (&acc)[8][4]) {
  const int g = lane / 4, c = lane % 4;
  const uint4 r0 = *reinterpret_cast<const uint4*>(slot + 4 * lane);
  const uint4 r1 = *reinterpret_cast<const uint4*>(slot + 128 + 4 * lane);
  float lo[kLaneCols], hi[kLaneCols];
  const float4* sc = reinterpret_cast<const float4*>(slot + 256 + kGroupWords * g);
#pragma unroll
  for (int j = 0; j < kLaneCols / 4; ++j) {
    const float4 l = sc[j], h = sc[kLaneCols / 4 + j];
    lo[4 * j] = l.x; lo[4 * j + 1] = l.y; lo[4 * j + 2] = l.z; lo[4 * j + 3] = l.w;
    hi[4 * j] = h.x; hi[4 * j + 1] = h.y; hi[4 * j + 2] = h.z; hi[4 * j + 3] = h.w;
  }
  const uint32_t b0 = g < T ? xp[g * xstride + kChunkRows * q + c] : 0u;
  const uint32_t b1 = g < T ? xp[g * xstride + kChunkRows * q + c + 4] : 0u;
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) {
    const uint32_t w0 = word(r0, wi), w1 = word(r1, wi);
    const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
    const uint32_t l1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * wi + half, b = 2 * half, c0 = 2 * i, c1 = 2 * i + 1;
      const uint32_t a[4] = {dq_pair(l0, h0, b, magic, lo[c0], hi[c0]),
                             dq_pair(l0, h0, b + 1, magic, lo[c1], hi[c1]),
                             dq_pair(l1, h1, b, magic, lo[c0], hi[c0]),
                             dq_pair(l1, h1, b + 1, magic, lo[c1], hi[c1])};
      mma_bf16(acc[i], a, b0, b1);
    }
  }
  const int sb = q / kSbChunks;
  if (correct && q % kSbChunks == (sb / 2) % kSbChunks) {  // one chunk of each superblock
    const int t0 = 2 * c, t1 = 2 * c + 1;
    const float nl0 = t0 < T ? nbs[t0 * nblk + 2 * sb] : 0.f;
    const float nh0 = t0 < T ? nbs[t0 * nblk + 2 * sb + 1] : 0.f;
    const float nl1 = t1 < T ? nbs[t1 * nblk + 2 * sb] : 0.f;
    const float nh1 = t1 < T ? nbs[t1 * nblk + 2 * sb + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // acc[i]: (column 2i, t0), (2i, t1), (2i + 1, t0), (2i + 1, t1)
      acc[i][0] = fmaf(nh0, hi[2 * i], fmaf(nl0, lo[2 * i], acc[i][0]));
      acc[i][1] = fmaf(nh1, hi[2 * i], fmaf(nl1, lo[2 * i], acc[i][1]));
      acc[i][2] = fmaf(nh0, hi[2 * i + 1], fmaf(nl0, lo[2 * i + 1], acc[i][2]));
      acc[i][3] = fmaf(nh1, hi[2 * i + 1], fmaf(nl1, lo[2 * i + 1], acc[i][3]));
    }
  }
}

// 32-bit words of dynamic shared memory for T rows and a split of `rows`:
// the warps' rings, then the staged activation pairs (rows padded by 4
// words, so the B fragment loads of the 8 lane groups fall in distinct
// banks) and -8 * block sums, whose space later takes the row-warps' sums
// (T x 1024 words)
constexpr size_t gemv_smem_words(int T, int rows) {
  const size_t staged = (size_t)T * (rows / 2 + 4) + (size_t)T * (rows / 32);
  const size_t sums = (size_t)T * 1024;
  return (size_t)kWarps * kStages * kSlotWords + (staged > sums ? staged : sums);
}

// kRows warps take interleaved chunks of one 128-column strip: kRowWarps
// (K1's blocks of 256 columns), or 1 (K6's wide blocks of 1024). kIndexed:
// the expert-indexed form, plane base + ids[blockIdx.z] of the stack (see
// the file's head); otherwise ids and the strides are unused.
template <typename XT, bool kVec, int kRows, bool kIndexed>
__global__ void __launch_bounds__(kThreads, 2)
q40_gemv_kernel(const XT* __restrict__ x, int T, int K, const uint8_t* __restrict__ w,
                const float* __restrict__ s_lo, const float* __restrict__ s_hi, int O,
                int rows_per_split, int mode, const float* __restrict__ inv,
                const float* __restrict__ nw, float* __restrict__ partials,
                int* __restrict__ counters, float* __restrict__ out,
                const int* __restrict__ ids, int base, int n_ids, size_t w_stride,
                size_t s_stride, size_t x_stride) {
  constexpr int kBlockCols = kWarpCols * (kWarps / kRows);
  extern __shared__ __align__(16) float gsm[];
  const int block = blockIdx.x, split = blockIdx.y, ksplit = gridDim.y;
  if (kIndexed) {
    const int j = blockIdx.z, e = ids[j];
    out += (size_t)j * T * O;
    if (e < 0 || e >= n_ids) {  // no such expert: read nothing, output j is NaN
      for (int i = threadIdx.x; i < T * kBlockCols; i += kThreads) {
        const int o = block * kBlockCols + i % kBlockCols;
        if (o < O) out[(size_t)(i / kBlockCols) * O + o] = __int_as_float(0x7fc00000);
      }
      return;
    }
    const size_t plane = (size_t)base + e;
    w += plane * w_stride;
    s_lo += plane * s_stride;
    s_hi += plane * s_stride;
    x += j * x_stride;
    partials += (size_t)j * ksplit * T * O;
    counters += j * gridDim.x;
  }
  const int k0 = split * rows_per_split;  // logical rows, a multiple of 64
  const int nprow = min(rows_per_split, K - k0) / 2;
  const int xstride = rows_per_split / 2 + 4;
  const int nblk = rows_per_split / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* ring = reinterpret_cast<uint32_t*>(gsm) + warp * kStages * kSlotWords;
  float* tail = gsm + kWarps * kStages * kSlotWords;
  uint32_t* xp = reinterpret_cast<uint32_t*>(tail);  // [T, xstride]: (lo, hi) bf16 pairs
  float* nbs = tail + T * xstride;                   // [T, nblk]: -8 * each 32-row block's sum
  float* red = tail;                                 // [kRows, T, kBlockCols], after the loop
  const int rw = warp % kRows, cw = warp / kRows;
  const int g = lane / 4, c = lane % 4;
  const int col0 = cw * kWarpCols + g * kLaneCols;  // the lane's first column in the block
  const int o0 = block * kBlockCols + col0;
  // warp-uniform (mma.sync needs the whole warp): lanes past O copy zeros
  const int nchunks = block * kBlockCols + cw * kWarpCols < O ? nprow / kChunkRows : 0;
  const float magic = mode == kSub ? 8388616.f : 8388608.f;  // 2^23 + sub
  const bool correct = mode == kNosubCorrect;
  const size_t prow0 = (size_t)k0 / 2 + c;

  // row-warp r takes chunks r, r + kRows, ...; the first kStages - 1
  // are in flight while x is staged, and each later one is issued as the
  // chunk kStages - 1 before it is used
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    const int q = rw + n * kRows;
    if (q < nchunks)
      issue_chunk<kVec>(ring + n * kSlotWords, w, s_lo, s_hi, O, o0, prow0 + kChunkRows * q,
                        lane, g, c);
    copy_commit();
  }

  // a warp's 32 pairs are one superblock's 32 packed rows of one row t
  // (nprow and the stride are multiples of 32), so the loop is warp-uniform
#pragma unroll 4
  for (int i = threadIdx.x; i < T * nprow; i += kThreads) {
    const int t = i / nprow, p = i - t * nprow;
    const size_t k = (size_t)k0 + 64 * (p / 32) + p % 32;
    const float vlo = dllama::act_bf16(x, K, t, k, inv, nw);
    const float vhi = dllama::act_bf16(x, K, t, k + 32, inv, nw);
    xp[t * xstride + p] = pack_bf16(vlo, vhi);
    if (correct) {
      float sl = vlo, sh = vhi;
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        sl += __shfl_xor_sync(0xffffffffu, sl, m);
        sh += __shfl_xor_sync(0xffffffffu, sh, m);
      }
      if (lane == 0) {
        nbs[t * nblk + 2 * (p / 32)] = -8.f * sl;
        nbs[t * nblk + 2 * (p / 32) + 1] = -8.f * sh;
      }
    }
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int n = 0;; ++n) {
    const int q = rw + n * kRows;
    if (q >= nchunks) break;
    __syncwarp();  // every lane is done with the slot the next copy refills
    const int qn = q + (kStages - 1) * kRows;
    if (qn < nchunks)
      issue_chunk<kVec>(ring + (n + kStages - 1) % kStages * kSlotWords, w, s_lo, s_hi, O, o0,
                        prow0 + kChunkRows * qn, lane, g, c);
    copy_commit();
    copy_wait<kStages - 1>();  // this lane's copies of chunk n have landed
    __syncwarp();              // and every lane's
    chunk_use(ring + n % kStages * kSlotWords, xp, nbs, xstride, nblk, T, q, lane, magic,
              correct, acc);
  }
  __syncthreads();  // the staged tile is done with: its space takes the sums

  // the row-warps' sums in row-warp order -> this block's partial (or the answer)
  const int t0 = 2 * c, t1 = 2 * c + 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* r = red + (size_t)rw * T * kBlockCols + col0 + 2 * i;
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
  float* dst = ksplit > 1 ? partials + (size_t)split * T * O : out;
  for (int i = threadIdx.x; i < T * kBlockCols; i += kThreads) {
    const int o = block * kBlockCols + i % kBlockCols;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) v += red[(size_t)r * T * kBlockCols + i];
    if (o < O) dst[(size_t)(i / kBlockCols) * O + o] = v;
  }
  if (ksplit == 1) return;

  // the last block of this column strip to arrive adds the splits in order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + block, 1) == ksplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < T * kBlockCols; i += kThreads) {
    const int t = i / kBlockCols, o = block * kBlockCols + (i - t * kBlockCols);
    if (o >= O) continue;
    float v = 0.f;
#pragma unroll 8
    for (int k = 0; k < ksplit; ++k) v += __ldcg(partials + ((size_t)k * T + t) * O + o);
    out[(size_t)t * O + o] = v;
  }
  if (threadIdx.x == 0) counters[block] = 0;  // ready for the next launch
}

struct GemvArgs {
  int T, K, O, rows_per_split, mode;
  const uint8_t* w;
  const float *s_lo, *s_hi, *inv, *nw;
  float* partials;
  int* counters;
  float* out;
  // the expert-indexed form's: n_sel planes base + ids[j] of n_ids
  const int* ids = nullptr;
  int base = 0, n_ids = 0, n_sel = 1;
  size_t w_stride = 0, s_stride = 0, x_stride = 0;
};

template <typename XT, bool kVec, int kRows, bool kIndexed>
int launch_gemv(int ksplit, cudaStream_t st, const XT* x, const GemvArgs& a) {
  constexpr int kBlockCols = kWarpCols * (kWarps / kRows);
  auto kernel = q40_gemv_kernel<XT, kVec, kRows, kIndexed>;
  const size_t smem = sizeof(float) * gemv_smem_words(a.T, a.rows_per_split);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((a.O + kBlockCols - 1) / kBlockCols, ksplit, a.n_sel), kThreads, smem, st>>>(
      x, a.T, a.K, a.w, a.s_lo, a.s_hi, a.O, a.rows_per_split, a.mode, a.inv, a.nw, a.partials,
      a.counters, a.out, a.ids, a.base, a.n_ids, a.w_stride, a.s_stride, a.x_stride);
  return 0;
}

template <typename XT, int kRows, bool kIndexed = false>
int launch_gemv_vec(bool vec, int ksplit, cudaStream_t st, const XT* x, const GemvArgs& a) {
  return vec ? launch_gemv<XT, true, kRows, kIndexed>(ksplit, st, x, a)
             : launch_gemv<XT, false, kRows, kIndexed>(ksplit, st, x, a);
}

// resident blocks per SM of one instance for T rows at its largest shared
// memory (a split's staged activation holds at most 16384 values)
template <typename XT, int kRows>
int gemv_occupancy(int T) {
  const size_t smem = sizeof(float) * gemv_smem_words(T, 16384 / T);
  auto kernel = q40_gemv_kernel<XT, true, kRows, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// How many GEMV blocks for T rows (1 <= T <= 8, rounded up to a power of
// two) one SM holds at once, for either activation type — so the split
// plan, and with it the order of the sums, is the same for a fused f32 and
// an unfused bf16 launch (wide = 1: K6's wide blocks, bf16 x only); for
// ops/qmatmul.py gemv_plan. A negative value is minus a CUDA error code.
extern "C" int dllama_q40_gemv_blocks_per_sm(int T, int wide) {
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  if (wide) return gemv_occupancy<__nv_bfloat16, 1>(tt);
  const int a = gemv_occupancy<__nv_bfloat16, kRowWarps>(tt);
  const int b = gemv_occupancy<float, kRowWarps>(tt);
  return a <= 0 ? a : b <= 0 ? b : a < b ? a : b;
}

// K1 (+K2) and K6, the decode GEMV, 1 <= T <= 8. x: [T, K] (K = the packed
// K, zero-padded), bf16 (x_f32 = 0) or f32 (x_f32 = 1, only with the
// epilogue); w: uint8 [K/2, O]; s_lo, s_hi: f32 [K/64, O]; mode: 0 sub, 1
// nosub with the correction, 2 nosub without it (K6); inv: f32 [T] and
// norm_w: f32 [K] for the fused-norm epilogue, both null without it; wide =
// 1: K6's 1024-column blocks (bf16 x only); rows_per_split (a multiple of
// 64) and ksplit from ops/qmatmul.py q40_plan, rows_per_split * (T rounded
// up to a power of two) <= 16384; partials: f32 [ksplit, T, O] (unused when
// ksplit == 1); counters: int32 [>= the grid's column blocks], zero, and
// left zero — launches that share them must not overlap; out: f32 [T, O].
extern "C" int dllama_q40_gemv(const void* x, int x_f32, int T, int K, const void* w,
                               const void* s_lo, const void* s_hi, int O, int mode,
                               const void* inv, const void* norm_w, int wide, int ksplit,
                               int rows_per_split, void* partials, void* counters, void* out,
                               void* stream) {
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  if (T < 1 || T > kMaxT || rows_per_split % 64 || mode < kSub || mode > kNosubRaw ||
      (wide && x_f32) || (size_t)tt * rows_per_split > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (O % kLaneCols) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi)) %
                    16) == 0;
  const GemvArgs a{T, K, O, rows_per_split, mode, static_cast<const uint8_t*>(w),
                   static_cast<const float*>(s_lo), static_cast<const float*>(s_hi),
                   static_cast<const float*>(inv), static_cast<const float*>(norm_w),
                   static_cast<float*>(partials), static_cast<int*>(counters),
                   static_cast<float*>(out)};
  int rc;
  if (x_f32)
    rc = launch_gemv_vec<float, kRowWarps>(vec, ksplit, st, static_cast<const float*>(x), a);
  else if (wide)
    rc = launch_gemv_vec<__nv_bfloat16, 1>(vec, ksplit, st,
                                           static_cast<const __nv_bfloat16*>(x), a);
  else
    rc = launch_gemv_vec<__nv_bfloat16, kRowWarps>(vec, ksplit, st,
                                                   static_cast<const __nv_bfloat16*>(x), a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K1 (+K2), the expert-indexed decode GEMV, 1 <= T <= 8: out[j] = x_j @
// dequant(plane base + ids[j]) for j < n_sel. x: bf16 [n_sel, T, K] at
// x_stride elements per j (0: one x for every j); w: uint8 [N, K/2, O],
// s_lo, s_hi: f32 [N, K/64, O], at w_stride bytes and s_stride floats per
// plane; ids: int32 [n_sel] in device memory, each in [0, n_ids) (else
// output j is NaN), base + n_ids <= N; mode as for dllama_q40_gemv (0 or
// 1); ksplit and rows_per_split from ops/qmatmul.py q40_plan for one
// plane; partials: f32 [n_sel, ksplit, T, O] (unused when ksplit == 1);
// counters: int32 [>= n_sel * the column blocks], zero, left zero; out:
// f32 [n_sel, T, O].
extern "C" int dllama_q40_gemv_indexed(const void* x, long long x_stride, int T, int K,
                                       const void* w, const void* s_lo, const void* s_hi, int O,
                                       long long w_stride, long long s_stride, const void* ids,
                                       int base, int n_ids, int n_sel, int mode, int ksplit,
                                       int rows_per_split, void* partials, void* counters,
                                       void* out, void* stream) {
  const int tt = T > 4 ? 8 : T > 2 ? 4 : T;
  if (T < 1 || T > kMaxT || rows_per_split % 64 || mode < kSub || mode > kNosubCorrect ||
      (size_t)tt * rows_per_split > 16384 || n_sel < 1 || n_sel > 65535 || n_ids < 1 ||
      base < 0 || x_stride < 0 || w_stride < 0 || s_stride < 0 || ids == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (O % kLaneCols) == 0 &&
                   ((reinterpret_cast<uintptr_t>(w) | (uintptr_t)w_stride) % 16) == 0 &&
                   ((reinterpret_cast<uintptr_t>(s_lo) | reinterpret_cast<uintptr_t>(s_hi) |
                     (uintptr_t)(4 * s_stride)) % 16) == 0;
  GemvArgs a{T, K, O, rows_per_split, mode, static_cast<const uint8_t*>(w),
             static_cast<const float*>(s_lo), static_cast<const float*>(s_hi), nullptr, nullptr,
             static_cast<float*>(partials), static_cast<int*>(counters),
             static_cast<float*>(out)};
  a.ids = static_cast<const int*>(ids);
  a.base = base;
  a.n_ids = n_ids;
  a.n_sel = n_sel;
  a.w_stride = (size_t)w_stride;
  a.s_stride = (size_t)s_stride;
  a.x_stride = (size_t)x_stride;
  const int rc = launch_gemv_vec<__nv_bfloat16, kRowWarps, true>(
      vec, ksplit, static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(x), a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K1 (+K2) and K6, the prefill tile (dq_tile.cuh), any T >= 1. Operands as
// for dllama_q40_gemv, except: x 16-byte aligned; ksplit and sb_per_split
// (64-row k-tiles) from ops/qmatmul.py tile_plan.
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
