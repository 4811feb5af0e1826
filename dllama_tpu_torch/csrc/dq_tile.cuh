// The prefill tile of the Q40 and Q80 dequant-matmuls for Hopper (sm_90a):
// one tensor-core mainloop, two front ends (q40_matmul.cu, q80_matmul.cu).
//
// Replaces, for T > 8 activation rows (ops/qmatmul.py GEMV_MAX_T), the TPU
// kernels dllama_tpu/ops/qmatmul.py::_q40_kernel (K1) with ::_q40_corr_kernel
// (K2, the nosub correction) folded in, and ::_q80_kernel (K3). On the TPU
// those do their product on the MXU (jnp.dot of x and the bf16 dequantized
// tile with an f32 accumulator); here that is mma.sync m16n8k16 bf16 -> f32.
//
// Function: out[t, o] (f32) = sum_k bf16(x[t, k]) * bf16(dequant(W)[k, o]).
// Dequant: Q40 (q - 8) * delta (sub), or q * delta with the exact correction
// -8 * (blocksum_lo(x) * s_lo + blocksum_hi(x) * s_hi) added per superblock
// (nosub), or q * delta alone (nosub raw, K6); Q80 q * delta. With the
// fused-norm epilogue (inv != nullptr) each staged x element is
// bf16(nw * (x * inv)) as common.cuh act_bf16 computes it, so fused equals
// unfused bit for bit.
//
// What bounds it on the H100: at T = 128 operations (2 T K O bf16 products
// at 989 TFLOP/s) for every Llama-3-8B width but wcls; the weights (0.625 B
// a weight for Q40, 1.125 B for Q80) are read once, since one 128-row M tile
// covers the whole prefill bucket. What holds it back is the work beside the
// products: every block dequantizes its weights and restages x (re-read from
// L2 by every column tile) once per k-tile, on the same SM as its mma.sync
// (wgmma and TMA are not used).
//
// Design. A block computes a 128 x 128 output tile (BM x BN) over a range of
// 64-row k-tiles (one Q40 superblock, two Q80 scale blocks): 8 warps, each
// 64 rows x 32 columns = 4 x 4 m16n8 fragments. Each pair of mma.sync k16
// steps starts from zero and its 32-product sum is added to an f32 register
// accumulator at once (the tensor core's own accumulation never runs longer
// than 32 products, so its rounding cannot build up over K = 14336, and no
// second fragment set is held): 64 accumulator registers, at most 128 in
// all, so two blocks share an SM and one block's staging and copies overlap
// the other's MMAs. Each k-tile passes through
//   1. a raw stage: 16-byte cp.async of its weight bytes, scale rows and x
//      rows into one of two raw stages, issued one k-tile ahead (zero-filled
//      past O and past T; for O not a multiple of 16 the weights take a
//      masked byte-wise path of the same kernel);
//   2. staging: all threads dequantize the weight bytes into a padded bf16
//      [BK][BN+8] tile (a byte under 0x4B0000 is 2^23 + q as an f32, so q
//      costs one subtraction and no conversion); f32 or fused-norm x rows
//      are normalized and rounded into a padded bf16 [BM][BK+8] tile, while
//      bf16 x without the norm is read where it landed (its raw rows are
//      padded the same way); in nosub mode, the f32 sums of each row's
//      32-value halves in k order and the scale rows times -8;
//   3. the MMAs: ldmatrix.x4 (A) and ldmatrix.x4.trans (B) feed 2 pairs of
//      k16 steps (branch-free when all 128 rows are below T); in nosub mode
//      two FMAs per accumulator add the superblock's correction.
// Rows are padded by 16 bytes so the 8 row addresses of every ldmatrix fall
// in distinct bank groups. Few output tiles (wo, wqkv, w2 at T = 128: 32-48)
// are split along K by ops/qmatmul.py tile_plan, the partials summed in split
// order by dllama::sum_splits: no float atomics, two launches give the same
// bits. More than 128 rows take further M tiles on grid.z.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dllama {
namespace tile {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kMI = 4, kNI = 4;  // a warp's m16 and n8 fragments
constexpr int kApad = BK + 8;  // bf16 per row of the x tile
constexpr int kBpad = BN + 8;  // bf16 per row of the weight tile

enum Mode { kSub = 0, kNosubCorrect = 1, kNosubRaw = 2 };

struct Params {
  const void* x;
  int T, K, O;
  const uint8_t* w;   // Q40 packed nibbles [K/2, O] or Q80 int8 [K, O]
  const float* s0;    // Q40 s_lo [K/64, O]; Q80 scales [K/32, O]
  const float* s1;    // Q40 s_hi [K/64, O]; unused for Q80
  int mode;           // Mode (Q80: kSub's "no correction", sub 0)
  const float* inv;   // [T] or null: the fused-norm epilogue
  const float* nw;    // [K] or null
  int sb_per_split;   // k-tiles per split (grid.y)
  float* dst;         // out [T, O] or partials [ksplit, T, O]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte b (0..3) of w as an f32 2^23 + w_b, exactly
__device__ __forceinline__ float byte_2p23(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b));
}

// N consecutive f32 values of shared memory (16-byte aligned)
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}

// ---------------------------------------------------------------------------
// Front ends: the raw stage of one k-tile is kWRows rows of BN weight bytes,
// then two rows of BN f32 scales; dequant() turns it into the bf16 tile.
// ---------------------------------------------------------------------------

struct Q40Front {
  static constexpr int kWRows = 32;  // packed byte rows of a superblock
  static constexpr bool kNibbles = true;  // sub mode recenters q by 8
  // scale row r of superblock s: s_lo (r = 0) or s_hi (r = 1)
  __device__ static const float* scale_row(const Params& p, int s, int r) {
    return (r == 0 ? p.s0 : p.s1) + (size_t)s * p.O;
  }
  // byte row j holds k-row j (low nibble, s_lo) and 32 + j (high, s_hi);
  // a thread takes 16 columns of one byte row (32 rows x 8 chunks), 8 at a
  // time
  __device__ static void dequant(const uint8_t* st, __nv_bfloat16* bs, float sub) {
    const int r = threadIdx.x >> 3;
    const float* sc = reinterpret_cast<const float*>(st + kWRows * BN);
    const float base = 8388608.f + sub;  // 2^23 + sub: one subtraction gives q - sub
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = (threadIdx.x & 7) * 16 + half * 8;
      const uint2 q = *reinterpret_cast<const uint2*>(st + r * BN + cc);
      const uint32_t words[2] = {q.x, q.y};
      float slo[8], shi[8];
      load_f(sc + cc, slo);
      load_f(sc + BN + cc, shi);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const uint32_t wl = words[c / 4] & 0x0f0f0f0fu, wh = (words[c / 4] >> 4) & 0x0f0f0f0fu;
        lo[c / 2] = pack_bf16((byte_2p23(wl, c % 4) - base) * slo[c],
                              (byte_2p23(wl, c % 4 + 1) - base) * slo[c + 1]);
        hi[c / 2] = pack_bf16((byte_2p23(wh, c % 4) - base) * shi[c],
                              (byte_2p23(wh, c % 4 + 1) - base) * shi[c + 1]);
      }
      *reinterpret_cast<uint4*>(bs + r * kBpad + cc) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(bs + (32 + r) * kBpad + cc) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
};

struct Q80Front {
  static constexpr int kWRows = 64;  // int8 rows of two 32-row scale blocks
  static constexpr bool kNibbles = false;
  __device__ static const float* scale_row(const Params& p, int s, int r) {
    return p.s0 + (size_t)(2 * s + r) * p.O;
  }
  // a thread takes 16 columns of two rows: 64 rows x 8 chunks
  __device__ static void dequant(const uint8_t* st, __nv_bfloat16* bs, float) {
    const float* sc = reinterpret_cast<const float*>(st + kWRows * BN);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c16 = threadIdx.x + i * kThreads;
      const int r = c16 >> 3, cc = (c16 & 7) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(st + r * BN + cc);
      const uint32_t words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u, q.z ^ 0x80808080u,
                                 q.w ^ 0x80808080u};  // bytes q + 128
      float s[16];
      load_f(sc + (r >> 5) * BN + cc, s);
      uint32_t v[8];
#pragma unroll
      for (int c = 0; c < 16; c += 2)  // 2^23 + (q + 128), exactly, then q
        v[c / 2] = pack_bf16((byte_2p23(words[c / 4], c % 4) - 8388736.f) * s[c],
                             (byte_2p23(words[c / 4], c % 4 + 1) - 8388736.f) * s[c + 1]);
      uint4* d = reinterpret_cast<uint4*>(bs + r * kBpad + cc);
      d[0] = make_uint4(v[0], v[1], v[2], v[3]);
      d[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
  }
};

// Shared memory: the staged bf16 tiles the MMAs read (x [BM][kApad], weights
// [BK][kBpad]), the block sums and -8 x the scale rows; then two raw stages
// the copies land in (weight bytes, scale rows, x rows padded by 16 bytes).
template <class F, typename XT>
struct Layout {
  static constexpr int kXRow = BK * (int)sizeof(XT) + 16;  // bytes per raw x row
  static constexpr int kA = BM * kApad * 2, kB = BK * kBpad * 2;
  static constexpr int kSum = BM * 2 * 4, kScl = 2 * BN * 4, kW = F::kWRows * BN;
  static constexpr int kRaw = kW + kScl + BM * kXRow;
  static constexpr int kSmem = kA + kB + kSum + kScl + 2 * kRaw;
  static_assert(sizeof(XT) != 2 || kXRow == kApad * 2, "bf16 raw x rows are x tile rows");
};

template <class F, typename XT>
struct Smem {
  using L = Layout<F, XT>;
  __nv_bfloat16* as;  // [BM][kApad]
  __nv_bfloat16* bs;  // [BK][kBpad]
  float* bsum;        // [BM][2]: each x row's 32-value half sums (nosub)
  float* scl;         // [2][BN]: -8 x the k-tile's scale rows (nosub)
  uint8_t* raw0;      // raw stage 0, then 1: weight bytes [kWRows][BN],
                      // scales [2][BN], x [BM][kXRow]
  __device__ explicit Smem(uint8_t* base) {
    as = reinterpret_cast<__nv_bfloat16*>(base);
    bs = reinterpret_cast<__nv_bfloat16*>(base + L::kA);
    bsum = reinterpret_cast<float*>(base + L::kA + L::kB);
    scl = reinterpret_cast<float*>(base + L::kA + L::kB + L::kSum);
    raw0 = base + L::kA + L::kB + L::kSum + L::kScl;
  }
  __device__ uint8_t* raw(int j) const { return raw0 + j * L::kRaw; }
};

// cp.async (or, for ragged O, masked loads) of k-tile s's raw stage: the
// weight bytes and scale rows of columns n0 .. n0 + BN - 1, and the x rows
// m0 .. m0 + BM - 1 (zeros past T)
template <class F, typename XT, bool kVec>
__device__ __forceinline__ void load_stage(const Params& p, int s, int n0, int m0, uint8_t* st) {
  using L = Layout<F, XT>;
  const uint8_t* wk = p.w + (size_t)s * F::kWRows * p.O;
  float* sc = reinterpret_cast<float*>(st + L::kW);
  if (kVec) {  // O % 16 == 0: every 16-byte chunk lies wholly inside or past O
#pragma unroll
    for (int c = threadIdx.x; c < F::kWRows * BN / 16; c += kThreads) {
      const int r = c >> 3, col = n0 + (c & 7) * 16;
      const bool in = col < p.O;
      cp_async16(st + r * BN + (c & 7) * 16, in ? wk + (size_t)r * p.O + col : p.w, in ? 16 : 0);
    }
    if (threadIdx.x < 2 * BN / 4) {
      const int r = threadIdx.x / (BN / 4), cc = (threadIdx.x % (BN / 4)) * 4;
      const bool in = n0 + cc < p.O;
      cp_async16(sc + r * BN + cc, in ? F::scale_row(p, s, r) + n0 + cc : p.s0, in ? 16 : 0);
    }
  } else {  // ragged O: byte-wise, masked (not unrolled: it would spill)
#pragma unroll 1
    for (int i = threadIdx.x; i < F::kWRows * BN; i += kThreads) {
      const int r = i / BN, cc = i % BN;
      st[i] = n0 + cc < p.O ? wk[(size_t)r * p.O + n0 + cc] : (uint8_t)0;
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
      const int r = i / BN, cc = i % BN;
      sc[i] = n0 + cc < p.O ? F::scale_row(p, s, r)[n0 + cc] : 0.f;
    }
  }
  constexpr int kPerRow = BK * (int)sizeof(XT) / 16;  // 16-byte chunks of an x row
  const XT* x = static_cast<const XT*>(p.x) + (size_t)s * BK;
  uint8_t* xs = st + L::kW + L::kScl;
#pragma unroll
  for (int c = threadIdx.x; c < BM * kPerRow; c += kThreads) {
    const int r = c / kPerRow, cc = c % kPerRow;
    const bool in = m0 + r < p.T;
    cp_async16(xs + r * L::kXRow + cc * 16,
               in ? x + (size_t)(m0 + r) * p.K + cc * (16 / (int)sizeof(XT)) : x, in ? 16 : 0);
  }
}

// One thread's share of the x tile: row tid / 2, the 32 k of half tid % 2.
template <typename XT>
struct XPart;

template <>
struct XPart<__nv_bfloat16> {
  uint32_t w[16];
  __device__ void load(const uint8_t* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  }
  __device__ float get(int j) const {
    return __uint_as_float(j % 2 ? (w[j / 2] & 0xffff0000u) : (w[j / 2] << 16));
  }
};

template <>
struct XPart<float> {
  float f[32];
  __device__ void load(const uint8_t* p) { load_f(reinterpret_cast<const float*>(p), f); }
  __device__ float get(int j) const { return f[j]; }
};

// Whether the MMAs read x straight from the raw stage: bf16 x without the
// fused norm is its own bf16 tile, in the same padded layout as sm.as.
template <typename XT>
__device__ __forceinline__ bool x_in_place(const Params& p) {
  return std::is_same<XT, __nv_bfloat16>::value && p.inv == nullptr;
}

// k-tile s's raw stage -> the bf16 weight tile and (unless x_in_place) the
// bf16 x tile (fused norm applied; rows >= T zero), with, in nosub mode,
// each x row's half sums in k order and the scale rows times -8 (exact)
template <class F, typename XT>
__device__ __forceinline__ void stage(const Params& p, int s, int m0, const uint8_t* raw,
                                      const Smem<F, XT>& sm, float sub, bool correct) {
  using L = Layout<F, XT>;
  F::dequant(raw, sm.bs, sub);
  const bool in_place = x_in_place<XT>(p);
  if (in_place && !correct) return;
  const int xr = threadIdx.x >> 1, xh = threadIdx.x & 1;
  XPart<XT> xv;
  xv.load(raw + L::kW + L::kScl + xr * L::kXRow + xh * 32 * (int)sizeof(XT));
  uint32_t packed[16];
  if (in_place) {
    if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
#pragma unroll
      for (int i = 0; i < 16; ++i) packed[i] = xv.w[i];
    }
  } else {
    const bool valid = m0 + xr < p.T;
    const float inv = (p.inv != nullptr && valid) ? p.inv[m0 + xr] : 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      float v0 = xv.get(j), v1 = xv.get(j + 1);
      if (p.inv != nullptr) {
        const size_t k = (size_t)s * BK + xh * 32 + j;
        v0 = valid ? __fmul_rn(p.nw[k], __fmul_rn(v0, inv)) : 0.f;
        v1 = valid ? __fmul_rn(p.nw[k + 1], __fmul_rn(v1, inv)) : 0.f;
      }
      packed[j / 2] = pack_bf16(v0, v1);
    }
    uint4* d = reinterpret_cast<uint4*>(sm.as + xr * kApad + xh * 32);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2], packed[4 * q + 3]);
  }
  if (correct) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sum += __uint_as_float(packed[i] << 16);
      sum += __uint_as_float(packed[i] & 0xffff0000u);
    }
    sm.bsum[xr * 2 + xh] = sum;
    if (threadIdx.x < 2 * BN / 4) {
      const float4 v = reinterpret_cast<const float4*>(raw + L::kW)[threadIdx.x];
      reinterpret_cast<float4*>(sm.scl)[threadIdx.x] =
          make_float4(-8.f * v.x, -8.f * v.y, -8.f * v.z, -8.f * v.w);
    }
  }
}

// acc += the staged k-tile's product and, in nosub mode, its correction.
// kFull: all BM rows are below T, so no fragment is skipped and the k16
// steps are one branch-free block that ptxas can schedule as a whole.
template <bool kFull, class F, typename XT>
__device__ __forceinline__ void mma_tile(const Smem<F, XT>& sm, const __nv_bfloat16* as,
                                         bool correct, int rows, float (&acc)[kMI][kNI][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // warp tile: rows wm*64.., columns wn*32..
#pragma unroll
  for (int kp = 0; kp < BK / 32; ++kp) {  // pairs of k16 steps
    uint32_t bf[2][kNI][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, sm.bs + ((2 * kp + q) * 16 + (lane & 15)) * kBpad + wn * 32 +
                                  nj * 16 + (lane >> 4) * 8);
        bf[q][2 * nj][0] = r4[0]; bf[q][2 * nj][1] = r4[1];
        bf[q][2 * nj + 1][0] = r4[2]; bf[q][2 * nj + 1][1] = r4[3];
      }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      if (!kFull && wm * 64 + mi * 16 >= rows) continue;  // all rows past T: warp-uniform
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldmatrix_x4(a[q], as + (wm * 64 + mi * 16 + (lane & 15)) * kApad + (2 * kp + q) * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {  // 32 products in the tensor core, then f32 adds
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a[0], bf[0][ni][0], bf[0][ni][1]);
        mma_bf16(d, a[1], bf[1][ni][0], bf[1][ni][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
      }
    }
  }
  if (!correct) return;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  float2 bsum[kMI][2];  // the 32-row block sums (lo, hi) of the fragment rows
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bsum[mi][h] =
          *reinterpret_cast<const float2*>(sm.bsum + 2 * (wm * 64 + mi * 16 + g + 8 * h));
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int col = wn * 32 + ni * 8 + 2 * tq;
    const float2 lo = *reinterpret_cast<const float2*>(sm.scl + col);
    const float2 hi = *reinterpret_cast<const float2*>(sm.scl + BN + col);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* a2 = acc[mi][ni] + 2 * h;
        a2[0] = fmaf(bsum[mi][h].y, hi.x, fmaf(bsum[mi][h].x, lo.x, a2[0]));
        a2[1] = fmaf(bsum[mi][h].y, hi.y, fmaf(bsum[mi][h].x, lo.y, a2[1]));
      }
  }
}

template <class F, typename XT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) dq_tile_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem<F, XT> sm(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int nsb = p.K / BK;
  const int s_begin = blockIdx.y * p.sb_per_split;
  const int s_end = min(nsb, s_begin + p.sb_per_split);
  const float sub = F::kNibbles && p.mode == kSub ? 8.f : 0.f;
  const bool correct = F::kNibbles && p.mode == kNosubCorrect;  // Q80: compiled out
  const int rows = p.T - m0;  // valid rows of this M tile (may exceed BM)

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // k-tile s_begin + i is copied into raw stage i % 2 one k-tile ahead. In
  // iteration i: wait for k-tile i's copy, barrier (k-tile i - 1's MMAs are
  // done, so its raw stage and the staged tiles are free), start k-tile
  // i + 1's copy into that raw stage, stage k-tile i, barrier, MMAs.
  const bool in_place = x_in_place<XT>(p);
  if (s_begin < s_end) load_stage<F, XT, kVec>(p, s_begin, n0, m0, sm.raw(0));
  cp_async_commit();
  for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < s_end) load_stage<F, XT, kVec>(p, s + 1, n0, m0, sm.raw((i + 1) & 1));
    cp_async_commit();
    const uint8_t* raw = sm.raw(i & 1);
    stage<F, XT>(p, s, m0, raw, sm, sub, correct);
    __syncthreads();
    const __nv_bfloat16* as = in_place ? reinterpret_cast<const __nv_bfloat16*>(
                                             raw + Layout<F, XT>::kW + Layout<F, XT>::kScl)
                                       : sm.as;
    if (rows >= BM)
      mma_tile<true>(sm, as, correct, rows, acc);
    else
      mma_tile<false>(sm, as, correct, rows, acc);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, tq = lane & 3;
  float* dst = p.dst + (size_t)blockIdx.y * p.T * p.O;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (r >= p.T) continue;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
        float* o = dst + (size_t)r * p.O + col;
        if (col + 1 < p.O && (p.O & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        } else {
          if (col < p.O) o[0] = acc[mi][ni][2 * h];
          if (col + 1 < p.O) o[1] = acc[mi][ni][2 * h + 1];
        }
      }
    }
  }
}

template <class F, typename XT, bool kVec>
int launch(const Params& p, dim3 grid, cudaStream_t st) {
  auto kernel = dq_tile_kernel<F, XT, kVec>;
  const int smem = Layout<F, XT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return 0;
}

// Launch the tile (and the split-K sum when ksplit > 1). p.dst is ignored:
// the kernel writes `partials` [ksplit, T, O] or, unsplit, `out` [T, O].
// x must be 16-byte aligned (the wrapper guarantees it); K % 64 == 0.
template <class F>
int run(Params p, int x_f32, int ksplit, float* partials, float* out, cudaStream_t st) {
  if (p.T < 1 || p.K % BK || ksplit < 1 || p.sb_per_split < 1 ||
      (reinterpret_cast<uintptr_t>(p.x) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = p.O % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.w) | reinterpret_cast<uintptr_t>(p.s0) |
                     reinterpret_cast<uintptr_t>(p.s1 ? p.s1 : p.s0)) % 16) == 0;
  p.dst = ksplit > 1 ? partials : out;
  const dim3 grid((p.O + BN - 1) / BN, ksplit, (p.T + BM - 1) / BM);
  int rc;
  if (x_f32)
    rc = vec ? launch<F, float, true>(p, grid, st) : launch<F, float, false>(p, grid, st);
  else
    rc = vec ? launch<F, __nv_bfloat16, true>(p, grid, st)
             : launch<F, __nv_bfloat16, false>(p, grid, st);
  if (rc != 0) return rc;
  if (ksplit > 1) sum_splits(partials, ksplit, (size_t)p.T * p.O, out, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
}  // namespace dllama
