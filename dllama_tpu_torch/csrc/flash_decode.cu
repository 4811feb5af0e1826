// Flash-decode attention for Hopper (sm_90a), split over the sequence.
//
// Replaces the TPU kernel dllama_tpu/ops/flash_decode.py::_kernel (K4) in
// both launch forms of its _launch: the solo form (flash_decode_attention,
// one sequence of T <= 16 query rows) and the batched form
// (flash_decode_attention_batched, B sequences of one token each). Online-
// softmax GQA decode attention over each sequence's own live cache prefix,
// reading the stacked cache [L, B, S, kv, hd] in place at `layer` (the solo
// cache [L, S, kv, hd] is the B = 1 case).
//
// Function: for sequence b and query row r = t * group + g of kv head h
// (query head h * group + g), out = softmax_n(q . k_n * scale) . v_n over
// cache positions n <= pos[b] + t, with scale = rsqrt(hd) (passed in by the
// wrapper), masked scores -1e30, everything in f32; bf16, f32 and
// float8_e4m3fn caches are upcast to f32. pos[b] comes from a device int32
// vector (batched) or a host int (solo), clamped into [0, S - 1].
//
// What bounds it on the H100: bytes — 2 * (pos + T) * kv * hd cache elements
// per layer, sequence and token (4.1 MB for a bf16 Llama-3-8B layer at pos
// 1000, about 1.2 us at 3.35 TB/s, below the card's launch latency), with ~4
// flops per cache element.
//
// Design: flash-decoding. The TPU walks 256-position blocks in order on one
// core; here each sequence's live prefix is cut into chunks and the grid is
// (kv, n_split, B). Each row plans its own chunks from its own live length
// (ops/flash_decode.py split_plan: min(ceil(live / 32), max_split) chunks of
// ceil(live / chunks) positions, max_split from the host so that B * kv *
// max_split blocks give every SM two), so a sequence's arithmetic depends on
// its own position and B alone, never on its neighbours. The grid's n_split
// covers the longest row the host's upper bound allows; a block whose chunk
// starts at or past its row's live length writes the empty partial
// (-1e30, 0, 0) and leaves. The grid depends on B, the cache shape and the
// host bound only, never on a row's position.
// A block of 4 warps streams its chunk through shared memory in 32-position
// tiles of K and V with cp.async (3 stages; neighbouring threads copy
// neighbouring 16 bytes of one cache row; rows past the chunk are
// zero-filled, never read).
// All T * group query rows of the kv head share each tile: warp w owns rows
// w, w + 4, ... (1, 2 or 4 per warp, as few as cover the rows, up to 16 a
// pass; more rows take more passes over the chunk) and keeps their
// online-softmax state (m, l, acc) in registers. Scores: lane n scores position n of the tile from its K row in
// shared memory (rows padded by 16 bytes, so the lanes' 16-byte reads hit
// distinct banks). Values: the probabilities go to the lanes by shuffle and
// each lane accumulates the dims lane, lane + 32, ... of the V rows.
// With one chunk in the grid the block writes acc / l. Otherwise each block
// writes its partial (m, l, acc) to f32 scratch, and the last block of a
// (sequence, kv head) to arrive (arrival counter + __threadfence) merges
// its partials in split order 0..n_split-1 and resets its counter to 0: the
// result does not depend on the order the blocks ran in. An empty partial
// weighs exp(-1e30 - M) = 0 and adds exact zeros, so trailing empty chunks
// leave a row's bits as they are: a row gives the same bits whatever grid
// the host bound picks. A chunk whose positions all lie past pos + t gives
// row t the same empty partial.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerPass = kWarps * 4;       // query rows staged at once (4 a warp)
constexpr int kTile = 32;                         // positions per shared-memory tile
constexpr int kStages = 3;
constexpr int kPad = 16;                          // bytes after each cache row in smem
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;       // [B, T, H, hd] f32 or bf16 (act_bf16)
  const void* kc;      // [L, B, S, kv, hd]
  const void* vc;
  void* out;           // [B, T, H, hd] in q's dtype
  float* part_acc;     // [B, kv, n_split, R, hd]
  float* part_ml;      // [B, kv, n_split, R, 2]
  int* counters;       // [B * kv], zero between launches
  const int* pos_dev;  // [B] int32 on the device, or null: every row at `pos`
  int B, T, H, hd, S, kv, pos, layer, n_split, max_split, act_bf16;
  float scale;
};

__device__ __forceinline__ float load_act(const Args& a, size_t i) {
  return a.act_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                    : static_cast<const float*>(a.q)[i];
}

// out[i] = v in q's dtype (bf16: round to nearest even, as torch's cast)
__device__ __forceinline__ void store_out(const Args& a, size_t i, float v) {
  if (a.act_bf16)
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.out)[i] = v;
}

// RPW: query rows a warp holds in registers (1, 2 or 4: the fewest that
// cover T * group rows, up to 16 a pass); DPL: output dims a lane owns
// (hd <= 32 * DPL). Fitting both to the launch keeps dead rows and dims out
// of the unrolled loops.
template <typename CacheT, int RPW, int DPL>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Args a) {
  constexpr int kRowsPerPass = kWarps * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd, group = a.H / a.kv, R = a.T * group;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int hb = b * a.kv + h;  // this (sequence, kv head)'s partials and counter
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_bytes = hd * (int)sizeof(CacheT);
  const int srow = row_bytes + kPad;               // smem bytes per cache row
  const int tile_bytes = kTile * srow;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRowsPerPass, hd]
  unsigned char* ring = smem_raw + (size_t)kMaxRowsPerPass * hd * sizeof(float);

  // this row's own split plan (n_chunks): chunks of ceil(live / n)
  const int pos = min(max(a.pos_dev != nullptr ? a.pos_dev[b] : a.pos, 0), a.S - 1);
  const int live = min(pos + a.T, a.S);
  // clamped to the grid: a host bound below this row's live length still
  // covers its whole prefix (a right bound never reaches the clamp)
  const int n_chunks = max(1, min(min((live + kTile - 1) / kTile, a.max_split), a.n_split));
  const int chunk = (live + n_chunks - 1) / n_chunks;
  const int c0 = split * chunk;
  const int c1 = min(live, c0 + chunk);
  const int ntile = c0 < live ? (c1 - c0 + kTile - 1) / kTile : 0;
  const size_t gstride = (size_t)a.kv * hd;  // cache elements per position
  const size_t slab = ((size_t)a.layer * a.B + b) * a.S * gstride + (size_t)h * hd;
  const CacheT* kbase = static_cast<const CacheT*>(a.kc) + slab;
  const CacheT* vbase = static_cast<const CacheT*>(a.vc) + slab;
  const size_t qrow0 = (size_t)b * a.T;  // this sequence's first query row
  constexpr int kVec = Vec16<CacheT>::n;
  const int row_chunks = row_bytes / 16;

  // tile i of the chunk -> stage: K rows then V rows, 16 bytes a thread
  auto issue = [&](int i) {
    unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
    unsigned char* vs = ks + tile_bytes;
    const int n0 = c0 + i * kTile;
    for (int c = threadIdx.x; c < kTile * row_chunks; c += kThreads) {
      const int n = c / row_chunks, part = c - n * row_chunks;
      const bool ok = n0 + n < c1;
      const size_t off = ok ? (size_t)(n0 + n) * gstride : 0;
      const int src = ok ? 16 : 0;
      cp_async16(ks + n * srow + part * 16,
                 reinterpret_cast<const unsigned char*>(kbase + off) + part * 16, src);
      cp_async16(vs + n * srow + part * 16,
                 reinterpret_cast<const unsigned char*>(vbase + off) + part * 16, src);
    }
  };

  if (ntile == 0) {  // a chunk past this row's live prefix: the empty partial
    for (int i = threadIdx.x; i < R * hd; i += kThreads) {
      const int row = i / hd, d = i - row * hd;
      const size_t pr = ((size_t)hb * a.n_split + split) * R + row;
      a.part_acc[pr * hd + d] = 0.f;
      if (d == 0) {
        a.part_ml[pr * 2] = -1e30f;
        a.part_ml[pr * 2 + 1] = 0.f;
      }
    }
  }
  for (int r0 = 0; ntile > 0 && r0 < R; r0 += kRowsPerPass) {
    const int rp = min(kRowsPerPass, R - r0);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {  // the first tiles' loads fly while q is staged
      if (i < ntile) issue(i);
      cp_async_commit();
    }
    for (int i = threadIdx.x; i < kRowsPerPass * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float v = 0.f;
      if (r < rp) {
        const int row = r0 + r, t = row / group, g = row - t * group;
        v = load_act(a, ((qrow0 + t) * a.H + (size_t)h * group + g) * hd + d);
      }
      qs[i] = v;
    }
    // this warp's rows: r0 + warp + kWarps * j, j < nr
    const int nr = rp > warp ? (rp - warp + kWarps - 1) / kWarps : 0;
    int qpos[RPW];  // the last position each row attends to
#pragma unroll
    for (int j = 0; j < RPW; ++j) qpos[j] = pos + (r0 + warp + kWarps * j) / group;

    float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      m[j] = -1e30f;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
    }

    for (int i = 0; i < ntile; ++i) {
      if (i + kStages - 1 < ntile) issue(i + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();  // tile i (and, on the first pass, qs) visible to all
      const unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
      const unsigned char* vs = ks + tile_bytes;
      const int n0 = c0 + i * kTile;
      const int nk = min(kTile, c1 - n0);
      const int key = n0 + lane;

      // four independent partial sums per row: one warp per row has no
      // other warp on its scheduler to hide an FMA chain's latency
      float s4[RPW][4];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s4[j][e] = 0.f;
      }
      const unsigned char* krow = ks + lane * srow;
#pragma unroll 2
      for (int d0 = 0; d0 < hd; d0 += kVec) {
        float kf[kVec];
        Vec16<CacheT>::unpack(*reinterpret_cast<const uint4*>(krow + d0 * sizeof(CacheT)), kf);
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          if (j < nr) {
            const float* qr = qs + (warp + kWarps * j) * hd + d0;
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              s4[j][0] = fmaf(qv.x, kf[e], s4[j][0]);
              s4[j][1] = fmaf(qv.y, kf[e + 1], s4[j][1]);
              s4[j][2] = fmaf(qv.z, kf[e + 2], s4[j][2]);
              s4[j][3] = fmaf(qv.w, kf[e + 3], s4[j][3]);
            }
          }
        }
      }
      float s[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) s[j] = (s4[j][0] + s4[j][1]) + (s4[j][2] + s4[j][3]);
      float p[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        p[j] = 0.f;
        if (j >= nr) continue;
        const bool valid = lane < nk && key <= qpos[j];
        const float sc = valid ? s[j] * a.scale : -1e30f;
        const float m_new = fmaxf(m[j], warp_max(sc));
        p[j] = valid ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m[j] - m_new);
        l[j] = l[j] * alpha + warp_sum(p[j]);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[j][e] *= alpha;
      }
#pragma unroll 4
      for (int n = 0; n < nk; ++n) {
        const CacheT* vrow = reinterpret_cast<const CacheT*>(vs + n * srow);
        float vv[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          vv[e] = d < hd ? dllama::to_f32(vrow[d]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float pn = __shfl_sync(kFull, p[j], n);
          if (j < nr) {
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[j][e] = fmaf(pn, vv[e], acc[j][e]);
          }
        }
      }
      __syncthreads();  // stage i % kStages is refilled next
    }

    // this pass's rows: the answer (one chunk) or the block's partial
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      if (j >= nr) continue;
      const int row = r0 + warp + kWarps * j;
      if (a.n_split == 1) {
        const int t = row / group, g = row - t * group;
        const size_t o = ((qrow0 + t) * a.H + (size_t)h * group + g) * hd;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) store_out(a, o + d, acc[j][e] / l[j]);
        }
      } else {
        const size_t pr = ((size_t)hb * a.n_split + split) * R + row;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) a.part_acc[pr * hd + d] = acc[j][e];
        }
        if (lane == 0) {
          a.part_ml[pr * 2] = m[j];
          a.part_ml[pr * 2 + 1] = l[j];
        }
      }
    }
    __syncthreads();  // qs is rewritten by the next pass
  }
  if (a.n_split == 1) return;

  // the last block of this (sequence, kv head) to arrive merges the partials
  __shared__ int is_last;
  __syncthreads();  // every partial of this block written
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(a.counters + hb, 1) == a.n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  constexpr int kMergeRows = kMaxRowsPerPass;
  float* fs = reinterpret_cast<float*>(ring);         // [n_split, kMergeRows]: m, then weights
  float* lsm = fs + (size_t)a.n_split * kMergeRows;   // [n_split, kMergeRows]: l
  float* ls = lsm + (size_t)a.n_split * kMergeRows;   // [kMergeRows]: sum of weighted l
  const size_t hbase = (size_t)hb * a.n_split * R;
  for (int r0 = 0; r0 < R; r0 += kMergeRows) {
    const int rp = min(kMergeRows, R - r0);
    for (int i = threadIdx.x; i < a.n_split * rp; i += kThreads) {
      const int sp = i / rp, r = i - sp * rp;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml) +
                               hbase + (size_t)sp * R + r0 + r);
      fs[sp * kMergeRows + r] = ml.x;
      lsm[sp * kMergeRows + r] = ml.y;
    }
    __syncthreads();
    if (threadIdx.x < rp) {
      const int r = threadIdx.x;
      float mx = -1e30f;
      for (int sp = 0; sp < a.n_split; ++sp) mx = fmaxf(mx, fs[sp * kMergeRows + r]);
      float lsum = 0.f;
      for (int sp = 0; sp < a.n_split; ++sp) {
        const float f = expf(fs[sp * kMergeRows + r] - mx);
        fs[sp * kMergeRows + r] = f;
        lsum = fmaf(lsm[sp * kMergeRows + r], f, lsum);
      }
      ls[r] = lsum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rp * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd, row = r0 + r;
      float v = 0.f;
#pragma unroll 16
      for (int sp = 0; sp < a.n_split; ++sp)
        v = fmaf(__ldcg(a.part_acc + (hbase + (size_t)sp * R + row) * hd + d),
                 fs[sp * kMergeRows + r], v);
      const int t = row / group, g = row - t * group;
      store_out(a, ((qrow0 + t) * a.H + (size_t)h * group + g) * hd + d, v / ls[r]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) a.counters[hb] = 0;  // ready for the next launch
}

template <typename CacheT, int RPW, int DPL>
int launch(const Args& a, cudaStream_t st) {
  const size_t ring = (size_t)kStages * 2 * kTile * (a.hd * sizeof(CacheT) + kPad);
  const size_t merge = sizeof(float) * (2 * (size_t)a.n_split * kMaxRowsPerPass + kMaxRowsPerPass);
  const size_t smem = sizeof(float) * kMaxRowsPerPass * a.hd + (ring > merge ? ring : merge);
  auto kernel = flash_decode_kernel<CacheT, RPW, DPL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.kv, a.n_split, a.B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename CacheT, int RPW>
int launch_dpl(const Args& a, cudaStream_t st) {
  if (a.hd <= 64) return launch<CacheT, RPW, 2>(a, st);
  if (a.hd <= 128) return launch<CacheT, RPW, 4>(a, st);
  return launch<CacheT, RPW, 8>(a, st);
}

template <typename CacheT>
int launch_rows(const Args& a, cudaStream_t st) {
  const int R = a.T * (a.H / a.kv);
  if (R <= kWarps) return launch_dpl<CacheT, 1>(a, st);
  if (R <= 2 * kWarps) return launch_dpl<CacheT, 2>(a, st);
  return launch_dpl<CacheT, 4>(a, st);
}

}  // namespace

// q: [B, T, H, hd], f32 (act_kind 0) or bf16 (1); caches [L, B, S, kv, hd]
// of kind 0 f32 / 1 bf16 / 2 f8; out: [B, T, H, hd] in q's dtype. hd % 16
// == 0 and hd <= 256 (checked by the wrapper). Sequence b sits at pos_dev[b]
// (device int32 [B]) or, with pos_dev null, every sequence at `pos`.
// Each row cuts its live prefix min(pos + T, S) into at most max_split
// chunks (ops/flash_decode.py n_chunks) and at most n_split; the grid is
// (kv, n_split, B). With n_split > 1, part_acc (f32
// [B, kv, n_split, T * H / kv, hd]) and part_ml (f32 [B, kv, n_split,
// T * H / kv, 2]) are scratch and counters (int32 [>= B * kv]) must be zero,
// and are left zero; launches that share the counters must not overlap.
extern "C" int dllama_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                   void* out, int B, int T, int H, int hd, int S, int kv,
                                   const void* pos_dev, int pos, int layer, float scale,
                                   int act_kind, int cache_kind, int n_split, int max_split,
                                   void* part_acc, void* part_ml, void* counters,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k_cache, v_cache, out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<int*>(counters),
               static_cast<const int*>(pos_dev), B, T, H, hd, S, kv, pos, layer, n_split,
               max_split, act_kind, scale};
  switch (cache_kind) {
    case 0: return launch_rows<float>(a, st);
    case 1: return launch_rows<__nv_bfloat16>(a, st);
    case 2: return launch_rows<dllama::F8>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
