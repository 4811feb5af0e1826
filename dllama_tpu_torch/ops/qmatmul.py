"""Q40 and Q80 dequant-matmuls: the hand-written CUDA kernels' wrappers, their
plain versions, the fused-rmsnorm epilogue, and the packed weight layouts.

Layouts — the JAX package's, byte for byte, so carrying weights across is a
copy. A Q40 matrix ``[K, O]`` is a ``uint8 [K/2, O]`` plane (O contiguous)
plus two ``f32 [K/64, O]`` scale planes. Byte ``32s + j`` holds input row
``64s + j`` in its low nibble (scale ``s_lo[s]``) and row ``64s + 32 + j`` in
its high nibble (``s_hi[s]``). Nibbles store ``q + 8``; dequant is
``(q - 8) * delta``, the reference's own Q40 math
(`distributed-llama/src/quants.cpp:166-180`), so repacking a published Q40 file
is lossless. A Q80 matrix is ``int8 [K, O]`` plus one ``f32 [K/32, O]`` scale
plane (the reference's 32-value blocks along K). K is padded up to
``K_MULTIPLE[kind]`` with zero quants and zero scales; the padded rows
multiply zero-padded activation columns and add exactly nothing.

The product (both routes): ``out[T, O] f32 = sum_k bf16(x) * bf16(dequant(W))``
accumulated in f32. Under ``nosub`` (the Q40 default, ``DLLAMA_Q40_NOSUB``)
the dequant drops the ``- 8`` and the exact recentering term
``8 * (blocksum_lo(x) @ s_lo + blocksum_hi(x) @ s_hi)`` — f32 sums of the
bf16-rounded activation over each 32-row block — is subtracted at the end;
``nosub`` rounds ``q * delta`` to bf16, not ``(q - 8) * delta``, so the two
settings differ in their last bits.

The fused-norm epilogue (``DLLAMA_FUSE_NORM``, :func:`qmatmul_norm`): the
kernel takes the raw activation, the per-row ``rmsnorm_inv`` and the norm
weight, and normalizes each staged element as ``bf16(w * (x * inv))`` —
ops.norms.rmsnorm's own f32 order — so the result is bit-equal to rmsnorm
followed by the plain product.

``q40_matmul``/``q80_matmul`` launch the CUDA kernels (``csrc/q40_matmul.cu``,
``csrc/q80_matmul.cu``) for CUDA tensors and run ``q40_matmul_ref``/
``q80_matmul_ref`` for CPU tensors; there is no other route. On the card,
up to :data:`GEMV_MAX_T` activation rows take each kind's decode GEMV — one
launch a call, K split by :func:`gemv_plan` and summed in the kernel — and
more take the tensor-core prefill tile both share (``csrc/dq_tile.cuh``):
:func:`q40_plan` and :func:`q80_plan` decide, :func:`tile_plan` cuts the
tile's grid.

``q40_matmul_stacked``/``q80_matmul_stacked`` are the expert-indexed forms
of the decode GEMVs: one launch multiplies by the planes ``base + ids[j]``
of a stack, ``ids`` an int32 tensor the kernel reads from device memory —
the JAX package's stacked launchers with a traced index, which a
mixture-of-experts decode step needs (its experts are picked on the
device). A host index needs no kernel of its own: the planes' view
``w[i]`` goes to the plain launch (:func:`matmul_any`).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops.norms import RMS_EPS, rmsnorm_inv
from dllama_tpu_torch.quants import blocks

QK = blocks.QK  # 32 values per quantization block

#: drop the nibble recentering in the dequant and subtract the exact
#: correction term instead — the JAX package's default numerics
Q40_NOSUB = os.environ.get("DLLAMA_Q40_NOSUB", "1") != "0"

#: input-dim padding unit per kind, as the JAX package packs it
K_MULTIPLE = {"q40": 512, "q80": 256}

#: the most activation rows the decode kernels (K1's, K3's GEMV) take; more
#: go to the tensor-core tile (``DECODE_MAX_T`` is 16, the smallest prefill
#: bucket 8)
GEMV_MAX_T = 8
#: the tile's output rows and columns per block, and input rows per k-tile
TILE_M, TILE_N, TILE_K = 128, 128, 64
#: tile blocks resident on one SM: 256 threads held to 128 registers each
#: (``__launch_bounds__``) and 83-93 KB of shared memory with bf16 x
TILE_BLOCKS_PER_SM = 2
#: a block's fixed cost beyond its k-tiles, in k-tiles (pipeline fill, stores)
_TILE_FILL = 2
#: the tile's Q40 modes (``csrc/dq_tile.cuh`` Mode)
Q40_SUB, Q40_NOSUB_CORRECT, Q40_NOSUB_RAW = 0, 1, 2
#: output columns one Q80 GEMV block covers (32 lanes x 16 columns)
_GEMV_COLS = 512
#: input rows per GEMV split unit (Q80: 8 warps x two 4-row groups; Q40: a
#: superblock)
_GEMV_UNIT = 64
#: the most staged activation values per GEMV block (64 KB of shared memory)
_GEMV_X_FLOATS = 16384


def _pad_up(n: int, multiple: int) -> int:
    return (n + multiple - 1) // multiple * multiple


def _pad_cols(x: torch.Tensor, k_padded: int) -> torch.Tensor:
    """Zero-pad the input-feature dim of activations up to the packed K."""
    if x.shape[1] != k_padded:
        x = torch.nn.functional.pad(x, (0, k_padded - x.shape[1]))
    return x


# ---------------------------------------------------------------------------
# QuantTensor: the weight leaf for quantized matrices
# ---------------------------------------------------------------------------

@dataclass
class QuantTensor:
    """A [in, out] matrix stored block-quantized for the kernels.

    For q40, ``w`` is the packed uint8 plane and ``s``/``s2`` the even/odd
    32-block scale planes; for q80, ``w`` is int8 and ``s2`` empty. Planes are
    numpy arrays while staged on the host and torch tensors once placed
    (:meth:`to`). A leading layer axis on every plane stacks layers;
    :meth:`layer` takes one as a view.

    ``k_logical`` is the pre-padding input dim (0 = no padding).
    """

    w: object
    s: object
    s2: object
    kind: str = "q40"
    k_logical: int = 0

    @property
    def k_padded(self) -> int:
        return self.w.shape[-2] * (2 if self.kind == "q40" else 1)

    @property
    def in_features(self) -> int:
        return self.k_logical or self.k_padded

    @property
    def out_features(self) -> int:
        return self.w.shape[-1]

    def layer(self, i: int) -> "QuantTensor":
        """Layer ``i`` of a stacked tensor, as views of the planes."""
        return QuantTensor(self.w[i], self.s[i], self.s2[i], self.kind, self.k_logical)

    def to(self, device) -> "QuantTensor":
        """The planes as contiguous torch tensors on ``device``."""
        def put(a):
            if isinstance(a, np.ndarray):
                a = np.ascontiguousarray(a)
                a = torch.from_numpy(a if a.flags.writeable else a.copy())
            return a.to(device).contiguous()

        return QuantTensor(put(self.w), put(self.s), put(self.s2), self.kind, self.k_logical)


# ---------------------------------------------------------------------------
# The fused-rmsnorm epilogue (DLLAMA_FUSE_NORM)
# ---------------------------------------------------------------------------

def norm_fusion_enabled() -> bool:
    """DLLAMA_FUSE_NORM=1: the projections that follow an rmsnorm take the
    raw activation and normalize each tile in the kernel (:func:`qmatmul_norm`)
    instead of reading a normalized copy. Read per call, so a run can flip
    it; off by default, as in the JAX package."""
    return os.environ.get("DLLAMA_FUSE_NORM", "0") == "1"


def norm_fusion_engages(w) -> bool:
    """The gate at one call site: the flag is on and the matrix is quantized
    (a dense matmul has no kernel to fuse into)."""
    return norm_fusion_enabled() and isinstance(w, QuantTensor)


def _bf16_activation(x: torch.Tensor, K: int, norm_w=None, norm_inv=None) -> torch.Tensor:
    """The kernels' activation tile as f32 values of bf16 [T, K]: ``x``
    rounded to bf16 or, with the fused-norm epilogue, ``bf16(nw * (x *
    inv))`` — ops.norms.rmsnorm's f32 tail, so fused equals unfused bit for
    bit — zero-padded to the packed K."""
    if norm_w is not None:
        x = norm_w.float() * (x.float() * norm_inv.float().reshape(-1, 1))
    return _pad_cols(x.to(torch.bfloat16), K).float()


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------

def _q40_split(xp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, K] -> the lo/hi 32-row halves of each 64-row superblock (the
    packed-nibble pairing), each [T, K/2]."""
    T, K = xp.shape
    xr = xp.reshape(T, K // 64, 64)
    return xr[:, :, :QK].reshape(T, K // 2), xr[:, :, QK:].reshape(T, K // 2)


def _q40_block_sums(xp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-block f32 activation sums, split into the even (low nibble,
    ``s_lo``) and odd (high nibble, ``s_hi``) planes, each [T, K/64]."""
    T, K = xp.shape
    xs = xp.float().reshape(T, K // QK, QK).sum(-1)
    return xs[:, 0::2], xs[:, 1::2]


def q40_dot_ref(xb: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                s_hi: torch.Tensor, sub: float) -> torch.Tensor:
    """``xb [T, K] @ bf16((nibble - sub) * delta)`` in f32, where ``xb``
    holds bf16 values: the dot both Q40 kernels share (a product of two bf16
    values is exact in f32, so only the summation order differs from a
    kernel)."""
    lo = (packed & 0xF).float() - sub
    hi = (packed >> 4).float() - sub
    w_lo = (lo * s_lo.repeat_interleave(QK, dim=0)).to(torch.bfloat16).float()
    w_hi = (hi * s_hi.repeat_interleave(QK, dim=0)).to(torch.bfloat16).float()
    x_lo, x_hi = _q40_split(xb)
    return x_lo @ w_lo + x_hi @ w_hi


def q40_matmul_ref(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                   s_hi: torch.Tensor, nosub: bool | None = None,
                   norm_w: torch.Tensor | None = None,
                   norm_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The Q40 kernel's function step by step in plain PyTorch: ``x [T, K] @
    dequant(packed uint8 [K/2, O]) -> [T, O]`` f32, both dot operands rounded
    to bf16 and the products summed in f32. ``norm_w [K]``/``norm_inv [T, 1]``
    (both or neither) apply the fused-norm epilogue to ``x`` first; the nosub
    correction then sums the normalized tile, as the JAX package's
    ``_q40_normed`` does."""
    if nosub is None:
        nosub = Q40_NOSUB
    xb = _bf16_activation(x, packed.shape[0] * 2, norm_w, norm_inv)
    out = q40_dot_ref(xb, packed, s_lo, s_hi, 0.0 if nosub else 8.0)
    if nosub:
        xs_lo, xs_hi = _q40_block_sums(xb)
        out = out - 8.0 * (xs_lo @ s_lo + xs_hi @ s_hi)
    return out


def q80_matmul_ref(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                   norm_w: torch.Tensor | None = None,
                   norm_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The Q80 kernel's function step by step: ``bf16(x) @ bf16(f32(int8 w
    [K, O]) * delta [K/32, O])`` accumulated in f32, x zero-padded to the
    packed K; ``norm_w``/``norm_inv`` as in :func:`q40_matmul_ref`."""
    xb = _bf16_activation(x, w.shape[0], norm_w, norm_inv)
    wd = (w.float() * scales.repeat_interleave(QK, dim=0)).to(torch.bfloat16).float()
    return xb @ wd


def _stacked_ref(one, x: torch.Tensor, stacks: tuple, ids: torch.Tensor, base: int,
                 n_ids: int) -> torch.Tensor:
    """``[one(x_j, *plane base + ids[j] of each stack) for j]`` -> [n, T, O]
    f32, where ``one`` is a kernel's plain version; an id outside [0,
    n_ids) gives NaN, as the indexed kernels define it. No host reads: the
    planes are gathered on ``ids``' device."""
    ids = ids.reshape(-1).long()
    valid = (ids >= 0) & (ids < n_ids)
    idx = base + ids.clamp(0, n_ids - 1)
    outs = []
    for j in range(ids.shape[0]):
        xj = x[j] if x.dim() == 3 else x
        outs.append(one(xj, *(p.index_select(0, idx[j:j + 1]).squeeze(0) for p in stacks)))
    out = torch.stack(outs)
    return torch.where(valid[:, None, None], out, torch.full_like(out, float("nan")))


def q40_matmul_stacked_ref(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                           s_hi: torch.Tensor, ids: torch.Tensor, base: int = 0,
                           n_ids: int | None = None, nosub: bool | None = None) -> torch.Tensor:
    """The expert-indexed Q40 kernel's function: ``x_j @ dequant(packed[base
    + ids[j]])`` for each j -> [n, T, O] f32 (:func:`q40_matmul_ref` on
    each plane), ``x`` [T, K] shared or [n, T, K] one per j; an id outside
    [0, n_ids) (default: the planes past ``base``) gives NaN."""
    n_ids = packed.shape[0] - base if n_ids is None else n_ids
    return _stacked_ref(lambda xj, w, a, b: q40_matmul_ref(xj, w, a, b, nosub), x,
                        (packed, s_lo, s_hi), ids, base, n_ids)


def q80_matmul_stacked_ref(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                           ids: torch.Tensor, base: int = 0,
                           n_ids: int | None = None) -> torch.Tensor:
    """The expert-indexed Q80 kernel's function: ``x_j @ dequant(w[base +
    ids[j]])`` for each j -> [n, T, O] f32, as :func:`q40_matmul_stacked_ref`."""
    n_ids = w.shape[0] - base if n_ids is None else n_ids
    return _stacked_ref(q80_matmul_ref, x, (w, scales), ids, base, n_ids)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def gemv_plan(T: int, K: int, O: int, n_sm: int, per_sm: int,
              cols: int = _GEMV_COLS, row_tiles: int = 1) -> tuple[int, int]:
    """(ksplit, rows per split) for a decode GEMV (Q80's, Q40's through
    :func:`q40_plan`, K7's) whose blocks cover ``cols`` output columns of
    T <= 8 rows, ``row_tiles`` such tiles of rows side by side: split K, in
    64-row units, as far as one wave of resident blocks (``n_sm * per_sm``)
    holds the column blocks times the row tiles times the splits — a second
    wave would take as long as the first — and at least far enough that a
    block's staged activation (rows x T rounded up to a power of two) fits
    :data:`_GEMV_X_FLOATS`. Split s takes rows ``[s * rows, min((s + 1) *
    rows, K))``, so each 32-row scale block and each 64-row Q40 superblock
    lies in exactly one split."""
    tt = next(t for t in (1, 2, 4, 8) if t >= T)
    units = K // _GEMV_UNIT
    tiles = math.ceil(O / cols) * row_tiles
    want = max(n_sm * per_sm // tiles, math.ceil(K * tt / _GEMV_X_FLOATS), 1)
    per = math.ceil(units / min(units, want))
    return math.ceil(units / per), per * _GEMV_UNIT


@functools.lru_cache(maxsize=None)
def tile_plan(T: int, K: int, O: int, n_sm: int) -> tuple[int, int, int, int]:
    """(m_tiles, n_tiles, ksplit, k-tiles per split) for the tensor-core
    tile: a block per :data:`TILE_M` x :data:`TILE_N` output tile, times
    ``ksplit`` splits of K in :data:`TILE_K`-row k-tiles. Output tiles that
    fill a wave of resident blocks (:data:`TILE_BLOCKS_PER_SM` per SM) are
    not split: each split adds a [T, O] f32 partial to write and sum. Fewer
    (wo, wqkv and w2 at T = 128: 32-48 tiles for 132 SMs) are split, at most
    until they fill that wave, so that the blocks finish soonest: the fewest
    waves times (k-tiles per split + :data:`_TILE_FILL`), the fewest splits
    on a tie. Split s takes k-tiles
    ``[s * per, min((s + 1) * per, K / 64))``. A function of the shape
    alone — never of x's dtype or the fused norm — so the fused and unfused
    launches sum in the same order."""
    m_tiles, n_tiles = math.ceil(T / TILE_M), math.ceil(O / TILE_N)
    nsb = K // TILE_K
    slots = n_sm * TILE_BLOCKS_PER_SM
    if m_tiles * n_tiles >= slots:
        return m_tiles, n_tiles, 1, nsb
    best = None
    for want in range(1, min(nsb, math.ceil(slots / (m_tiles * n_tiles))) + 1):
        per = math.ceil(nsb / want)
        ksplit = math.ceil(nsb / per)
        waves = math.ceil(m_tiles * n_tiles * ksplit / slots)
        cost = waves * (per + _TILE_FILL)
        if best is None or cost < best[0]:
            best = (cost, ksplit, per)
    return m_tiles, n_tiles, best[1], best[2]


#: output columns one Q40 GEMV block covers: two strips of 8 lane groups x
#: 16 columns (``wide``: K6's blocks of 8 such strips)
Q40_GEMV_COLS, Q40_GEMV_WIDE_COLS = 256, 1024


def q40_gemv_cols(wide: bool = False) -> int:
    """Output columns one Q40 GEMV block covers, whatever the row count."""
    return Q40_GEMV_WIDE_COLS if wide else Q40_GEMV_COLS


def q40_plan(T: int, K: int, O: int, n_sm: int, per_sm: int,
             wide: bool = False) -> tuple[str, int, int]:
    """(kernel, ksplit, input rows per split) for a Q40 matmul of T rows:
    the decode GEMV up to :data:`GEMV_MAX_T` rows (:func:`gemv_plan` over
    :func:`q40_gemv_cols`-column blocks, ``per_sm`` of them resident on an
    SM), the tensor-core tile beyond (:func:`tile_plan`)."""
    if T <= GEMV_MAX_T:
        return ("gemv", *gemv_plan(T, K, O, n_sm, per_sm, q40_gemv_cols(wide)))
    ksplit, per = tile_plan(T, K, O, n_sm)[2:]
    return "tile", ksplit, TILE_K * per


def q80_plan(T: int, K: int, O: int, n_sm: int, per_sm: int) -> tuple[str, int, int]:
    """(kernel, ksplit, input rows per split) for a Q80 matmul of T rows:
    the decode GEMV up to :data:`GEMV_MAX_T` rows (:func:`gemv_plan`, with
    ``per_sm`` of its blocks resident on an SM), the tensor-core tile beyond
    (:func:`tile_plan`)."""
    if T <= GEMV_MAX_T:
        return ("gemv", *gemv_plan(T, K, O, n_sm, per_sm))
    ksplit, per = tile_plan(T, K, O, n_sm)[2:]
    return "tile", ksplit, TILE_K * per


#: (C entry point, T rounded up to a power of two, its flags) -> the decode
#: kernel's blocks per SM
_gemv_occupancy: dict = {}


def occupancy(entry: str, T: int, *flags: int) -> int:
    """A decode kernel's resident blocks per SM for T <= 8 rows, from its C
    entry point ``entry`` (the CUDA occupancy calculator; cached)."""
    key = (entry, next(t for t in (1, 2, 4, 8) if t >= T), *flags)
    n = _gemv_occupancy.get(key)
    if n is None:
        n = getattr(kernels.lib(), entry)(*key[1:])
        if n <= 0:
            kernels.check(-n, f"{entry} occupancy")
        _gemv_occupancy[key] = n
    return n


def gemv_blocks_per_sm(T: int, x_f32: bool) -> int:
    """The Q80 GEMV's resident blocks per SM for T rows, from the CUDA
    occupancy calculator (cached)."""
    return occupancy("dllama_q80_gemv_blocks_per_sm", T, int(x_f32))


def q40_gemv_blocks_per_sm(T: int, wide: bool = False) -> int:
    """The Q40 GEMV's resident blocks per SM for T rows (``wide``: K6's
    blocks), from the CUDA occupancy calculator (cached): the fewer of its
    bf16 and f32 activation instances', so a fused-norm launch on f32 x
    splits K as the unfused bf16 launch does and gives its bits."""
    return occupancy("dllama_q40_gemv_blocks_per_sm", T, int(wide))


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor, K: int,
                   planes: list) -> None:
    """What every dequant-matmul kernel requires of its operands: one CUDA
    device, contiguous weight planes, and an activation ``[T, <= K]``."""
    if not all(p.is_contiguous() for p in (w, *planes)):
        raise ValueError(f"{name}: weight planes must be contiguous")
    if x.ndim != 2 or x.shape[1] > K or not 1 <= x.shape[0] <= 8 * 65535:
        raise ValueError(f"{name}: activation {tuple(x.shape)} vs packed K {K}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {w.device}")


def _kernel_activation(x: torch.Tensor, K: int, norm_w, norm_inv) -> tuple:
    """(x zero-padded to K as the kernel reads it, inv [T] f32 or None,
    norm weight [K] f32 or None). Unfused, x goes to the kernel as bf16;
    fused, it stays raw (bf16 or f32) and the kernel normalizes each tile."""
    if (norm_w is None) != (norm_inv is None):
        raise ValueError("norm_w and norm_inv come together")
    if norm_w is None:
        return _pad_cols(x.to(torch.bfloat16), K).contiguous(), None, None
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused-norm activation must be bf16 or f32, got {x.dtype}")
    if norm_w.shape != (x.shape[1],) or norm_inv.numel() != x.shape[0]:
        raise ValueError(f"norm operands {tuple(norm_w.shape)}, {tuple(norm_inv.shape)} "
                         f"vs activation {tuple(x.shape)}")
    inv = norm_inv.float().reshape(-1).contiguous()
    nw = _pad_cols(norm_w.float().reshape(1, -1), K).reshape(K).contiguous()
    return _pad_cols(x, K).contiguous(), inv, nw


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _split_outputs(T: int, O: int, ksplit: int, device) -> tuple:
    """(out [T, O] f32, partials [ksplit, T, O] f32 — ``out`` itself when
    there is one split)."""
    out = torch.empty((T, O), dtype=torch.float32, device=device)
    partials = (torch.empty((ksplit, T, O), dtype=torch.float32, device=device)
                if ksplit > 1 else out)
    return out, partials


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` at a 16-byte aligned address (the tile reads it 16 bytes at a
    time): a view at an odd offset is copied."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def q40_tile(xk: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor,
             mode: int, inv=None, nw=None) -> torch.Tensor:
    """Launch the Q40 tensor-core tile (``dllama_q40_tile``) on operands the
    wrapper has checked: ``xk`` as :func:`_kernel_activation` returns it,
    ``mode`` one of :data:`Q40_SUB`, :data:`Q40_NOSUB_CORRECT`,
    :data:`Q40_NOSUB_RAW` (K6). Counts no launch: its callers do."""
    T, K = xk.shape
    O = packed.shape[1]
    ksplit, per = tile_plan(T, K, O, kernels.sm_count(packed.device))[2:]
    xk = _aligned(xk)
    out, partials = _split_outputs(T, O, ksplit, packed.device)
    with torch.cuda.device(packed.device):
        rc = kernels.lib().dllama_q40_tile(
            xk.data_ptr(), int(xk.dtype == torch.float32), T, K, packed.data_ptr(),
            s_lo.data_ptr(), s_hi.data_ptr(), O, mode, _ptr(inv), _ptr(nw), ksplit, per,
            partials.data_ptr(), out.data_ptr(), kernels.stream_of(packed))
    kernels.check(rc, "q40 tile")
    return out


def q40_gemv(xk: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor,
             mode: int, inv=None, nw=None, wide: bool = False) -> torch.Tensor:
    """Launch the Q40 decode GEMV (``dllama_q40_gemv``, up to
    :data:`GEMV_MAX_T` rows) on operands the wrapper has checked, as
    :func:`q40_tile` does, K split by :func:`q40_plan`; ``wide``: K6's
    1024-column blocks (bf16 ``xk`` only). One CUDA launch: the last block
    of each column block adds the splits. Counts no launch: its callers do."""
    T, K = xk.shape
    O = packed.shape[1]
    per_sm = q40_gemv_blocks_per_sm(T, wide)
    _, ksplit, rows = q40_plan(T, K, O, kernels.sm_count(packed.device), per_sm, wide)
    out, partials = _split_outputs(T, O, ksplit, packed.device)
    counters = kernels.counters(packed.device, math.ceil(O / q40_gemv_cols(wide)))
    with torch.cuda.device(packed.device):
        rc = kernels.lib().dllama_q40_gemv(
            xk.data_ptr(), int(xk.dtype == torch.float32), T, K, packed.data_ptr(),
            s_lo.data_ptr(), s_hi.data_ptr(), O, mode, _ptr(inv), _ptr(nw), int(wide), ksplit,
            rows, partials.data_ptr(), counters.data_ptr(), out.data_ptr(),
            kernels.stream_of(packed))
    kernels.check(rc, "q40 GEMV")
    return out


def q40_matmul(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
               s_hi: torch.Tensor, nosub: bool | None = None,
               norm_w: torch.Tensor | None = None,
               norm_inv: torch.Tensor | None = None) -> torch.Tensor:
    """``x [T, K] @ dequant(packed uint8 [K/2, O]) -> [T, O]`` f32.

    A CUDA ``packed`` launches ``csrc/q40_matmul.cu`` — its decode GEMV or
    the tensor-core prefill tile, by T (:func:`q40_plan`); a CPU one runs
    :func:`q40_matmul_ref`. K2's correction term is computed inside the same
    kernel under ``nosub``. ``norm_w``/``norm_inv``: the fused-norm epilogue
    (see :func:`qmatmul_norm`)."""
    if nosub is None:
        nosub = Q40_NOSUB
    if packed.device.type == "cpu":
        return q40_matmul_ref(x, packed, s_lo, s_hi, nosub, norm_w, norm_inv)
    if packed.device.type != "cuda":
        raise ValueError(f"q40_matmul: unsupported device {packed.device}")
    K2, O = packed.shape
    K = 2 * K2
    if packed.dtype != torch.uint8 or s_lo.dtype != torch.float32 or s_hi.dtype != torch.float32:
        raise TypeError("q40_matmul: want uint8 packed and f32 scale planes")
    if s_lo.shape != (K // 64, O) or s_hi.shape != (K // 64, O) or K % 64:
        raise ValueError(f"q40_matmul: planes {tuple(packed.shape)}, "
                         f"{tuple(s_lo.shape)}, {tuple(s_hi.shape)} disagree")
    check_operands("q40_matmul", x, packed, K, [s_lo, s_hi])
    xk, inv, nw = _kernel_activation(x, K, norm_w, norm_inv)
    launch = q40_gemv if xk.shape[0] <= GEMV_MAX_T else q40_tile
    out = launch(xk, packed, s_lo, s_hi, Q40_NOSUB_CORRECT if nosub else Q40_SUB, inv, nw)
    kernels.launches["q40_matmul"] += 1
    return out


def q80_matmul(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
               norm_w: torch.Tensor | None = None,
               norm_inv: torch.Tensor | None = None) -> torch.Tensor:
    """``x [T, K] @ dequant(w int8 [K, O], scales f32 [K/32, O]) -> [T, O]``
    f32. A CUDA ``w`` launches ``csrc/q80_matmul.cu`` — its decode GEMV or
    the tensor-core prefill tile, by T (:func:`q80_plan`); a CPU one runs
    :func:`q80_matmul_ref`. ``norm_w``/``norm_inv``: the fused-norm epilogue."""
    if w.device.type == "cpu":
        return q80_matmul_ref(x, w, scales, norm_w, norm_inv)
    if w.device.type != "cuda":
        raise ValueError(f"q80_matmul: unsupported device {w.device}")
    K, O = w.shape
    if w.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("q80_matmul: want int8 quants and an f32 scale plane")
    if scales.shape != (K // QK, O) or K % 64:
        raise ValueError(f"q80_matmul: planes {tuple(w.shape)}, {tuple(scales.shape)} disagree")
    check_operands("q80_matmul", x, w, K, [scales])
    xk, inv, nw = _kernel_activation(x, K, norm_w, norm_inv)
    T = xk.shape[0]
    x_f32 = xk.dtype == torch.float32
    per_sm = gemv_blocks_per_sm(T, x_f32) if T <= GEMV_MAX_T else 0
    route, ksplit, rows = q80_plan(T, K, O, kernels.sm_count(w.device), per_sm)
    if route == "tile":
        xk = _aligned(xk)
    out, partials = _split_outputs(T, O, ksplit, w.device)
    args = (xk.data_ptr(), int(x_f32), T, K, w.data_ptr(),
            scales.data_ptr(), O, _ptr(inv), _ptr(nw), ksplit)
    with torch.cuda.device(w.device):
        if route == "gemv":
            counters = kernels.counters(w.device, math.ceil(O / _GEMV_COLS))
            rc = kernels.lib().dllama_q80_gemv(*args, rows, partials.data_ptr(),
                                               counters.data_ptr(), out.data_ptr(),
                                               kernels.stream_of(w))
        else:
            rc = kernels.lib().dllama_q80_tile(*args, rows // TILE_K, partials.data_ptr(),
                                               out.data_ptr(), kernels.stream_of(w))
    kernels.check(rc, "q80_matmul")
    kernels.launches["q80_matmul"] += 1
    return out


def _stacked_operands(name: str, x: torch.Tensor, w: torch.Tensor, K: int, planes: list,
                      ids: torch.Tensor, base: int, n_ids: int) -> tuple:
    """Check an expert-indexed launch's operands: stacks [N, ...] on one
    CUDA device, int32 ``ids`` [n] there, planes base..base + n_ids - 1 in
    the stack, and x [T, <= K] or [n, T, <= K] with T <= GEMV_MAX_T.
    Returns (x as bf16 [., T, K], its stride per j — 0 when shared — T)."""
    if w.dim() != 3 or not all(p.is_contiguous() for p in (w, *planes)):
        raise ValueError(f"{name}: want contiguous stacked planes [N, ., O], got "
                         f"{tuple(w.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.device != w.device:
        raise ValueError(f"{name}: ids must be int32 [n] on {w.device}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    if not (0 <= base and 1 <= n_ids and base + n_ids <= w.shape[0]):
        raise ValueError(f"{name}: planes {base}..{base + n_ids - 1} of a stack of "
                         f"{w.shape[0]}")
    n = ids.shape[0]
    shared = x.dim() == 2
    if x.dim() not in (2, 3) or (not shared and x.shape[0] != n) or x.shape[-1] > K:
        raise ValueError(f"{name}: activation {tuple(x.shape)} vs {n} planes of packed K {K}")
    T = x.shape[-2]
    if not 1 <= T <= GEMV_MAX_T:
        raise ValueError(f"{name}: the indexed launch takes 1..{GEMV_MAX_T} rows, got {T}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {w.device}")
    xk = x.to(torch.bfloat16)
    if xk.shape[-1] != K:
        xk = torch.nn.functional.pad(xk, (0, K - xk.shape[-1]))
    return xk.contiguous(), 0 if shared else T * K, T


def q40_matmul_stacked(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                       s_hi: torch.Tensor, ids: torch.Tensor, base: int = 0,
                       n_ids: int | None = None, nosub: bool | None = None) -> torch.Tensor:
    """``x_j @ dequant(packed[base + ids[j]])`` for every j of int32 ``ids``
    [n] -> [n, T, O] f32, over stacked planes ``packed uint8 [N, K/2, O]``,
    ``s_lo``/``s_hi`` f32 [N, K/64, O]; ``x`` [T, K] shared by every j or
    [n, T, K] one per j, T <= :data:`GEMV_MAX_T`; ids in [0, ``n_ids``)
    (default: the planes past ``base``), else output j is NaN.

    CUDA planes: one launch of the Q40 decode GEMV's expert-indexed form
    (``dllama_q40_gemv_indexed``), which reads ``ids`` from device memory —
    nothing waits for the host — with one plane's split plan, so output j
    equals :func:`q40_matmul` on the view ``packed[base + ids[j]]`` bit for
    bit. CPU planes: :func:`q40_matmul_stacked_ref`."""
    if nosub is None:
        nosub = Q40_NOSUB
    n_ids = packed.shape[0] - base if n_ids is None else n_ids
    if packed.device.type == "cpu":
        return q40_matmul_stacked_ref(x, packed, s_lo, s_hi, ids, base, n_ids, nosub)
    if packed.device.type != "cuda":
        raise ValueError(f"q40_matmul_stacked: unsupported device {packed.device}")
    if packed.dtype != torch.uint8 or s_lo.dtype != torch.float32 or s_hi.dtype != torch.float32:
        raise TypeError("q40_matmul_stacked: want uint8 packed and f32 scale planes")
    N, K2, O = packed.shape
    K = 2 * K2
    if s_lo.shape != (N, K // 64, O) or s_hi.shape != (N, K // 64, O) or K % 64:
        raise ValueError(f"q40_matmul_stacked: planes {tuple(packed.shape)}, "
                         f"{tuple(s_lo.shape)}, {tuple(s_hi.shape)} disagree")
    xk, x_stride, T = _stacked_operands("q40_matmul_stacked", x, packed, K, [s_lo, s_hi], ids,
                                        base, n_ids)
    n = ids.shape[0]
    _, ksplit, rows = q40_plan(T, K, O, kernels.sm_count(packed.device),
                               q40_gemv_blocks_per_sm(T))
    out = torch.empty((n, T, O), dtype=torch.float32, device=packed.device)
    partials = (torch.empty((n, ksplit, T, O), dtype=torch.float32, device=packed.device)
                if ksplit > 1 else out)
    counters = kernels.counters(packed.device, n * math.ceil(O / Q40_GEMV_COLS))
    with torch.cuda.device(packed.device):
        rc = kernels.lib().dllama_q40_gemv_indexed(
            xk.data_ptr(), x_stride, T, K, packed.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(),
            O, K2 * O, (K // 64) * O, ids.data_ptr(), base, n_ids, n,
            Q40_NOSUB_CORRECT if nosub else Q40_SUB, ksplit, rows, partials.data_ptr(),
            counters.data_ptr(), out.data_ptr(), kernels.stream_of(packed))
    kernels.check(rc, "q40 indexed GEMV")
    kernels.launches["q40_matmul_stacked"] += 1
    return out


def q80_matmul_stacked(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                       ids: torch.Tensor, base: int = 0,
                       n_ids: int | None = None) -> torch.Tensor:
    """``x_j @ dequant(w[base + ids[j]])`` for every j of int32 ``ids`` [n]
    -> [n, T, O] f32, over stacked planes ``w int8 [N, K, O]``, ``scales``
    f32 [N, K/32, O]; operands and ids as for :func:`q40_matmul_stacked`.
    CUDA planes: one launch of the Q80 decode GEMV's expert-indexed form
    (``dllama_q80_gemv_indexed``), output j bit-equal to
    :func:`q80_matmul` on the view ``w[base + ids[j]]``. CPU planes:
    :func:`q80_matmul_stacked_ref`."""
    n_ids = w.shape[0] - base if n_ids is None else n_ids
    if w.device.type == "cpu":
        return q80_matmul_stacked_ref(x, w, scales, ids, base, n_ids)
    if w.device.type != "cuda":
        raise ValueError(f"q80_matmul_stacked: unsupported device {w.device}")
    if w.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("q80_matmul_stacked: want int8 quants and an f32 scale plane")
    N, K, O = w.shape
    if scales.shape != (N, K // QK, O) or K % 64:
        raise ValueError(f"q80_matmul_stacked: planes {tuple(w.shape)}, "
                         f"{tuple(scales.shape)} disagree")
    xk, x_stride, T = _stacked_operands("q80_matmul_stacked", x, w, K, [scales], ids, base,
                                        n_ids)
    n = ids.shape[0]
    _, ksplit, rows = q80_plan(T, K, O, kernels.sm_count(w.device),
                               gemv_blocks_per_sm(T, False))
    out = torch.empty((n, T, O), dtype=torch.float32, device=w.device)
    partials = (torch.empty((n, ksplit, T, O), dtype=torch.float32, device=w.device)
                if ksplit > 1 else out)
    counters = kernels.counters(w.device, n * math.ceil(O / _GEMV_COLS))
    with torch.cuda.device(w.device):
        rc = kernels.lib().dllama_q80_gemv_indexed(
            xk.data_ptr(), x_stride, T, K, w.data_ptr(), scales.data_ptr(), O, K * O,
            (K // QK) * O, ids.data_ptr(), base, n_ids, n, ksplit, rows, partials.data_ptr(),
            counters.data_ptr(), out.data_ptr(), kernels.stream_of(w))
    kernels.check(rc, "q80 indexed GEMV")
    kernels.launches["q80_matmul_stacked"] += 1
    return out


def _quant_matmul(x: torch.Tensor, qt: QuantTensor, norm_w=None, norm_inv=None):
    if qt.kind == "q40":
        return q40_matmul(x, qt.w, qt.s, qt.s2, norm_w=norm_w, norm_inv=norm_inv)
    if qt.kind == "q80":
        return q80_matmul(x, qt.w, qt.s, norm_w=norm_w, norm_inv=norm_inv)
    raise ValueError(f"unknown QuantTensor kind {qt.kind!r}")


def qmatmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` through the kernel of ``qt.kind``; the output dtype
    follows ``x``, accumulation is f32."""
    return _quant_matmul(x, qt).to(x.dtype)


def qmatmul_norm(x: torch.Tensor, norm_w: torch.Tensor, qt: QuantTensor,
                 eps: float = RMS_EPS) -> torch.Tensor:
    """``rmsnorm(x, norm_w) @ dequant(qt)`` with the norm fused into the
    kernel as an epilogue on each activation tile: the kernel reads the raw
    activation and the per-row :func:`rmsnorm_inv`, never a normalized copy.
    Bit-equal to the unfused composition — the same f32 products in the same
    order, one bf16 rounding."""
    return _quant_matmul(x, qt, norm_w, rmsnorm_inv(x, eps)).to(x.dtype)


def qmatmul_stacked(x: torch.Tensor, qt: QuantTensor, ids: torch.Tensor, base: int = 0,
                    n_ids: int | None = None) -> torch.Tensor:
    """``x_j @ dequant(qt[base + ids[j]])`` -> [n, T, O] through the
    expert-indexed kernel of ``qt.kind`` (``qt`` a stack [N, ...]); the
    output dtype follows ``x``."""
    if not isinstance(qt, QuantTensor):
        raise TypeError(f"a device index selects from a QuantTensor stack, got {type(qt)}")
    if qt.kind == "q40":
        out = q40_matmul_stacked(x, qt.w, qt.s, qt.s2, ids, base, n_ids)
    elif qt.kind == "q80":
        out = q80_matmul_stacked(x, qt.w, qt.s, ids, base, n_ids)
    else:
        raise ValueError(f"unknown QuantTensor kind {qt.kind!r}")
    return out.to(x.dtype)


def matmul_any(x: torch.Tensor, w, index=None, base: int = 0) -> torch.Tensor:
    """``x @ w`` where w is a dense tensor or a QuantTensor. Mixed dense
    dtypes promote like jnp (bf16 @ f16 -> f32).

    ``index`` selects from a stack ``w`` [N, ...], as the JAX package's
    ``matmul_any(x, w, layer)``: a host int takes the view ``w[index]``; an
    int32 tensor [n] on the device gives ``x_j @ w[base + index[j]]`` ->
    [n, T, O] (``x`` [T, K] or [n, T, K]) through the expert-indexed
    kernels, without reading it back (a QuantTensor stack only)."""
    if isinstance(index, int):
        w = w.layer(index) if isinstance(w, QuantTensor) else w[index]
    elif index is not None:
        return qmatmul_stacked(x, w, index, base)
    if isinstance(w, QuantTensor):
        return qmatmul(x, w)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def slice_to_in_features(h: torch.Tensor, w) -> torch.Tensor:
    """Trim a gathered activation down to ``w``'s (packed) input width.
    Under tensor parallelism the up-projections lane-pad their output axis
    (``parallel.quant_tp``); where the down-projection's packed input is
    narrower, the extra gathered columns are exact zeros and dropping them
    is exact. No-op when the widths agree."""
    w_in = w.k_padded if isinstance(w, QuantTensor) else w.shape[-2]
    return h[..., :w_in] if h.shape[-1] > w_in else h


# ---------------------------------------------------------------------------
# Packing (host-side, numpy)
# ---------------------------------------------------------------------------

def pack_q40(quants: np.ndarray, deltas: np.ndarray, device=None) -> QuantTensor:
    """Build the kernel layout from unpacked quants ``int [K, O]`` in -8..7
    and per-block deltas ``[K/32, O]`` (block = 32 consecutive input rows).
    K is padded up to ``K_MULTIPLE['q40']`` (zero quants + zero scales).
    ``device=None`` keeps the planes as host numpy arrays."""
    K, O = quants.shape
    if K % 64:
        raise ValueError(f"q40 kernel needs in_features % 64 == 0, got {K}")
    kp = _pad_up(K, K_MULTIPLE["q40"])
    if kp != K:
        quants = np.concatenate([quants, np.zeros((kp - K, O), quants.dtype)], axis=0)
        deltas = np.concatenate([deltas, np.zeros(((kp - K) // QK, O), np.float32)], axis=0)
    u = (quants.astype(np.int16) + 8).astype(np.uint8)
    ur = u.reshape(kp // 64, 2, QK, O)
    packed = (ur[:, 0] | (ur[:, 1] << 4)).reshape(kp // 2, O)
    d = deltas.astype(np.float32).reshape(kp // 64, 2, O)
    qt = QuantTensor(w=np.ascontiguousarray(packed), s=d[:, 0].copy(),
                     s2=d[:, 1].copy(), kind="q40", k_logical=K)
    return qt if device is None else qt.to(device)


def pack_q80(quants: np.ndarray, deltas: np.ndarray, device=None) -> QuantTensor:
    """int8 quants [K, O] + per-block deltas [K/32, O] -> kernel layout.
    K is padded up to ``K_MULTIPLE['q80']`` like ``pack_q40``."""
    K, O = quants.shape
    if K % QK:
        raise ValueError(f"q80 needs in_features % {QK} == 0, got {K}")
    kp = _pad_up(K, K_MULTIPLE["q80"])
    if kp != K:
        quants = np.concatenate([quants, np.zeros((kp - K, O), quants.dtype)], axis=0)
        deltas = np.concatenate([deltas, np.zeros(((kp - K) // QK, O), np.float32)], axis=0)
    qt = QuantTensor(w=np.ascontiguousarray(quants.astype(np.int8)),
                     s=np.ascontiguousarray(deltas.astype(np.float32)),
                     s2=np.zeros((0,), np.float32), kind="q80", k_logical=K)
    return qt if device is None else qt.to(device)


def quantize_tensor(w: np.ndarray, kind: str, device=None) -> QuantTensor:
    """Quantize a dense ``[K, O]`` f32 matrix with the reference's block math
    (`distributed-llama/converter/writer.py:26-75`), blocks along K."""
    w = np.ascontiguousarray(w, np.float32)
    K, O = w.shape
    flat = np.ascontiguousarray(w.T).reshape(-1)  # [O*K], rows of K
    if kind == "q40":
        q, d = blocks.unpack_q40(blocks.quantize_q40(flat))
        return pack_q40(q.reshape(O, K).T, d.reshape(O, K // QK).T, device)
    if kind == "q80":
        q, d = blocks.unpack_q80(blocks.quantize_q80(flat))
        return pack_q80(q.reshape(O, K).T, d.reshape(O, K // QK).T, device)
    raise ValueError(f"unknown quant kind {kind!r}")


def repack_q40(raw: np.ndarray, d: int, n: int, device=None) -> QuantTensor:
    """Losslessly repack a reference-format Q40 tensor (``d`` rows of ``n``
    values, blocks along n) into the kernel layout for the transposed
    ``[n, d]`` kernel matrix: the planes :func:`pack_q40` makes from the
    unpacked quants, built by moving nibbles. A file block holds value i in
    the low nibble of byte i (i < 16) or the high nibble of byte i - 16;
    the kernel's byte pairs value j of the superblock's first block (low
    nibble) with value j of its second (high nibble). Both store q + 8, so
    no quant is decoded, and the one transpose is of bytes. Torch does the
    work on ``device``; None gives numpy planes (made on the host's
    cores)."""
    if n % 64:
        raise ValueError(f"q40 kernel needs in_features % 64 == 0, got {n}")
    kp = _pad_up(n, K_MULTIPLE["q40"])
    blk = _raw_on(raw, device).reshape(d, n // 64, 2, blocks.Q40_BLOCK_BYTES)
    q0, q1 = blk[:, :, 0, 2:], blk[:, :, 1, 2:]  # the superblock's two blocks' nibble bytes
    pairs = torch.stack([(q0 & 0xF) | ((q1 & 0xF) << 4),  # values 0..15
                         (q0 >> 4) | (q1 & 0xF0)], dim=2)  # values 16..31
    deltas = blk[..., :2].contiguous().view(torch.float16)[..., 0].float()  # [d, n/64, 2]
    packed = torch.full((kp // 2, d), 0x88, dtype=torch.uint8, device=blk.device)  # quant 0
    packed[: n // 2] = pairs.reshape(d, n // 2).T
    s = torch.zeros((2, kp // 64, d), dtype=torch.float32, device=blk.device)
    s[:, : n // 64] = deltas.permute(2, 1, 0)
    return _placed(QuantTensor(w=packed, s=s[0].clone(), s2=s[1].clone(), kind="q40",
                               k_logical=n), device)


def repack_q80(raw: np.ndarray, d: int, n: int, device=None) -> QuantTensor:
    """Losslessly repack a reference-format Q80 tensor into the kernel
    layout (:func:`pack_q80`'s planes); ``device`` as for
    :func:`repack_q40`."""
    blk = _raw_on(raw, device).reshape(d, n // QK, blocks.Q80_BLOCK_BYTES)
    deltas = blk[..., :2].contiguous().view(torch.float16)[..., 0].float()  # [d, n/32]
    q = blk[..., 2:].contiguous().view(torch.int8).reshape(d, n)
    kp = _pad_up(n, K_MULTIPLE["q80"])
    w = torch.zeros((kp, d), dtype=torch.int8, device=blk.device)
    w[:n] = q.T
    s = torch.zeros((kp // QK, d), dtype=torch.float32, device=blk.device)
    s[: n // QK] = deltas.T
    s2 = torch.zeros((0,), dtype=torch.float32, device=blk.device)
    return _placed(QuantTensor(w=w, s=s, s2=s2, kind="q80", k_logical=n), device)


def _raw_on(raw: np.ndarray, device) -> torch.Tensor:
    """A tensor's file bytes (a read-only mmap view) as uint8 on ``device``
    (None: the host)."""
    t = torch.from_numpy(np.array(raw, np.uint8).reshape(-1))
    return t if device is None else t.to(device)


def _placed(qt: QuantTensor, device) -> QuantTensor:
    """``qt`` as it stands, or as numpy planes when ``device`` is None."""
    if device is not None:
        return qt
    return QuantTensor(qt.w.numpy(), qt.s.numpy(), qt.s2.numpy(), qt.kind, qt.k_logical)


def dequantize(qt: QuantTensor) -> np.ndarray:
    """QuantTensor -> dense f32 [K, O] numpy at the *logical* K (padding
    stripped; reference semantics, for tests)."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    if qt.kind == "q80":
        dense = host(qt.w).astype(np.float32) * np.repeat(host(qt.s).astype(np.float32), QK, axis=-2)
    else:
        pk = host(qt.w)
        half, O = pk.shape[-2:]
        lo = (pk & 0xF).astype(np.float32) - 8.0
        hi = ((pk >> 4) & 0xF).astype(np.float32) - 8.0
        s_lo = np.repeat(host(qt.s).astype(np.float32), QK, axis=-2)
        s_hi = np.repeat(host(qt.s2).astype(np.float32), QK, axis=-2)
        dq_lo = (lo * s_lo).reshape(*pk.shape[:-2], half // QK, QK, O)
        dq_hi = (hi * s_hi).reshape(*pk.shape[:-2], half // QK, QK, O)
        dense = np.concatenate([dq_lo, dq_hi], axis=-2).reshape(*pk.shape[:-2], half * 2, O)
    return dense[..., : qt.in_features, :]
