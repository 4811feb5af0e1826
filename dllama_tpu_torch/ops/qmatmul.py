"""Q40 dequant-matmul: the hand-written CUDA kernel, its plain version, and
the packed weight layout it reads.

Layout — the JAX package's, byte for byte, so carrying weights across is a
copy: a Q40 matrix ``[K, O]`` is a ``uint8 [K/2, O]`` plane (O contiguous)
plus two ``f32 [K/64, O]`` scale planes. Byte ``32s + j`` holds input row
``64s + j`` in its low nibble (scale ``s_lo[s]``) and row ``64s + 32 + j`` in
its high nibble (``s_hi[s]``). Nibbles store ``q + 8``; dequant is
``(q - 8) * delta``, the reference's own Q40 math
(`distributed-llama/src/quants.cpp:166-180`), so repacking a published Q40 file
is lossless. K is padded up to ``K_MULTIPLE['q40']`` with zero quants and zero
scales; the padded rows multiply zero-padded activation columns and add
exactly nothing.

The product (both routes): ``out[T, O] f32 = sum_k bf16(x) * bf16(dequant(W))``
accumulated in f32. Under ``nosub`` (the default, ``DLLAMA_Q40_NOSUB``) the
dequant drops the ``- 8`` and the exact recentering term
``8 * (blocksum_lo(x) @ s_lo + blocksum_hi(x) @ s_hi)`` — f32 sums of the
bf16-rounded activation over each 32-row block — is subtracted at the end;
``nosub`` rounds ``q * delta`` to bf16, not ``(q - 8) * delta``, so the two
settings differ in their last bits.

``q40_matmul`` launches the CUDA kernel (``csrc/q40_matmul.cu``) for a CUDA
tensor and runs ``q40_matmul_ref`` for a CPU tensor; there is no other route.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.quants import blocks

QK = blocks.QK  # 32 values per quantization block

#: drop the nibble recentering in the dequant and subtract the exact
#: correction term instead — the JAX package's default numerics
Q40_NOSUB = os.environ.get("DLLAMA_Q40_NOSUB", "1") != "0"

#: input-dim padding unit per kind, as the JAX package packs it
K_MULTIPLE = {"q40": 512, "q80": 256}

#: output columns one CUDA block covers (128 threads x 4 columns)
_BLOCK_COLS = 512


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
# The kernel's plain version
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


def q40_matmul_ref(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                   s_hi: torch.Tensor, nosub: bool | None = None) -> torch.Tensor:
    """The kernel's function step by step in plain PyTorch: ``x [T, K] @
    dequant(packed uint8 [K/2, O]) -> [T, O]`` f32. Both dot operands are
    rounded to bf16 and the products summed in f32 (a product of two bf16
    values is exact in f32, so only the summation order differs from the
    kernel)."""
    if nosub is None:
        nosub = Q40_NOSUB
    K = packed.shape[0] * 2
    xb = _pad_cols(x.to(torch.bfloat16), K).float()
    lo = (packed & 0xF).float()
    hi = (packed >> 4).float()
    if not nosub:
        lo = lo - 8.0
        hi = hi - 8.0
    w_lo = (lo * s_lo.repeat_interleave(QK, dim=0)).to(torch.bfloat16).float()
    w_hi = (hi * s_hi.repeat_interleave(QK, dim=0)).to(torch.bfloat16).float()
    x_lo, x_hi = _q40_split(xb)
    out = x_lo @ w_lo + x_hi @ w_hi
    if nosub:
        xs_lo, xs_hi = _q40_block_sums(xb)
        out = out - 8.0 * (xs_lo @ s_lo + xs_hi @ s_hi)
    return out


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

def split_plan(T: int, K: int, O: int, n_sm: int) -> tuple[int, int]:
    """(ksplit, superblocks per split) for the CUDA kernel: split K across
    blocks until about four blocks per SM are in flight, so a decode GEMV
    with few output columns (wo: 8 column blocks) still fills the card."""
    nsb = K // 64
    tt = 8 if T > 8 else next(t for t in (1, 2, 4, 8) if t >= T)
    blocks_ = math.ceil(O / _BLOCK_COLS) * math.ceil(T / tt)
    want = max(1, min(nsb, math.ceil(4 * n_sm / blocks_)))
    sb_per = math.ceil(nsb / want)
    return math.ceil(nsb / sb_per), sb_per


def q40_matmul(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
               s_hi: torch.Tensor, nosub: bool | None = None) -> torch.Tensor:
    """``x [T, K] @ dequant(packed uint8 [K/2, O]) -> [T, O]`` f32.

    A CUDA ``packed`` launches ``csrc/q40_matmul.cu``; a CPU one runs
    :func:`q40_matmul_ref`. K2's correction term is computed inside the same
    kernel under ``nosub``."""
    if nosub is None:
        nosub = Q40_NOSUB
    if packed.device.type == "cpu":
        return q40_matmul_ref(x, packed, s_lo, s_hi, nosub)
    if packed.device.type != "cuda":
        raise ValueError(f"q40_matmul: unsupported device {packed.device}")
    K2, O = packed.shape
    K = 2 * K2
    T = x.shape[0]
    if packed.dtype != torch.uint8 or s_lo.dtype != torch.float32 or s_hi.dtype != torch.float32:
        raise TypeError("q40_matmul: want uint8 packed and f32 scale planes")
    if s_lo.shape != (K // 64, O) or s_hi.shape != (K // 64, O) or K % 64:
        raise ValueError(f"q40_matmul: planes {tuple(packed.shape)}, "
                         f"{tuple(s_lo.shape)}, {tuple(s_hi.shape)} disagree")
    if x.ndim != 2 or x.shape[1] > K or not 1 <= T <= 8 * 65535:
        raise ValueError(f"q40_matmul: activation {tuple(x.shape)} vs packed K {K}")
    if not (packed.is_contiguous() and s_lo.is_contiguous() and s_hi.is_contiguous()):
        raise ValueError("q40_matmul: weight planes must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"q40_matmul: x on {x.device}, weights on {packed.device}")
    xb = _pad_cols(x.to(torch.bfloat16), K).contiguous()
    n_sm = torch.cuda.get_device_properties(packed.device).multi_processor_count
    ksplit, sb_per = split_plan(T, K, O, n_sm)
    out = torch.empty((T, O), dtype=torch.float32, device=packed.device)
    partials = (torch.empty((ksplit, T, O), dtype=torch.float32, device=packed.device)
                if ksplit > 1 else out)
    with torch.cuda.device(packed.device):
        rc = kernels.lib().dllama_q40_matmul(
            xb.data_ptr(), T, K, packed.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(),
            O, int(bool(nosub)), ksplit, sb_per, partials.data_ptr(), out.data_ptr(),
            kernels.stream_of(packed))
    kernels.check(rc, "q40_matmul")
    kernels.launches["q40_matmul"] += 1
    return out


def qmatmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` through the kernel of ``qt.kind``; the output dtype
    follows ``x``, accumulation is f32."""
    if qt.kind == "q40":
        out = q40_matmul(x, qt.w, qt.s, qt.s2)
    elif qt.kind == "q80":
        raise NotImplementedError(
            "q80 weights need the Q80 dequant-matmul kernel, which this port "
            "does not have yet; use q40 weights or a dense --weights-float-type")
    else:
        raise ValueError(f"unknown QuantTensor kind {qt.kind!r}")
    return out.to(x.dtype)


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where w is a dense tensor or a QuantTensor. Mixed dense
    dtypes promote like jnp (bf16 @ f16 -> f32)."""
    if isinstance(w, QuantTensor):
        return qmatmul(x, w)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


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
    ``[n, d]`` kernel matrix."""
    q, deltas = blocks.unpack_q40(raw)
    return pack_q40(q.reshape(d, n).T, deltas.reshape(d, n // QK).T, device)


def repack_q80(raw: np.ndarray, d: int, n: int, device=None) -> QuantTensor:
    q, deltas = blocks.unpack_q80(raw)
    return pack_q80(q.reshape(d, n).T, deltas.reshape(d, n // QK).T, device)


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
