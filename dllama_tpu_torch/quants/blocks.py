"""Block quantization formats Q40 / Q80.

TPU-native re-implementation of the reference block formats
(`distributed-llama/src/quants.hpp:16-24`, `distributed-llama/converter/writer.py:26-75`):

* **Q40** — 32 values per block, stored as a little-endian float16 delta followed by
  16 bytes of 4-bit quants. Value ``i`` of the block lives in the *low* nibble of byte
  ``i`` for ``i < 16`` and in the *high* nibble of byte ``i - 16`` otherwise
  (`distributed-llama/src/quants.cpp:166-180`). Dequant: ``y = (nibble - 8) * delta``.
* **Q80** — 32 values per block: float16 delta + 32 int8 quants
  (`distributed-llama/src/quants.cpp:275-284`). Dequant: ``y = q * delta``.

Everything here is pure numpy and fully vectorized — it runs once at model load /
convert time. The on-device path works on the unpacked int tensors (see
``dllama_tpu_torch.ops.qmatmul``); nothing in the decode loop touches these byte codecs.
"""

from __future__ import annotations

import numpy as np

QK = 32  # values per block, both formats (QK40 == QK80 == 32)
Q40_BLOCK_BYTES = 18  # 2 (f16 delta) + 16 (nibbles)
Q80_BLOCK_BYTES = 34  # 2 (f16 delta) + 32 (int8)

F32 = 0
F16 = 1
Q40 = 2
Q80 = 3

FLOAT_TYPE_NAMES = {F32: "f32", F16: "f16", Q40: "q40", Q80: "q80"}
FLOAT_TYPE_BY_NAME = {v: k for k, v in FLOAT_TYPE_NAMES.items()}


def row_bytes(float_type: int, n: int) -> int:
    """Bytes for one row of ``n`` values (`distributed-llama/src/quants.cpp:29-47`)."""
    if float_type == F32:
        return 4 * n
    if float_type == F16:
        return 2 * n
    if float_type == Q40:
        assert n % QK == 0, f"q40 row length {n} not divisible by {QK}"
        return (n // QK) * Q40_BLOCK_BYTES
    if float_type == Q80:
        assert n % QK == 0, f"q80 row length {n} not divisible by {QK}"
        return (n // QK) * Q80_BLOCK_BYTES
    raise ValueError(f"unknown float type {float_type}")


def batch_bytes(float_type: int, n: int, d: int) -> int:
    """Bytes for a ``d x n`` tensor (d rows of n values)."""
    return row_bytes(float_type, n) * d


# ---------------------------------------------------------------------------
# Q40
# ---------------------------------------------------------------------------

def quantize_q40(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array (len % 32 == 0) to packed Q40 bytes.

    Reproduces the reference converter bit-exactly
    (`distributed-llama/converter/writer.py:26-54`): signed-max delta divided by -8,
    asymmetric ``+8.5`` shift with truncation, clamp to 15.
    Returns a uint8 array of shape ``(len(x)//32, 18)``.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    assert x.ndim == 1 and x.size % QK == 0
    groups = x.reshape(-1, QK)
    gmax = groups.max(axis=1)
    gmin = groups.min(axis=1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    deltas16 = deltas.astype(np.float16)
    inv = np.where(deltas != 0.0, np.divide(1.0, deltas, where=deltas != 0.0), 0.0)
    q = groups * inv[:, None] + 8.5
    q = np.where(q < 15.0, q, 15.0)
    q = np.floor(q).astype(np.uint8)  # values are >= 0 by construction (see module doc)

    lo = q[:, : QK // 2]
    hi = q[:, QK // 2 :]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)

    out = np.empty((groups.shape[0], Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out


def unpack_q40(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split packed Q40 bytes into ``(quants int8 [nb,32] in -8..7, deltas f16 [nb])``."""
    raw = raw.reshape(-1, Q40_BLOCK_BYTES)
    deltas = raw[:, :2].copy().view(np.float16).reshape(-1)
    qs = raw[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1), deltas


def dequantize_q40(raw: np.ndarray, n: int) -> np.ndarray:
    """Packed Q40 bytes -> f32 array of length ``n``."""
    quants, deltas = unpack_q40(raw)
    y = quants.astype(np.float32) * deltas.astype(np.float32)[:, None]
    y = y.reshape(-1)
    assert y.size == n, f"expected {n} values, got {y.size}"
    return y


# ---------------------------------------------------------------------------
# Q80
# ---------------------------------------------------------------------------

def quantize_q80(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array to packed Q80 bytes ``(len//32, 34)`` uint8.

    Matches the converter (`distributed-llama/converter/writer.py:56-75`):
    ``delta = absmax/127``, round-half-even quants.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    assert x.ndim == 1 and x.size % QK == 0
    groups = x.reshape(-1, QK)
    absmax = np.abs(groups).max(axis=1)
    deltas = absmax / 127.0
    deltas16 = deltas.astype(np.float16)
    inv = np.where(deltas != 0.0, np.divide(1.0, deltas, where=deltas != 0.0), 0.0)
    q = np.round(groups * inv[:, None]).astype(np.int8)

    out = np.empty((groups.shape[0], Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out


def unpack_q80(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split packed Q80 bytes into ``(quants int8 [nb,32], deltas f16 [nb])``."""
    raw = raw.reshape(-1, Q80_BLOCK_BYTES)
    deltas = raw[:, :2].copy().view(np.float16).reshape(-1)
    quants = raw[:, 2:].copy().view(np.int8)
    return quants, deltas


def dequantize_q80(raw: np.ndarray, n: int) -> np.ndarray:
    quants, deltas = unpack_q80(raw)
    y = quants.astype(np.float32) * deltas.astype(np.float32)[:, None]
    y = y.reshape(-1)
    assert y.size == n, f"expected {n} values, got {y.size}"
    return y


# ---------------------------------------------------------------------------
# Generic row codecs (used by the .m tensor reader/writer)
# ---------------------------------------------------------------------------

def encode_tensor(x: np.ndarray, float_type: int) -> bytes:
    """Serialize a flat f32 array in the given on-disk format."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if float_type == F32:
        return x.tobytes()
    if float_type == F16:
        return x.astype(np.float16).tobytes()
    if float_type == Q40:
        return quantize_q40(x).tobytes()
    if float_type == Q80:
        return quantize_q80(x).tobytes()
    raise ValueError(f"unknown float type {float_type}")


def decode_tensor(buf: np.ndarray, float_type: int, n: int) -> np.ndarray:
    """Decode ``n`` values from a uint8 buffer in the given on-disk format -> f32."""
    if float_type == F32:
        return buf[: 4 * n].copy().view(np.float32).copy()
    if float_type == F16:
        return buf[: 2 * n].copy().view(np.float16).astype(np.float32)
    if float_type == Q40:
        return dequantize_q40(buf[: row_bytes(Q40, n)], n)
    if float_type == Q80:
        return dequantize_q80(buf[: row_bytes(Q80, n)], n)
    raise ValueError(f"unknown float type {float_type}")
