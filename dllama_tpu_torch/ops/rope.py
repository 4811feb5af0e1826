"""Rotary position embeddings — both conventions the reference supports.

* **interleaved** (Llama archs): pair ``(2j, 2j+1)`` within each head, angle
  ``pos * theta^(-2j/head_size)``.
* **half** (Grok-1 / Mixtral, NeoX layout): pair ``(j, j + head_size/2)``.

Tables are f32 ``[seq_len, head_size//2]`` numpy arrays; the rotation runs in
f32. The JAX package runs the rotation jitted, where XLA contracts
``x0*c - x1*s`` into ``fma(x0, c, -(x1*s))`` and ``x0*s + x1*c`` into
``fma(x0, s, x1*c)``; ``rotate`` computes exactly those single-rounding forms
(the product of two f32 is exact in f64), so the port's rotated K and Q carry
the reference's bits.
"""

from __future__ import annotations

import numpy as np
import torch

INTERLEAVED = "interleaved"
HALF = "half"


def rope_table(seq_len: int, head_size: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables, each [seq_len, head_size//2], f32."""
    j = np.arange(0, head_size, 2, dtype=np.float32)  # 2j over the head
    freqs = 1.0 / np.power(np.float32(theta), j / np.float32(head_size))
    angles = np.arange(seq_len, dtype=np.float32)[:, None] * freqs[None, :]
    return np.cos(angles), np.sin(angles)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, like a fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


def rotate(xf: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
           style: str = INTERLEAVED) -> torch.Tensor:
    """The f32 rotation of ``xf [..., n_heads, head_size]``; returns f32."""
    if style == INTERLEAVED:
        x0, x1 = xf[..., 0::2], xf[..., 1::2]
    elif style == HALF:
        half = xf.shape[-1] // 2
        x0, x1 = xf[..., :half], xf[..., half:]
    else:
        raise ValueError(f"unknown rope style {style!r}")
    r0 = _fma(x0, c, -(x1 * s))
    r1 = _fma(x0, s, x1 * c)
    if style == INTERLEAVED:
        return torch.stack([r0, r1], dim=-1).reshape(xf.shape)
    return torch.cat([r0, r1], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, style: str = INTERLEAVED
) -> torch.Tensor:
    """Rotate ``x [..., n_heads, head_size]`` with per-position tables.

    ``cos``/``sin`` must be broadcastable to ``[..., 1, head_size//2]`` — pass
    ``table[pos:pos+T, None, :]``.
    """
    return rotate(x.float(), cos.float(), sin.float(), style).to(x.dtype)
