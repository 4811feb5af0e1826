"""Normalization ops.

RMSNorm semantics match the reference exactly
(`distributed-llama/src/funcs.cpp:94-123`): ``inv = 1/sqrt(mean(x^2) + 1e-5)``,
``y = w * (inv * x)`` — eps is added to the *mean*, and everything runs in
f32 whatever the activation dtype, then casts back once.
"""

from __future__ import annotations

import torch

RMS_EPS = 1e-5


def rmsnorm_inv(x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """The per-row normalizer ``1/sqrt(mean(x^2) + eps)`` as [..., 1] f32.
    :func:`rmsnorm` and the fused-norm matmul epilogues
    (``ops.qmatmul.qmatmul_norm``) both take it from here, so the two agree
    bit for bit."""
    xf = x.float()
    return torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """RMS-normalize the last axis. x: [..., dim], weight: [dim]."""
    return (weight.float() * (x.float() * rmsnorm_inv(x, eps))).to(x.dtype)
