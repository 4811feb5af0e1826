"""Normalization ops.

RMSNorm semantics match the reference exactly
(`distributed-llama/src/funcs.cpp:94-123`): ``inv = 1/sqrt(mean(x^2) + 1e-5)``,
``y = w * (inv * x)`` — eps is added to the *mean*, and everything runs in
f32 whatever the activation dtype, then casts back once.
"""

from __future__ import annotations

import torch

RMS_EPS = 1e-5


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """RMS-normalize the last axis. x: [..., dim], weight: [dim]."""
    xf = x.float()
    inv = torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (weight.float() * (xf * inv)).to(x.dtype)
