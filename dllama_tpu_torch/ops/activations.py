"""Activations matching the reference kernels.

* ``silu``: ``x * sigmoid(x)`` (`distributed-llama/src/funcs.cpp:499-506`).
* ``gelu``: tanh approximation ``0.5*x*(1+tanh(sqrt(2/pi)*(x+0.044715*x^3)))``
  (`distributed-llama/src/funcs.cpp:490-497`) — used by Grok-1.
"""

from __future__ import annotations

import torch

GELU_CONST = 0.044715
SQRT_2_OVER_PI = 0.7978845608028654


def silu(x: torch.Tensor) -> torch.Tensor:
    # the logistic written out as XLA lowers it, one rounding per op in the
    # activation dtype (torch.sigmoid rounds once, which differs in bf16)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(SQRT_2_OVER_PI * (xf + GELU_CONST * xf * xf * xf)))
    return out.to(x.dtype)


ACTIVATIONS = {"silu": silu, "gelu": gelu_tanh}
