"""Token sampling: greedy argmax / temperature / top-p nucleus.

Same semantics as the JAX package's ``sample_dynamic`` (and the reference
Sampler, `distributed-llama/src/tokenizer.cpp:231-356`): temperature 0 means
argmax; otherwise softmax(logits/temperature), then the smallest
descending-probability prefix whose cumulative mass reaches top-p (inclusive
of the crossing token), and a categorical draw from what is kept.

The draw is the Gumbel-max trick, ``argmax(log(masked) + gumbel)``, as
``jax.random.categorical`` does it. The noise comes from a
``torch.Generator`` — different numbers from JAX's for the same seed — or
from an explicit ``gumbel`` tensor, which is how the tests feed in the
noise JAX drew and get JAX's token.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.8
    topp: float = 0.9
    seed: int = 0


def gumbel_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from ``generator``, f32 [n]."""
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_dynamic(logits: torch.Tensor, temperature: float, topp: float,
                   generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a token id (int64 scalar tensor, on logits' device) from
    ``logits [vocab]``. ``temperature``/``topp`` are host floats. Above
    temperature 0 the noise is ``gumbel`` if given, else drawn from
    ``generator``."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits)
    t = max(float(temperature), 1e-6)
    probs = torch.softmax(logits / t, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # topp outside (0,1): threshold 2.0 keeps every token (cum prefix < 2)
    eff_topp = 2.0 if (topp <= 0.0 or topp >= 1.0) else float(topp)
    keep = (cum - sorted_probs) < eff_topp  # mass before this token < topp
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    if gumbel is None:
        if generator is None:
            raise ValueError("sampling above temperature 0 needs a generator or gumbel noise")
        gumbel = gumbel_noise(logits.shape[-1], generator, logits.device)
    choice = torch.argmax(gumbel.to(logits.device) + torch.log(masked))
    return sorted_idx[choice]
