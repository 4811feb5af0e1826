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


def row_seed(seed: int, row: int) -> int:
    """Row ``row``'s seed in a batch whose rows share one SamplerConfig:
    ``(seed + row * 1_000_003) mod 2**63``. Row 0 keeps the config's own
    seed; the other rows get their own streams."""
    return (int(seed) + int(row) * 1_000_003) % (1 << 63)


def gumbel_noise(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` from ``generator``, f32 [n]."""
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_dynamic(logits: torch.Tensor, temperature: float, topp: float,
                   generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a token id (int64 scalar tensor, on logits' device) from
    ``logits [vocab]``: :func:`sample_rows` of one row. ``temperature``/
    ``topp`` are host floats. Above temperature 0 the noise is ``gumbel`` if
    given, else drawn from ``generator``."""
    return sample_rows(logits[None], [temperature], [topp], [generator],
                       None if gumbel is None else gumbel[None])[0]


def sample_rows(logits: torch.Tensor, temps: list, topps: list,
                generators: list | None = None,
                gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row of ``logits [B, vocab]`` (int64 [B], on logits'
    device): what ``jax.vmap(sample_dynamic)`` does. ``temps``/``topps`` are
    host floats per row. Greedy rows (temperature 0) take the argmax; the
    sampled rows go through one batched softmax, sort and top-p cut, and
    each draws its Gumbel noise from ITS OWN ``generators[b]`` (or takes
    ``gumbel[b]``), so a row's stream never depends on its neighbours.
    Nothing is read back to the host."""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    rows = [b for b, t in enumerate(temps) if t > 0.0]
    if not rows:
        return out
    dev, V = logits.device, logits.shape[-1]
    if gumbel is None:
        if generators is None or any(generators[b] is None for b in rows):
            raise ValueError("sampling above temperature 0 needs a generator or gumbel noise")
        noise = torch.stack([gumbel_noise(V, generators[b], dev) for b in rows])
    else:
        noise = gumbel.to(dev)[rows]
    t = torch.tensor([max(float(temps[b]), 1e-6) for b in rows], device=dev)[:, None]
    # topp outside (0,1): threshold 2.0 keeps every token (cum prefix < 2)
    eff_topp = torch.tensor([2.0 if (topps[b] <= 0.0 or topps[b] >= 1.0) else float(topps[b])
                             for b in rows], device=dev)[:, None]
    probs = torch.softmax(logits[rows] / t, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < eff_topp  # mass before this token < topp
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    choice = torch.argmax(noise + torch.log(masked), dim=-1, keepdim=True)
    out[rows] = sorted_idx.gather(-1, choice)[:, 0]
    return out
