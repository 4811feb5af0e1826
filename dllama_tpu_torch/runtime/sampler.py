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
noise JAX drew and get JAX's token. A traced program (``sample_traced``, the
native export's loop) takes its noise from a counter hash of its seed and
step instead.
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


@dataclasses.dataclass
class RowSampling:
    """The per-row settings of :func:`sample_prepared`, as device tensors
    made once: ``mask`` bool [B] the rows that sample (temperature > 0),
    ``temp`` f32 [B, 1] each row's temperature (at least 1e-6; 1 on a greedy
    row) and ``topp`` f32 [B, 1] its top-p threshold (2.0 for a top-p
    outside (0, 1): keep every token). A captured decode step keeps one and
    refills it with :meth:`set` before a replay, with no host sync, for any
    mix of sampled and greedy rows."""

    mask: torch.Tensor
    temp: torch.Tensor
    topp: torch.Tensor

    @staticmethod
    def _values(temps: list, topps: list) -> tuple:
        m = [t > 0.0 for t in temps]
        t = [max(float(t), 1e-6) if s else 1.0 for t, s in zip(temps, m)]
        # topp outside (0,1): threshold 2.0 keeps every token (cum prefix < 2)
        p = [2.0 if (q <= 0.0 or q >= 1.0) else float(q) for q in topps]
        return (torch.tensor(m, dtype=torch.bool), torch.tensor(t, dtype=torch.float32)[:, None],
                torch.tensor(p, dtype=torch.float32)[:, None])

    @classmethod
    def prepare(cls, temps: list, topps: list, device) -> "RowSampling":
        return cls(*(v.to(device) for v in cls._values(temps, topps)))

    def set(self, temps: list, topps: list) -> None:
        """New settings for every row, copied without a sync."""
        for dst, src in zip((self.mask, self.temp, self.topp), self._values(temps, topps)):
            dst.copy_(src, non_blocking=True)


def sample_rows(logits: torch.Tensor, temps: list, topps: list,
                generators: list | None = None,
                gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row of ``logits [B, vocab]`` (int64 [B], on logits'
    device): what ``jax.vmap(sample_dynamic)`` does. ``temps``/``topps`` are
    host floats per row. Greedy rows (temperature 0) take the argmax and
    draw nothing; if any row samples, every row goes through one batched
    softmax, sort and top-p cut (a row's result depends on that row alone)
    and each sampled row draws its Gumbel noise from ITS OWN
    ``generators[b]`` (or takes ``gumbel[b]``), so a row's stream never
    depends on its neighbours. Nothing is read back to the host.
    :func:`sample_prepared` on settings prepared here."""
    if not any(t > 0.0 for t in temps):
        return torch.argmax(logits.float(), dim=-1)
    if gumbel is None:
        if generators is None or any(t > 0.0 and generators[b] is None
                                     for b, t in enumerate(temps)):
            raise ValueError("sampling above temperature 0 needs a generator or gumbel noise")
        generators = [g if t > 0.0 else None for g, t in zip(generators, temps)]
    return sample_prepared(logits, RowSampling.prepare(temps, topps, logits.device),
                           generators, gumbel)


def sample_prepared(logits: torch.Tensor, prep: RowSampling,
                    generators: list | None = None,
                    gumbel: torch.Tensor | None = None, mass_before=None) -> torch.Tensor:
    """:func:`sample_rows` with its settings already on the device: every
    row is sampled and ``prep.mask`` picks between that and the argmax, so
    every operation is a kernel on tensors that exist, with no tensor made
    from a host value, and a CUDA graph can capture it for any mix of rows
    (the generators registered with the graph). Row b's noise is
    ``gumbel[b]``, else a draw from ``generators[b]`` (zeros where that is
    None: a greedy row's noise is never used). ``mass_before(sorted_probs)``,
    if given, computes the mass before each sorted token in place of the
    cumulative sum."""
    logits = logits.float()
    dev, V = logits.device, logits.shape[-1]
    if gumbel is None:
        if generators is None:
            raise ValueError("sampling above temperature 0 needs a generator or gumbel noise")
        noise = torch.stack([torch.zeros(V, device=dev) if g is None else gumbel_noise(V, g, dev)
                             for g in generators])
    else:
        noise = gumbel.to(dev)
    probs = torch.softmax(logits / prep.temp, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if mass_before is None:
        before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    else:
        before = mass_before(sorted_probs)
    keep = before < prep.topp  # mass before this token < topp
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    choice = torch.argmax(noise + torch.log(masked), dim=-1, keepdim=True)
    return torch.where(prep.mask, sorted_idx.gather(-1, choice)[:, 0],
                       torch.argmax(logits, dim=-1))


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix of ``x`` (int64 holding values below 2**32):
    xor-shifts and two odd multipliers below 2**31, each product masked
    back to 32 bits, so no intermediate leaves int64's range and the CPU
    and CUDA give the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def hash_bits(seed: torch.Tensor, step: torch.Tensor, n: int) -> torch.Tensor:
    """32 hash bits (int64 [n]) of (``seed``, ``step``, index) for each
    index below ``n``: a counter-based hash of 0-d integer tensors, so a
    traced program makes its noise with no generator and the same (seed,
    step) gives the same bits on the CPU and on CUDA."""
    key = _mix32((seed.long() & _MASK32) ^ 0x3C6EF372)
    key = _mix32(key ^ ((step.long() & _MASK32) * 0x27D4EB2D & _MASK32))
    return _mix32(_mix32(key ^ torch.arange(n, device=seed.device)))


def hash_gumbel(seed: torch.Tensor, step: torch.Tensor, n: int) -> torch.Tensor:
    """Gumbel noise f32 [n] from :func:`hash_bits`: the uniform draw is 23
    bits plus one half over 2**23, never 0 or 1."""
    u = ((hash_bits(seed, step, n) >> 9).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def mass_before_products(sorted_probs: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """The mass before each token of one row ``sorted_probs [1, n]``,
    computed by two matrix products instead of a scan: the row cut into
    ``width``-wide pieces, each piece's exclusive prefix sums by a product
    with the strictly upper triangle of ones, plus the sum of the pieces
    before it. (Inductor, torch 2.11, cannot compile a vocabulary-wide
    scan inside a ``while_loop`` body for CUDA.) Equal to ``cumsum - x`` up
    to the summation order."""
    n = sorted_probs.shape[-1]
    rows = -(-n // width)
    dev = sorted_probs.device
    x = torch.nn.functional.pad(sorted_probs.reshape(-1), (0, rows * width - n))
    x = x.reshape(rows, width)
    within = x @ torch.triu(torch.ones(width, width, device=dev), diagonal=1)
    offsets = x.sum(dim=-1) @ torch.triu(torch.ones(rows, rows, device=dev), diagonal=1)
    return (within + offsets[:, None]).reshape(1, -1)[:, :n]


def sample_traced(logits: torch.Tensor, temp: torch.Tensor, topp: torch.Tensor,
                  seed: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """One token (int64 [1]) from ``logits [vocab]`` with every setting a
    0-d tensor, for a traced program: :func:`sample_prepared`'s math with
    :class:`RowSampling`'s values computed on the device (temperature 0:
    the argmax; a top-p outside (0, 1) keeps every token), the noise
    :func:`hash_gumbel` of (``seed``, ``step``) and the mass before each
    token from :func:`mass_before_products`."""
    temp, topp = temp.float().reshape(1, 1), topp.float().reshape(1, 1)
    mask = temp[:, 0] > 0.0
    prep = RowSampling(
        mask=mask,
        temp=torch.where(temp > 0.0, torch.clamp(temp, min=1e-6), torch.ones_like(temp)),
        topp=torch.where((topp <= 0.0) | (topp >= 1.0), torch.full_like(topp, 2.0), topp))
    noise = hash_gumbel(seed, step, logits.shape[-1])
    return sample_prepared(logits.reshape(1, -1), prep, gumbel=noise[None],
                           mass_before=mass_before_products)
