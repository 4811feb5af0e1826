"""The activation gathers of the quantized tensor-parallel forward.

Every matrix is sharded on its output axis only (``parallel.quant_tp``), so
each matmul's input is gathered whole first: the port of the gather
direction of ``dllama_tpu/parallel/collectives.py``, the reference's
per-layer wire trips (`distributed-llama/src/tasks.cpp:44-90`). A gather is
one ``torch.distributed.all_gather`` (the list form, which NCCL and gloo
both take, gloo CUDA tensors included) and a concatenation in rank order.

``compress=True`` moves the activation as the reference's Q80 wire
(``--buffer-float-type q80``, ``quantizeQ80Row`` at
`distributed-llama/src/tasks.cpp:124-163`): int8 quants of 32-value blocks
followed by the bytes of each block's f32 scale, one payload per gather.
The codec is a copy of the JAX package's ``_q80_encode``/``_q80_decode``
with its order of operations, so the payload is bit-equal to JAX's on the
same input.

Each gather adds the bytes it sent to its group's ``sent_bytes``: (size -
1) times the local payload, as many as it receives, what a ring all-gather
moves through every rank (the JAX package's analytic count). A failed
collective raises; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

QK = 32  # values per Q80 wire block


def _require_q80_blocks(f: int, what: str) -> None:
    """The Q80 wire packs 32-value blocks: a feature dim off that grid
    would mix quants and scale bytes in the payload."""
    if f % QK:
        raise ValueError(f"{what}: local feature dim {f} is not a multiple of the {QK}-value "
                         f"Q80 block; pad the shard to a {QK}-multiple or gather uncompressed")


def q80_encode(xf: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., f]`` -> ONE int8 payload ``[..., f + f//8]``: the int8
    quants (round half to even of ``x / scale``, ``scale = absmax / 127``
    per 32-value block, a zero block divided by 1) followed by the bytes of
    each block's f32 scale."""
    lead, f = xf.shape[:-1], xf.shape[-1]
    xb = xf.reshape(*lead, f // QK, QK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.where(scale == 0.0, 1.0, scale)).to(torch.int8)
    scale_bytes = scale[..., 0].contiguous().view(torch.int8).reshape(*lead, f // 8)
    return torch.cat([q.reshape(*lead, f), scale_bytes], dim=-1)


def q80_decode(payload: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`q80_encode`: ``[..., f + f//8]`` int8 -> f32
    ``[..., f]`` (each int8 x f32-scale product is exact in f32)."""
    lead = payload.shape[:-1]
    q = payload[..., :f].float().reshape(*lead, f // QK, QK)
    s = payload[..., f:].contiguous().view(torch.float32).reshape(*lead, f // QK, 1)
    return (q * s).reshape(*lead, f)


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the last axis in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    group.sent_bytes += (group.size - 1) * x.numel() * x.element_size()
    return torch.cat(parts, dim=-1)


def gather_columns(x: torch.Tensor, group, compress: bool = False) -> torch.Tensor:
    """Concatenate the feature (last) axis across ``group`` (a
    ``group.TPGroup``; identity when None). A group of one still gathers
    through its backend. ``compress``: over the Q80 wire (the local feature
    dim a multiple of 32); the result is dequantized in ``x``'s dtype."""
    if group is None:
        return x
    if not compress:
        return _all_gather_last(x, group)
    lead, f = x.shape[:-1], x.shape[-1]
    _require_q80_blocks(f, "gather_columns(compress=True)")
    payload = _all_gather_last(q80_encode(x.float()), group)
    deq = q80_decode(payload.reshape(*lead, group.size, f + f // 8), f)
    return deq.reshape(*lead, group.size * f).to(x.dtype)
