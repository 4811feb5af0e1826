"""Ring attention: causal GQA self-attention with the sequence sharded over
an ``sp`` group, the port of ``dllama_tpu/ops/ring_attention.py``.

Each rank holds one contiguous chunk of the sequence's Q/K/V (rank i:
positions ``[i*Tc, (i+1)*Tc)``). The K/V chunks go round the ring, one
:func:`parallel.grad_collectives.ring_shift` a step (K and V in one
message), while every rank folds each chunk into its queries' attention
with an online softmax: a running (max, denominator, accumulator) triple in
f32 (Liu et al. 2023, the blockwise-parallel formulation). Per (query chunk,
kv chunk) pair the causal mask is decided by the chunk held, ``src``,
against the rank's own, ``idx``:

* ``src < idx``: the whole chunk is in the past, no mask;
* ``src == idx``: the local causal mask;
* ``src > idx``: the whole chunk is in the future, every score masked.

n - 1 rotations move the data n - 1 hops; the last chunk is folded in
after the loop, so no dead rotation is issued. A fully masked chunk is
computed like any other (its weights are exact zeros), as the JAX package
computes it: every rank then runs the same graph, and every rotation's
backward (the reverse shift of its cotangent) runs on every rank in one
order. Differentiable end to end through autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.parallel.grad_collectives import ring_shift

NEG_INF = -1e30


def _chunk_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Tq, Hkv, G, D], k [B, Tkv, Hkv, D] -> scaled scores
    [B, Hkv, G, Tq, Tkv]."""
    scale = float(np.sqrt(np.float32(q.shape[-1])))
    return torch.einsum("btkgh,bskh->bkgts", q, k) / scale


def ring_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                          causal: bool = True) -> torch.Tensor:
    """One rank's body: q [B, Tc, Hkv, G, D], k and v [B, Tc, Hkv, D], all
    f32, this rank's chunks in ring order over ``group`` (None: one rank).
    Returns [B, Tc, Hkv, G, D] f32."""
    n = 1 if group is None else group.size
    idx = 0 if group is None else group.rank
    B, Tc, Hkv, G, D = q.shape
    local_mask = torch.ones((Tc, Tc), dtype=torch.bool, device=q.device).tril()
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)  # no host copy

    acc = q.new_zeros((B, Hkv, G, Tc, D))
    row_max = torch.full((B, Hkv, G, Tc), NEG_INF, dtype=torch.float32, device=q.device)
    denom = q.new_zeros((B, Hkv, G, Tc))

    def accumulate(s, kv, acc, row_max, denom):
        src = (idx - s) % n  # the rank whose chunk is held after s rotations
        scores = _chunk_scores(q, kv[0])
        if causal and src == idx:
            scores = torch.where(local_mask, scores, neg)
        elif causal and src > idx:
            scores = torch.full_like(scores, NEG_INF)
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        # a fully masked row: exp(NEG_INF - NEG_INF) would be 1
        safe_max = torch.where(new_max <= NEG_INF, 0.0, new_max)
        correction = torch.exp(torch.maximum(row_max - safe_max, neg))
        correction = torch.where(row_max <= NEG_INF, 0.0, correction)
        p = torch.exp(scores - safe_max[..., None])
        p = torch.where(scores <= NEG_INF, 0.0, p)
        acc = acc * correction[..., None] + torch.einsum("bkgts,bskh->bkgth", p, kv[1])
        denom = denom * correction + p.sum(dim=-1)
        return acc, new_max, denom

    kv = torch.stack([k, v])
    for s in range(n - 1):
        acc, row_max, denom = accumulate(s, kv, acc, row_max, denom)
        kv = ring_shift(kv, group)
    acc, row_max, denom = accumulate(n - 1, kv, acc, row_max, denom)
    out = acc / torch.where(denom == 0.0, 1.0, denom)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                        causal: bool = True) -> torch.Tensor:
    """Causal GQA self-attention on this rank's sequence chunk: q [B, Tc, Hq,
    D], k and v [B, Tc, Hkv, D] -> [B, Tc, Hq, D] in q's dtype, the rank's
    rows of softmax(QK^T)V over the whole sequence held across ``group``."""
    B, Tc, Hq, D = q.shape
    Hkv = k.shape[2]
    out = ring_attention_kernel(q.float().reshape(B, Tc, Hkv, Hq // Hkv, D), k.float(),
                                v.float(), group, causal)
    return out.reshape(B, Tc, Hq, D).to(q.dtype)
