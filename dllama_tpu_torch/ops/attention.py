"""Grouped-query attention over a fixed-size KV cache — the prefill attention.

Semantics mirror the reference per-head loop
(`distributed-llama/src/llama2-tasks.cpp:54-94`): score = q.k / sqrt(head_size),
softmax over positions 0..pos+t (inclusive), weighted sum of V, all in f32.
Prefill processes T query positions at once under a causal mask. Decode
(T <= 16) takes ``ops.flash_decode`` instead, exactly where the JAX package's
flash-decode gate engages. The batched speculative verify step (B sequences
of T draft rows, each at its own position) attends with
:func:`gqa_attention_batched`, the reference's ``jax.vmap(gqa_attention)``
written out as a batch axis: plain XLA there, plain PyTorch here. The solo
:func:`gqa_attention` is its B = 1 call.
"""

from __future__ import annotations

import torch


def gqa_attention(
    q: torch.Tensor,  # [T, n_heads, head_size]
    k_cache: torch.Tensor,  # [S, n_kv_heads, head_size]
    v_cache: torch.Tensor,  # [S, n_kv_heads, head_size]
    pos: int,  # position of q[0] in the sequence
) -> torch.Tensor:
    """Masked GQA attention. Returns [T, n_heads, head_size] in q's dtype.

    The cache must already contain this step's K/V at positions pos..pos+T-1.
    Query t attends to cache positions <= pos + t; everything later is masked.
    """
    pos_b = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    return gqa_attention_batched(q[None], k_cache[None], v_cache[None], pos_b)[0]


def gqa_attention_batched(
    q: torch.Tensor,  # [B, T, n_heads, head_size]
    k_cache: torch.Tensor,  # [B, S, n_kv_heads, head_size]
    v_cache: torch.Tensor,  # [B, S, n_kv_heads, head_size]
    pos: torch.Tensor,  # [B] int: position of q[b, 0]
) -> torch.Tensor:
    """:func:`gqa_attention` of every row b at its own ``pos[b]`` in one
    batched pass: query (b, t) attends to row b's cache positions <= pos[b]
    + t. The mask is built from the device ``pos``, nothing is read back to
    the host. Returns [B, T, n_heads, head_size] in q's dtype."""
    B, T, n_heads, head_size = q.shape
    S, n_kv_heads = k_cache.shape[1], k_cache.shape[2]
    group = n_heads // n_kv_heads
    dev = q.device

    # constants made on the device: a tensor built from a host scalar is a
    # pageable copy, after which PyTorch waits for the stream
    def const(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=dev)

    qf = q.float().reshape(B, T, n_kv_heads, group, head_size)
    scores = torch.einsum("btkgh,bskh->btkgs", qf, k_cache.float()) / torch.sqrt(
        const(head_size))

    query_pos = pos.to(dev).long()[:, None] + torch.arange(T, device=dev)  # [B, T]
    mask = torch.arange(S, device=dev) <= query_pos[:, :, None]  # [B, T, S]
    scores = torch.where(mask[:, :, None, None, :], scores, const(-1e30))

    att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    att = att / att.sum(dim=-1, keepdim=True)

    out = torch.einsum("btkgs,bskh->btkgh", att, v_cache.float())
    return out.reshape(B, T, n_heads, head_size).to(q.dtype)
