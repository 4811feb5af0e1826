"""Grouped-query attention over a fixed-size KV cache — the prefill attention.

Semantics mirror the reference per-head loop
(`distributed-llama/src/llama2-tasks.cpp:54-94`): score = q.k / sqrt(head_size),
softmax over positions 0..pos+t (inclusive), weighted sum of V, all in f32.
Prefill processes T query positions at once under a causal mask. Decode
(T <= 16) takes ``ops.flash_decode`` instead, exactly where the JAX package's
flash-decode gate engages.
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
    T, n_heads, head_size = q.shape
    S, n_kv_heads, _ = k_cache.shape
    group = n_heads // n_kv_heads

    qf = q.float().reshape(T, n_kv_heads, group, head_size)
    kf = k_cache.float()
    vf = v_cache.float()

    scores = torch.einsum("tkgh,skh->tkgs", qf, kf) / torch.sqrt(
        torch.tensor(head_size, dtype=torch.float32, device=q.device))

    key_idx = torch.arange(S, device=q.device)[None, :]  # [1, S]
    query_pos = pos + torch.arange(T, device=q.device)[:, None]  # [T, 1]
    mask = key_idx <= query_pos  # [T, S]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.tensor(-1e30, dtype=torch.float32, device=q.device))

    att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    att = att / att.sum(dim=-1, keepdim=True)

    out = torch.einsum("tkgs,skh->tkgh", att, vf)
    return out.reshape(T, n_heads, head_size).to(q.dtype)
