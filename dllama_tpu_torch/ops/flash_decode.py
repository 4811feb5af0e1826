"""Flash-decode attention: read ONLY the live KV-cache prefix.

Online-softmax GQA decode attention for T <= 16 query rows over the stacked
cache ``[L, S, kv, hd]``, read in place at ``layer``. Query row t attends to
cache positions <= pos + t; masked scores are -1e30; scores are
``q . k * rsqrt(hd)`` and the softmax runs in f32; bf16, f32 and
float8_e4m3fn caches are upcast to f32. Only the positions < pos + T are
read, so the bytes per token scale with ``pos``, not ``seq_len``.

``flash_decode_attention`` launches ``csrc/flash_decode.cu`` for a CUDA
cache and runs ``flash_decode_attention_ref`` for a CPU one. The kernel masks
its own ragged last block, so ``S`` need not divide into blocks.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch import kernels

#: cache positions per online-softmax step of the plain version (the JAX
#: kernel's block)
BLOCK_S = 256
#: the most query rows a decode launch takes (spec-verify ceiling)
MAX_T = 16

#: cache dtype -> the kernel's cache_kind argument
CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def _scale(hd: int, device) -> torch.Tensor:
    return torch.rsqrt(torch.tensor(hd, dtype=torch.float32, device=device))


def flash_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: int, layer: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online softmax over
    ``BLOCK_S``-position blocks of the live prefix. q [T, H, hd] ->
    [T, H, hd] in q's dtype."""
    T, H, hd = q.shape
    _, S, kv, _ = k_cache.shape
    group = H // kv
    qr = q.float().reshape(T, kv, group, hd).permute(1, 0, 2, 3).reshape(kv, T * group, hd)
    qpos = pos + torch.arange(T * group, device=q.device) // group  # [Tg]
    scale = _scale(hd, q.device)
    m = torch.full((kv, T * group, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((kv, T * group, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((kv, T * group, hd), dtype=torch.float32, device=q.device)
    live = min(pos + T, S)
    for b0 in range(0, live, BLOCK_S):
        k = k_cache[layer, b0:b0 + BLOCK_S].float()  # [n, kv, hd]
        v = v_cache[layer, b0:b0 + BLOCK_S].float()
        s = torch.einsum("hrd,nhd->hrn", qr, k) * scale
        key_idx = b0 + torch.arange(k.shape[0], device=q.device)
        s = torch.where(key_idx[None, None, :] <= qpos[None, :, None], s,
                        torch.tensor(-1e30, dtype=torch.float32, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hrn,nhd->hrd", p, v)
        m = m_new
    out = (acc / l).reshape(kv, T, group, hd).permute(1, 0, 2, 3).reshape(T, H, hd)
    return out.to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: int, layer: int) -> torch.Tensor:
    """Online-softmax decode attention over the live cache prefix only.

    q [T, n_heads, hd]; caches [L, S, n_kv_heads, hd]. Returns
    [T, n_heads, hd] in q's dtype, matching
    ``gqa_attention(q, k_cache[layer], v_cache[layer], pos)``."""
    if k_cache.device.type == "cpu":
        return flash_decode_attention_ref(q, k_cache, v_cache, pos, layer)
    if k_cache.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {k_cache.device}")
    T, H, hd = q.shape
    L, S, kv, hd_c = k_cache.shape
    if (v_cache.shape != k_cache.shape or hd_c != hd or H % kv or not 1 <= T <= MAX_T
            or not 0 <= layer < L or not 0 <= pos < S or hd > 256 or hd % 16):
        raise ValueError(
            f"flash_decode_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"pos {pos}, layer {layer} (want T <= {MAX_T}, hd % 16 == 0, hd <= 256)")
    kind = CACHE_KINDS.get(k_cache.dtype)
    if kind is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"flash_decode_attention: cache dtype {k_cache.dtype} "
                        f"(want one of {sorted(map(str, CACHE_KINDS))})")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode_attention: caches must be contiguous")
    if q.device != k_cache.device or v_cache.device != k_cache.device:
        raise ValueError("flash_decode_attention: q and caches on different devices")
    qf = q.float().contiguous()
    out = torch.empty((T, H, hd), dtype=torch.float32, device=q.device)
    scale = float(_scale(hd, "cpu"))
    with torch.cuda.device(q.device):
        rc = kernels.lib().dllama_flash_decode(
            qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            T, H, hd, S, kv, int(pos), int(layer), scale, kind, kernels.stream_of(q))
    kernels.check(rc, "flash_decode_attention")
    kernels.launches["flash_decode"] += 1
    return out.to(q.dtype)
