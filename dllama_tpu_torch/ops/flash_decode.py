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

The kernel splits the live prefix across blocks (flash-decoding):
:func:`split_plan` cuts it into ``n_split`` chunks, each block computes the
online-softmax partial ``(m, l, acc)`` of its chunk, and the partials are
merged in split order. :func:`flash_decode_split_ref` is that computation
step by step in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from dllama_tpu_torch import kernels

#: cache positions per online-softmax step of the plain version (the JAX
#: kernel's block)
BLOCK_S = 256
#: the most query rows a decode launch takes (spec-verify ceiling)
MAX_T = 16

#: q dtype -> the kernel's act_kind argument (other dtypes go through f32)
ACT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
#: cache dtype -> the kernel's cache_kind argument
CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

#: cache positions per shared-memory tile of the kernel (one per lane)
TILE = 32
#: the most chunks the live prefix is cut into
MAX_SPLITS = 64


def _scale(hd: int, device) -> torch.Tensor:
    return torch.rsqrt(torch.tensor(hd, dtype=torch.float32, device=device))


def _rows(q: torch.Tensor, kv: int, pos: int) -> tuple:
    """q [T, H, hd] -> (f32 query rows [kv, T * group, hd], the last position
    each row attends to [T * group])."""
    T, H, hd = q.shape
    group = H // kv
    qr = q.float().reshape(T, kv, group, hd).permute(1, 0, 2, 3).reshape(kv, T * group, hd)
    return qr, pos + torch.arange(T * group, device=q.device) // group


def _heads(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[kv, T * group, hd] -> [T, H, hd] in q's dtype."""
    T, H, hd = q.shape
    kv = out.shape[0]
    return out.reshape(kv, T, H // kv, hd).permute(1, 0, 2, 3).reshape(T, H, hd).to(q.dtype)


def _online_softmax(qr, qpos, k_cache, v_cache, layer: int, c0: int, c1: int,
                    block: int) -> tuple:
    """The online softmax of the query rows over cache positions [c0, c1) in
    ``block``-position steps: (m, l, acc), with masked scores -1e30 and a
    row that sees no position keeping (-1e30, 0, 0)."""
    kv, R, hd = qr.shape
    dev = qr.device
    scale = _scale(hd, dev)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    m = torch.full((kv, R, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((kv, R, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((kv, R, hd), dtype=torch.float32, device=dev)
    for n0 in range(c0, c1, block):
        n1 = min(c1, n0 + block)
        k = k_cache[layer, n0:n1].float()  # [n, kv, hd]
        v = v_cache[layer, n0:n1].float()
        s = torch.einsum("hrd,nhd->hrn", qr, k) * scale
        valid = (n0 + torch.arange(n1 - n0, device=dev))[None, None, :] <= qpos[None, :, None]
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros((), device=dev))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hrn,nhd->hrd", p, v)
        m = m_new
    return m, l, acc


def flash_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: int, layer: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online softmax over
    ``BLOCK_S``-position blocks of the live prefix. q [T, H, hd] ->
    [T, H, hd] in q's dtype."""
    _, S, kv, _ = k_cache.shape
    qr, qpos = _rows(q, kv, pos)
    _, l, acc = _online_softmax(qr, qpos, k_cache, v_cache, layer, 0, min(pos + q.shape[0], S),
                                BLOCK_S)
    return _heads(acc / l, q)


def split_plan(live: int, kv: int, n_sm: int) -> tuple[int, int]:
    """(n_split, chunk) for the kernel's grid (kv, n_split): the live prefix
    of ``live`` positions is cut into ``n_split`` chunks of ``chunk``
    positions (the last may be shorter). Enough chunks that ``kv * n_split``
    blocks give every SM two, but no more chunks than 32-position tiles, and
    at most :data:`MAX_SPLITS`; every chunk holds at least one position."""
    n = max(1, min(math.ceil(live / TILE), math.ceil(2 * n_sm / kv), MAX_SPLITS))
    chunk = math.ceil(live / n)
    return math.ceil(live / chunk), chunk


def flash_decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: int, layer: int, n_split: int) -> torch.Tensor:
    """The kernel's computation step by step: the live prefix cut into
    ``n_split`` chunks of ``ceil(live / n_split)`` positions, each chunk's
    online softmax over 32-position tiles giving a partial ``(m, l, acc)``
    (a row that sees no position of a chunk keeps ``(-1e30, 0, 0)``), and
    the partials merged in split order: ``M = max m``, ``f = exp(m - M)``,
    ``out = sum(f * acc) / sum(f * l)``. q [T, H, hd] -> [T, H, hd] in q's
    dtype."""
    _, S, kv, _ = k_cache.shape
    qr, qpos = _rows(q, kv, pos)
    live = min(pos + q.shape[0], S)
    chunk = math.ceil(live / n_split)
    parts = [_online_softmax(qr, qpos, k_cache, v_cache, layer, c0, min(live, c0 + chunk), TILE)
             for c0 in range(0, live, chunk)]
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    lsum = torch.zeros_like(mx)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:  # split order
        f = torch.exp(m - mx)
        lsum = lsum + l * f
        num = num + acc * f
    return _heads(num / lsum, q)


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
    qk = (q if q.dtype in ACT_KINDS else q.float()).contiguous()
    out = torch.empty((T, H, hd), dtype=qk.dtype, device=q.device)
    scale = float(_scale(hd, "cpu"))
    n_split, chunk = split_plan(min(pos + T, S), kv, kernels.sm_count(q.device))
    R = T * (H // kv)
    part_acc = part_ml = out  # unused with one chunk
    if n_split > 1:
        part_acc = torch.empty((kv, n_split, R, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((kv, n_split, R, 2), dtype=torch.float32, device=q.device)
    counters = kernels.counters(q.device, kv)
    with torch.cuda.device(q.device):
        rc = kernels.lib().dllama_flash_decode(
            qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            T, H, hd, S, kv, int(pos), int(layer), scale, ACT_KINDS[qk.dtype], kind,
            n_split, chunk, part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(),
            kernels.stream_of(q))
    kernels.check(rc, "flash_decode_attention")
    kernels.launches["flash_decode"] += 1
    return out.to(q.dtype)
