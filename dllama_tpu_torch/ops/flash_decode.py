"""Flash-decode attention: read ONLY the live KV-cache prefix.

Online-softmax GQA decode attention for T <= 16 query rows over the stacked
cache ``[L, S, kv, hd]``, read in place at ``layer``. Query row t attends to
cache positions <= pos + t; masked scores are -1e30; scores are
``q . k * rsqrt(hd)`` and the softmax runs in f32; bf16, f32 and
float8_e4m3fn caches are upcast to f32. Only the positions < pos + T are
read, so the bytes per token scale with ``pos``, not ``seq_len``.

Two launch forms of one kernel, ``csrc/flash_decode.cu``, as the JAX
package's ``_launch`` has them: :func:`flash_decode_attention` (one sequence,
a host ``pos``) and :func:`flash_decode_attention_batched` (B sequences of
one token over caches ``[L, B, S, kv, hd]``, each at its own position read
from a device int32 vector; row b reads only its own prefix 0..pos[b]). Each
runs its plain version (``*_ref``) for a CPU cache. The kernel masks its own
ragged last block, so ``S`` need not divide into blocks.

The kernel splits each row's live prefix across blocks (flash-decoding):
:func:`split_plan` cuts it into chunks, each block computes the
online-softmax partial ``(m, l, acc)`` of its chunk, and the partials are
merged in split order. :func:`flash_decode_split_ref` and
:func:`flash_decode_split_batched_ref` are that computation step by step in
plain PyTorch.
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


def max_splits(heads: int, n_sm: int) -> int:
    """The most chunks a row's live prefix is cut into when ``heads``
    (sequence, kv head) pairs share the card: enough that ``heads`` times
    that many blocks give every SM two, at most :data:`MAX_SPLITS`."""
    return max(1, min(math.ceil(2 * n_sm / heads), MAX_SPLITS))


def n_chunks(live: int, max_split: int) -> int:
    """How many chunks a row of ``live`` positions is planned in: no more
    than its 32-position tiles, at most ``max_split``, at least one. The
    kernel repeats this rule for each row from its own live length (and
    clamps it to the grid's ``n_split``)."""
    return max(1, min(math.ceil(live / TILE), max_split))


def chunk_plan(live: int, max_split: int) -> tuple[int, int]:
    """(n_split, chunk) for a row of ``live`` positions cut into
    :func:`n_chunks` chunks of ``chunk`` positions (the last may be
    shorter): ``n_split`` is how many of them hold a position."""
    chunk = math.ceil(live / n_chunks(live, max_split))
    return math.ceil(live / chunk), chunk


def split_plan(live: int, heads: int, n_sm: int) -> tuple[int, int]:
    """:func:`chunk_plan` of a row of ``live`` positions when ``heads``
    (sequence, kv head) pairs share the grid: at most :func:`max_splits`
    chunks."""
    return chunk_plan(live, max_splits(heads, n_sm))


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


def _row_positions(pos, B: int, S: int) -> list:
    """Host ints of a [B] position vector, clamped into [0, S - 1] as the
    kernel clamps them (reading a device vector syncs: plain versions only)."""
    got = [int(p) for p in torch.as_tensor(pos).reshape(-1).tolist()]
    if len(got) != B:
        raise ValueError(f"{len(got)} positions for {B} sequences")
    return [min(max(p, 0), S - 1) for p in got]


def flash_decode_attention_batched_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                       v_cache: torch.Tensor, pos, layer: int) -> torch.Tensor:
    """The batched form's function in plain PyTorch, row by row:
    :func:`flash_decode_attention_ref` of row b at its own position. q
    [B, H, hd], caches [L, B, S, kv, hd], pos [B] -> [B, H, hd]."""
    B, S = k_cache.shape[1], k_cache.shape[2]
    return torch.cat([flash_decode_attention_ref(q[b:b + 1], k_cache[:, b], v_cache[:, b], p,
                                                 layer)
                      for b, p in enumerate(_row_positions(pos, B, S))])


def flash_decode_split_batched_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, pos, layer: int,
                                   max_split: int) -> torch.Tensor:
    """The batched kernel's computation step by step: row b's live prefix
    cut into its own :func:`n_chunks` chunks (:func:`flash_decode_split_ref`).
    The grid's trailing empty chunks weigh exactly 0 in the merge and are
    left out. q [B, H, hd] -> [B, H, hd]."""
    B, S = k_cache.shape[1], k_cache.shape[2]
    out = []
    for b, p in enumerate(_row_positions(pos, B, S)):
        out.append(flash_decode_split_ref(q[b:b + 1], k_cache[:, b], v_cache[:, b], p, layer,
                                          n_chunks(p + 1, max_split)))
    return torch.cat(out)


def _launch(what: str, q, k_cache, v_cache, pos_dev, pos: int, layer: int, n_split: int,
            max_split: int) -> torch.Tensor:
    """Validate and make one launch of the kernel: q [B, T, H, hd], caches
    [L, B, S, kv, hd], row b at ``pos_dev[b]`` (device int32 [B]) or, with
    ``pos_dev`` None, every row at ``pos``; the grid (kv, n_split, B).
    Returns [B, T, H, hd] in q's dtype."""
    B, T, H, hd = q.shape
    L, Bc, S, kv, hd_c = k_cache.shape
    if (v_cache.shape != k_cache.shape or Bc != B or hd_c != hd or H % kv
            or not 1 <= T <= MAX_T or not 0 <= layer < L or hd > 256 or hd % 16):
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, layer {layer} "
            f"(want T <= {MAX_T}, hd % 16 == 0, hd <= 256)")
    kind = CACHE_KINDS.get(k_cache.dtype)
    if kind is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{what}: cache dtype {k_cache.dtype} "
                        f"(want one of {sorted(map(str, CACHE_KINDS))})")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous")
    if q.device != k_cache.device or v_cache.device != k_cache.device:
        raise ValueError(f"{what}: q and caches on different devices")
    qk = (q if q.dtype in ACT_KINDS else q.float()).contiguous()
    out = torch.empty((B, T, H, hd), dtype=qk.dtype, device=q.device)
    scale = float(_scale(hd, "cpu"))
    R = T * (H // kv)
    part_acc = part_ml = out  # unused with one chunk
    if n_split > 1:
        part_acc = torch.empty((B, kv, n_split, R, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, kv, n_split, R, 2), dtype=torch.float32, device=q.device)
    counters = kernels.counters(q.device, B * kv)
    with torch.cuda.device(q.device):
        rc = kernels.lib().dllama_flash_decode(
            qk.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            B, T, H, hd, S, kv, None if pos_dev is None else pos_dev.data_ptr(), int(pos),
            int(layer), scale, ACT_KINDS[qk.dtype], kind, n_split, max_split,
            part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(),
            kernels.stream_of(q))
    kernels.check(rc, what)
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
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"flash_decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    T, _, _ = q.shape
    _, S, kv, _ = k_cache.shape
    if not 0 <= pos < S:
        raise ValueError(f"flash_decode_attention: pos {pos} outside the cache of {S}")
    n_sm = kernels.sm_count(q.device)
    n_split, _ = split_plan(min(pos + T, S), kv, n_sm)
    out = _launch("flash_decode_attention", q[None], k_cache[:, None], v_cache[:, None], None,
                  pos, layer, n_split, max_splits(kv, n_sm))
    kernels.launches["flash_decode"] += 1
    return out[0]


def flash_decode_attention_batched(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, pos: torch.Tensor, layer: int,
                                   bound: int | None = None) -> torch.Tensor:
    """Batched decode: B independent sequences of one token, each reading
    ONLY its own live prefix 0..pos[b] (not max(pos)).

    q [B, n_heads, hd]; caches [L, B, S, n_kv_heads, hd]; ``pos`` int32 [B]
    on the caches' device (never read back by the host). ``bound``: a host
    upper bound of every row's ``pos + 1`` (default S); it sizes the grid
    and nothing else — a row's arithmetic depends on its own position and B
    only, so its bits do not depend on its neighbours or on ``bound``. A
    ``bound`` below some row's ``pos + 1`` is still right for that row: the
    kernel cuts it into no more chunks than the grid has, so the row reads
    its whole prefix (in another summation order).
    Positions are clamped into [0, S - 1]. Returns [B, n_heads, hd] in q's
    dtype, matching ``vmap(gqa_attention)`` over the per-row slabs."""
    if k_cache.device.type == "cpu":
        return flash_decode_attention_batched_ref(q, k_cache, v_cache, pos, layer)
    if k_cache.device.type != "cuda":
        raise ValueError(f"flash_decode_attention_batched: unsupported device "
                         f"{k_cache.device}")
    if q.dim() != 3 or k_cache.dim() != 5:
        raise ValueError(f"flash_decode_attention_batched: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    B = q.shape[0]
    _, _, S, kv, _ = k_cache.shape
    if (not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32
            or pos.shape != (B,) or pos.device != k_cache.device):
        raise ValueError("flash_decode_attention_batched: pos must be an int32 [B] tensor "
                         "on the caches' device")
    bound = S if bound is None else min(max(int(bound), 1), S)
    n_sm = kernels.sm_count(q.device)
    max_split = max_splits(B * kv, n_sm)
    out = _launch("flash_decode_attention_batched", q[:, None], k_cache, v_cache,
                  pos.contiguous(), 0, layer, n_chunks(bound, max_split), max_split)
    kernels.launches["flash_decode_batched"] += 1
    return out[:, 0]
