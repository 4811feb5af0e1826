"""Rope + KV-cache write for the decode step, in one kernel.

Rotates K in f32 with the cos/sin rows of positions pos..pos+T (interleaved
or half style, the single-rounding fma forms of ``ops.rope.rotate``), casts
f32 -> activation dtype -> cache dtype, and writes exactly T rows of K and V
into ``k_cache[layer, start:start+T]`` / ``v_cache[...]`` IN PLACE — the
JAX kernel aliases the caches input->output, the port owns them and writes
them. ``start`` is clamped to [0, S - T] the way ``dynamic_update_slice``
clamps.

Three launch forms of one kernel, ``csrc/rope_cache.cu``, as the JAX
package's ``_launch`` has them: :func:`rope_cache_update` (one sequence, T
rows at a host ``pos``, caches ``[L, S, kv, hd]``),
:func:`rope_cache_update_batched` (B sequences of one row over caches
``[L, B, S, kv, hd]``, row b at ``clamp(pos[b], 0, S - 1)`` with ``pos`` a
device int32 vector the host never reads) and
:func:`rope_cache_update_verify` (the speculative verify step: B sequences
of T rows each, row b at ``clamp(pos[b], 0, S - T)``). Each runs its plain
version (``*_ref``) for a CPU cache.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops.rope import HALF, INTERLEAVED, rotate

#: the most rows a decode launch writes (spec-verify ceiling)
MAX_T = 16

#: float8_e4m3fn has no infinity: values that round past 448 become NaN in
#: the reference's cast (torch's own cast saturates to +-448 instead)
_F8_OVERFLOW = 464.0

ACT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def cast_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` with the JAX package's float8_e4m3fn semantics: an
    out-of-range value (|x| > 464, or inf) becomes NaN, not +-448."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.float()
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=x.device)
    return torch.where(xf.abs() <= _F8_OVERFLOW, xf, nan).to(dtype)


def _start(pos: int, S: int, T: int) -> int:
    return min(max(int(pos), 0), S - T)


def rope_cache_update_ref(k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                          style: str = INTERLEAVED) -> tuple:
    """The kernel's function in plain PyTorch. k, v [T, kv, hd] (unrotated
    K); cos/sin [T, 1, hd/2]; caches [L, S, kv, hd], updated in place."""
    T = k.shape[0]
    start = _start(pos, k_cache.shape[1], T)
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, start:start + T] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, start:start + T] = cast_cache(v, v_cache.dtype)
    return k_cache, v_cache


def _launch(what: str, k, v, cos, sin, k_cache, v_cache, pos_dev, pos: int, layer: int,
            style: str) -> None:
    """One launch: k, v [B, T, kv, hd]; cos/sin [B, T, 1, hd/2]; caches
    [L, B, S, kv, hd] written in place at rows clamp(start, 0, S - T), the
    start ``pos_dev[b]`` (device int32 [B]) or, with ``pos_dev`` None,
    ``pos`` for every row."""
    B, T, kv, hd = k.shape
    L, Bc, S, kv_c, hd_c = k_cache.shape
    if (v.shape != k.shape or v_cache.shape != k_cache.shape or (Bc, kv_c, hd_c) != (B, kv, hd)
            or hd % 2 or not 1 <= T <= min(MAX_T, S) or not 0 <= layer < L
            or cos.numel() != B * T * hd // 2 or sin.numel() != B * T * hd // 2):
        raise ValueError(f"{what}: k {tuple(k.shape)}, cache {tuple(k_cache.shape)}, "
                         f"cos {tuple(cos.shape)}, layer {layer}")
    act = ACT_KINDS.get(k.dtype)
    cache = CACHE_KINDS.get(k_cache.dtype)
    if act is None or v.dtype != k.dtype or cache is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{what}: activations {k.dtype}/{v.dtype}, "
                        f"caches {k_cache.dtype}/{v_cache.dtype}")
    if style not in (INTERLEAVED, HALF):
        raise ValueError(f"unknown rope style {style!r}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous")
    devs = {t.device for t in (k, v, cos, sin, v_cache)}
    if devs != {k_cache.device}:
        raise ValueError(f"{what}: inputs on different devices")
    kc = k.contiguous()
    vc = v.contiguous()
    c = cos.float().contiguous()
    s = sin.float().contiguous()
    with torch.cuda.device(k_cache.device):
        rc = kernels.lib().dllama_rope_cache_update(
            kc.data_ptr(), vc.data_ptr(), c.data_ptr(), s.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), B, T, kv, hd, S,
            None if pos_dev is None else pos_dev.data_ptr(), int(pos), int(layer),
            int(style == HALF), act, cache, kernels.stream_of(k_cache))
    kernels.check(rc, what)


def rope_cache_update(k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                      style: str = INTERLEAVED) -> tuple:
    """Rotate K and land K/V at (layer, pos..pos+T) in one pass; returns the
    (k_cache, v_cache) it updated in place. The B = 1 launch of the kernel."""
    if k_cache.device.type == "cpu":
        return rope_cache_update_ref(k, v, cos, sin, k_cache, v_cache, pos, layer, style)
    if k_cache.device.type != "cuda":
        raise ValueError(f"rope_cache_update: unsupported device {k_cache.device}")
    if k.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"rope_cache_update: k {tuple(k.shape)}, cache {tuple(k_cache.shape)}")
    T = k.shape[0]
    _launch("rope_cache_update", k[None], v[None], cos, sin, k_cache[:, None],
            v_cache[:, None], None, _start(pos, k_cache.shape[1], T), layer, style)
    kernels.launches["rope_cache_update"] += 1
    return k_cache, v_cache


def _check_pos(what: str, pos, B: int, device) -> None:
    if (not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32
            or pos.shape != (B,) or pos.device != device):
        raise ValueError(f"{what}: pos must be an int32 [B] tensor on the caches' device")


def rope_cache_update_batched_ref(k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                                  style: str = INTERLEAVED) -> tuple:
    """The batched form's function in plain PyTorch: k, v [B, kv, hd]; cos/sin
    [B, 1, hd/2]; caches [L, B, S, kv, hd]; row b written at (layer, b,
    clamp(pos[b], 0, S - 1)) in place. ``pos`` [B] stays on its device."""
    B, S = k_cache.shape[1], k_cache.shape[2]
    rows = torch.arange(B, device=k_cache.device)
    starts = torch.as_tensor(pos, device=k_cache.device).long().clamp(0, S - 1)
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, rows, starts] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, rows, starts] = cast_cache(v, v_cache.dtype)
    return k_cache, v_cache


def rope_cache_update_batched(k, v, cos, sin, k_cache, v_cache, pos: torch.Tensor, layer: int,
                              style: str = INTERLEAVED) -> tuple:
    """Batched decode: B independent rows, row b rotated with its own angle
    and landing at (layer, b, clamp(pos[b], 0, S - 1)) — the clamp the
    unfused scatter makes, so an overrun row leaves the same cache. ``pos``
    int32 [B] on the caches' device. Returns the (k_cache, v_cache) it
    updated in place."""
    if k_cache.device.type == "cpu":
        return rope_cache_update_batched_ref(k, v, cos, sin, k_cache, v_cache, pos, layer, style)
    if k_cache.device.type != "cuda":
        raise ValueError(f"rope_cache_update_batched: unsupported device {k_cache.device}")
    if k.dim() != 3 or k_cache.dim() != 5:
        raise ValueError(f"rope_cache_update_batched: k {tuple(k.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    _check_pos("rope_cache_update_batched", pos, k.shape[0], k_cache.device)
    _launch("rope_cache_update_batched", k[:, None], v[:, None], cos, sin, k_cache, v_cache,
            pos.contiguous(), 0, layer, style)
    kernels.launches["rope_cache_update_batched"] += 1
    return k_cache, v_cache


def rope_cache_update_verify_ref(k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                                 style: str = INTERLEAVED) -> tuple:
    """The verify form's function in plain PyTorch: k, v [B, T, kv, hd];
    cos/sin [B, T, 1, hd/2]; caches [L, B, S, kv, hd]; row b's T rows
    written at (layer, b, s..s+T) with s = clamp(pos[b], 0, S - T), in
    place. ``pos`` [B] stays on its device."""
    B, T = k.shape[:2]
    S = k_cache.shape[2]
    dev = k_cache.device
    starts = torch.as_tensor(pos, device=dev).long().clamp(0, S - T)
    slots = starts[:, None] + torch.arange(T, device=dev)  # [B, T]
    rows = torch.arange(B, device=dev)[:, None]
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, rows, slots] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, rows, slots] = cast_cache(v, v_cache.dtype)
    return k_cache, v_cache


def rope_cache_update_verify(k, v, cos, sin, k_cache, v_cache, pos: torch.Tensor, layer: int,
                             style: str = INTERLEAVED) -> tuple:
    """Speculative verify: B sequences of T draft rows each (T <= MAX_T),
    row b's rows rotated with their own angles and landing at (layer, b,
    s..s+T) with s = clamp(pos[b], 0, S - T), as the vmapped
    ``dynamic_update_slice`` clamps. k, v [B, T, kv, hd]; cos/sin [B, T, 1,
    hd/2]; ``pos`` int32 [B] on the caches' device. Returns the (k_cache,
    v_cache) it updated in place."""
    if k_cache.device.type == "cpu":
        return rope_cache_update_verify_ref(k, v, cos, sin, k_cache, v_cache, pos, layer, style)
    if k_cache.device.type != "cuda":
        raise ValueError(f"rope_cache_update_verify: unsupported device {k_cache.device}")
    if k.dim() != 4 or k_cache.dim() != 5:
        raise ValueError(f"rope_cache_update_verify: k {tuple(k.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    _check_pos("rope_cache_update_verify", pos, k.shape[0], k_cache.device)
    _launch("rope_cache_update_verify", k, v, cos, sin, k_cache, v_cache, pos.contiguous(), 0,
            layer, style)
    kernels.launches["rope_cache_update_verify"] += 1
    return k_cache, v_cache
