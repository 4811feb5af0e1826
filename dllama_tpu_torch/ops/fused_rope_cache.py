"""Rope + KV-cache write for the decode step, in one kernel.

Rotates K in f32 with the cos/sin rows of positions pos..pos+T (interleaved
or half style, the single-rounding fma forms of ``ops.rope.rotate``), casts
f32 -> activation dtype -> cache dtype, and writes exactly T rows of K and V
into ``k_cache[layer, start:start+T]`` / ``v_cache[...]`` IN PLACE — the
JAX kernel aliases the caches input->output, the port owns them and writes
them. ``start`` is clamped to [0, S - T] the way ``dynamic_update_slice``
clamps.

``rope_cache_update`` launches ``csrc/rope_cache.cu`` for a CUDA cache and
runs ``rope_cache_update_ref`` for a CPU one.
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


def rope_cache_update(k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                      style: str = INTERLEAVED) -> tuple:
    """Rotate K and land K/V at (layer, pos..pos+T) in one pass; returns the
    (k_cache, v_cache) it updated in place."""
    if k_cache.device.type == "cpu":
        return rope_cache_update_ref(k, v, cos, sin, k_cache, v_cache, pos, layer, style)
    if k_cache.device.type != "cuda":
        raise ValueError(f"rope_cache_update: unsupported device {k_cache.device}")
    T, kv, hd = k.shape
    L, S, kv_c, hd_c = k_cache.shape
    if (v.shape != k.shape or v_cache.shape != k_cache.shape or (kv_c, hd_c) != (kv, hd)
            or hd % 2 or not 1 <= T <= min(MAX_T, S) or not 0 <= layer < L
            or cos.numel() != T * hd // 2 or sin.numel() != T * hd // 2):
        raise ValueError(f"rope_cache_update: k {tuple(k.shape)}, cache "
                         f"{tuple(k_cache.shape)}, cos {tuple(cos.shape)}, layer {layer}")
    act = ACT_KINDS.get(k.dtype)
    cache = CACHE_KINDS.get(k_cache.dtype)
    if act is None or v.dtype != k.dtype or cache is None or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"rope_cache_update: activations {k.dtype}/{v.dtype}, "
                        f"caches {k_cache.dtype}/{v_cache.dtype}")
    if style not in (INTERLEAVED, HALF):
        raise ValueError(f"unknown rope style {style!r}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("rope_cache_update: caches must be contiguous")
    devs = {t.device for t in (k, v, cos, sin, v_cache)}
    if devs != {k_cache.device}:
        raise ValueError("rope_cache_update: inputs on different devices")
    kc = k.contiguous()
    vc = v.contiguous()
    c = cos.float().contiguous()
    s = sin.float().contiguous()
    with torch.cuda.device(k_cache.device):
        rc = kernels.lib().dllama_rope_cache_update(
            kc.data_ptr(), vc.data_ptr(), c.data_ptr(), s.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), T, kv, hd, S,
            _start(pos, S, T), int(layer), int(style == HALF), act, cache,
            kernels.stream_of(k_cache))
    kernels.check(rc, "rope_cache_update")
    kernels.launches["rope_cache_update"] += 1
    return k_cache, v_cache
