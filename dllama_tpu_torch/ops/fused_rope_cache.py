"""Rope of q and K plus the K/V cache write of a decode step, in one kernel
launch per layer.

For each row (b, t) the launch rotates q into a new contiguous tensor in
the activation dtype (``ops.rope.apply_rope``'s bits), rotates K in f32,
casts it f32 -> activation dtype -> cache dtype, and writes exactly the
row's K and V into the stacked caches IN PLACE — the JAX kernel aliases the
caches input->output, the port owns them and writes them. The JAX package
computes q's rope in plain jnp beside its kernel, which XLA fuses on the
TPU; here it rides in the same launch. q, k and v are read where the
projections left them (the strided slices of the fused qkv output, or three
tensors), the angles straight from the f32 rope tables ``[R, hd/2]`` at
each row's own table row.

Three launch forms of one kernel, ``csrc/rope_cache.cu``, as the JAX
package's ``_launch`` has them, each with its own rule for the write row
and the angle row (S the cache length, R the table's rows):

* :func:`rope_cache_update`: one sequence of T rows at a host ``pos``,
  caches ``[L, S, kv, hd]``; row t written at ``clamp(pos, 0, S - T) + t``
  and rotated with that table row (the clamped slice of the table);
* :func:`rope_cache_update_batched`: B sequences of one row over caches
  ``[L, B, S, kv, hd]``, ``pos`` a device int32 vector the host never
  reads; row b written at ``clamp(pos[b], 0, S - 1)``, angle row
  ``clamp(pos[b], 0, R - 1)``;
* :func:`rope_cache_update_verify`: the speculative verify step, B
  sequences of T rows; row (b, t) written at ``clamp(pos[b], 0, S - T) +
  t`` but rotated with table row ``min(pos[b] + t, R - 1)`` — the two part
  near the end of the cache.

Each returns q rotated and checks its operands alike on every device; a
CPU cache takes the plain version (``*_ref``: ``apply_rope`` of q with the
table rows the form's rule gathers, then the cache write ``cache_write*_ref``,
the JAX kernel's function), a CUDA cache launches the kernel or raises.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops.rope import HALF, INTERLEAVED, apply_rope, rotate

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


# ---------------------------------------------------------------------------
# The cache write alone: the JAX kernel's function (K, V and gathered angles)
# ---------------------------------------------------------------------------

def cache_write_ref(k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                    style: str = INTERLEAVED) -> None:
    """k, v [T, kv, hd] (unrotated K); cos/sin [T, 1, hd/2]; caches
    [L, S, kv, hd], rows clamp(pos, 0, S - T).. written in place."""
    T = k.shape[0]
    start = _start(pos, k_cache.shape[1], T)
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, start:start + T] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, start:start + T] = cast_cache(v, v_cache.dtype)


def cache_write_batched_ref(k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                            style: str = INTERLEAVED) -> None:
    """k, v [B, kv, hd]; cos/sin [B, 1, hd/2]; caches [L, B, S, kv, hd];
    row b written at (layer, b, clamp(pos[b], 0, S - 1)) in place. ``pos``
    [B] stays on its device."""
    B, S = k_cache.shape[1], k_cache.shape[2]
    rows = torch.arange(B, device=k_cache.device)
    starts = torch.as_tensor(pos, device=k_cache.device).long().clamp(0, S - 1)
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, rows, starts] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, rows, starts] = cast_cache(v, v_cache.dtype)


def cache_write_verify_ref(k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                           style: str = INTERLEAVED) -> None:
    """k, v [B, T, kv, hd]; cos/sin [B, T, 1, hd/2]; caches [L, B, S, kv,
    hd]; row b's T rows written at (layer, b, s..s+T) with s = clamp(pos[b],
    0, S - T), in place. ``pos`` [B] stays on its device."""
    B, T = k.shape[:2]
    S = k_cache.shape[2]
    dev = k_cache.device
    starts = torch.as_tensor(pos, device=dev).long().clamp(0, S - T)
    slots = starts[:, None] + torch.arange(T, device=dev)  # [B, T]
    rows = torch.arange(B, device=dev)[:, None]
    rot = rotate(k.float(), cos.float(), sin.float(), style)
    k_cache[layer, rows, slots] = cast_cache(rot.to(k.dtype), k_cache.dtype)
    v_cache[layer, rows, slots] = cast_cache(v, v_cache.dtype)


# ---------------------------------------------------------------------------
# The three forms' plain versions: q's rope, then the cache write
# ---------------------------------------------------------------------------

def _row_angles(cos, sin, pos, T: int) -> tuple:
    """The batched and verify forms' angles: table rows clamp(pos[b] + t,
    0, R - 1) as [B, T, 1, hd/2] (the clamp JAX's gather makes)."""
    rows = (pos.long()[:, None] + torch.arange(T, device=pos.device)).clamp(0, cos.shape[0] - 1)
    return cos[rows][:, :, None], sin[rows][:, :, None]


def rope_cache_update_ref(q, k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                          style: str = INTERLEAVED) -> torch.Tensor:
    """The solo form in plain PyTorch: q [T, H, hd], k, v [T, kv, hd];
    cos/sin the tables [R, hd/2]; caches [L, S, kv, hd] updated in place.
    Returns q rotated [T, H, hd]."""
    T = q.shape[0]
    start = _start(pos, k_cache.shape[1], T)
    c, s = cos[start:start + T, None], sin[start:start + T, None]
    cache_write_ref(k, v, c, s, k_cache, v_cache, pos, layer, style)
    return apply_rope(q, c, s, style)


def rope_cache_update_batched_ref(q, k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                                  style: str = INTERLEAVED) -> torch.Tensor:
    """The batched form in plain PyTorch: q [B, H, hd], k, v [B, kv, hd];
    caches [L, B, S, kv, hd] updated in place. Returns q rotated."""
    c, s = (a[:, 0] for a in _row_angles(cos, sin, pos, 1))
    cache_write_batched_ref(k, v, c, s, k_cache, v_cache, pos, layer, style)
    return apply_rope(q, c, s, style)


def rope_cache_update_verify_ref(q, k, v, cos, sin, k_cache, v_cache, pos, layer: int,
                                 style: str = INTERLEAVED) -> torch.Tensor:
    """The verify form in plain PyTorch: q [B, T, H, hd], k, v [B, T, kv,
    hd]; caches [L, B, S, kv, hd] updated in place. Returns q rotated."""
    c, s = _row_angles(cos, sin, pos, q.shape[1])
    cache_write_verify_ref(k, v, c, s, k_cache, v_cache, pos, layer, style)
    return apply_rope(q, c, s, style)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check(what: str, q, k, v, cos, sin, k_cache, v_cache, layer: int, style: str,
           rows: tuple, S: int) -> None:
    """What every form requires, on every device: q [*rows, H, hd], k and v
    [*rows, kv, hd] matching the caches [L, *batch, S, kv, hd]; f32 tables
    [R, hd/2]; 1 <= T <= min(MAX_T, S); the dtypes the kernel takes; one
    device."""
    T = rows[-1]
    hd = q.shape[-1]
    L, kv, hd_c = k_cache.shape[0], k_cache.shape[-2], k_cache.shape[-1]
    if (q.dim() != len(rows) + 2 or tuple(q.shape[:-2]) != rows
            or k.shape != (*rows, kv, hd) or v.shape != k.shape or hd_c != hd or hd % 2
            or v_cache.shape != k_cache.shape or not 1 <= T <= min(MAX_T, S)
            or not 0 <= layer < L or cos.dim() != 2 or cos.shape[1] != hd // 2
            or sin.shape != cos.shape or cos.shape[0] < 1):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"cache {tuple(k_cache.shape)}, tables {tuple(cos.shape)}, "
                         f"layer {layer}")
    if (q.dtype not in ACT_KINDS or k.dtype != q.dtype or v.dtype != q.dtype
            or k_cache.dtype not in CACHE_KINDS or v_cache.dtype != k_cache.dtype
            or cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise TypeError(f"{what}: activations {q.dtype}/{k.dtype}/{v.dtype}, caches "
                        f"{k_cache.dtype}/{v_cache.dtype}, tables {cos.dtype}/{sin.dtype}")
    if style not in (INTERLEAVED, HALF):
        raise ValueError(f"unknown rope style {style!r}")
    if {t.device for t in (q, k, v, cos, sin, v_cache)} != {k_cache.device}:
        raise ValueError(f"{what}: operands on different devices")
    if k_cache.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {k_cache.device}")


def _check_pos(what: str, pos, B: int, device) -> None:
    if (not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32
            or pos.shape != (B,) or pos.device != device):
        raise ValueError(f"{what}: pos must be an int32 [B] tensor on the caches' device")


def _rows(what: str, x: torch.Tensor) -> torch.Tensor:
    """x [..., heads, hd] as [rows, heads * hd] without a copy: the kernel
    reads each row at a stride, its heads adjacent."""
    try:
        flat = x.view(-1, x.shape[-2] * x.shape[-1])
    except RuntimeError:
        flat = None
    if flat is None or flat.stride(1) != 1:
        raise ValueError(f"{what}: {tuple(x.shape)} at strides {x.stride()} is not rows of "
                         f"adjacent heads")
    return flat


def _launch(what: str, q, k, v, cos, sin, k_cache, v_cache, pos_dev, pos: int, layer: int,
            style: str, angle_at_write: bool, B: int = 0, row0: int = 0) -> torch.Tensor:
    """One launch over ``B`` sequences of T rows each (q [B * T rows, H, hd]
    in any row-strided layout), sequence b at cache row ``row0`` + b of the
    caches [L, Bc, S, kv, hd] (``B`` 0: all Bc); returns q rotated,
    contiguous."""
    H, hd = q.shape[-2:]
    _, Bc, S, kv, _ = k_cache.shape
    B = B or Bc
    if hd % 8:
        raise ValueError(f"{what}: head size {hd} (want a multiple of 8)")
    if not all(t.is_contiguous() for t in (k_cache, v_cache, cos, sin)):
        raise ValueError(f"{what}: caches and tables must be contiguous")
    qf, kf, vf = (_rows(what, x) for x in (q, k, v))
    q_out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(k_cache.device):
        rc = kernels.lib().dllama_rope_cache_update(
            qf.data_ptr(), qf.stride(0), kf.data_ptr(), kf.stride(0), vf.data_ptr(),
            vf.stride(0), cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), B, row0, Bc, qf.shape[0] // B, H, kv, hd, S,
            cos.shape[0], None if pos_dev is None else pos_dev.data_ptr(), int(pos),
            int(layer), int(style == HALF), int(angle_at_write), ACT_KINDS[q.dtype],
            CACHE_KINDS[k_cache.dtype], kernels.stream_of(k_cache))
    kernels.check(rc, what)
    return q_out


def rope_cache_update(q, k, v, cos, sin, k_cache, v_cache, pos: int, layer: int,
                      style: str = INTERLEAVED) -> torch.Tensor:
    """Solo decode: q [T, H, hd], k, v [T, kv, hd] (any row stride, e.g.
    slices of the fused qkv output); cos/sin the f32 tables [R >= S,
    hd/2]; caches [L, S, kv, hd]. Writes K/V at (layer, clamp(pos, 0, S -
    T)..) and returns q rotated with those rows' angles, [T, H, hd]. The
    B = 1 launch of the kernel."""
    what = "rope_cache_update"
    if k_cache.dim() != 4:
        raise ValueError(f"{what}: cache {tuple(k_cache.shape)}")
    _check(what, q, k, v, cos, sin, k_cache, v_cache, layer, style, (q.shape[0],),
           k_cache.shape[1])
    if cos.shape[0] < k_cache.shape[1]:
        raise ValueError(f"{what}: tables of {cos.shape[0]} rows for a cache of "
                         f"{k_cache.shape[1]}")
    if k_cache.device.type == "cpu":
        return rope_cache_update_ref(q, k, v, cos, sin, k_cache, v_cache, pos, layer, style)
    out = _launch(what, q, k, v, cos, sin, k_cache[:, None], v_cache[:, None], None, pos, layer,
                  style, True)
    kernels.launches["rope_cache_update"] += 1
    return out


def _check_rows(what: str, k_cache, B: int, row0: int) -> None:
    if not 0 <= row0 <= k_cache.shape[1] - B:
        raise ValueError(f"{what}: rows [{row0}, {row0 + B}) outside a cache of "
                         f"{k_cache.shape[1]}")


def rope_cache_update_batched(q, k, v, cos, sin, k_cache, v_cache, pos: torch.Tensor,
                              layer: int, style: str = INTERLEAVED,
                              row0: int = 0) -> torch.Tensor:
    """Batched decode: B independent rows, q [B, H, hd], k, v [B, kv, hd];
    row b rotated with table row clamp(pos[b], 0, R - 1) and landing at
    (layer, row0 + b, clamp(pos[b], 0, S - 1)) — the clamp the unfused
    scatter makes, so an overrun row leaves the same cache. ``pos`` int32
    [B] on the caches' device. ``row0``: the first of the cache's rows the
    B rows are (a microbatch of the overlap writes its rows of the whole
    cache in place). Returns q rotated, [B, H, hd]."""
    what = "rope_cache_update_batched"
    if k_cache.dim() != 5:
        raise ValueError(f"{what}: cache {tuple(k_cache.shape)}")
    B = q.shape[0]
    _check_rows(what, k_cache, B, row0)
    _check(what, q, k, v, cos, sin, k_cache, v_cache, layer, style, (B,), k_cache.shape[2])
    _check_pos(what, pos, B, k_cache.device)
    if k_cache.device.type == "cpu":
        rows = slice(row0, row0 + B)  # views: the plain version writes through them
        return rope_cache_update_batched_ref(q, k, v, cos, sin, k_cache[:, rows],
                                             v_cache[:, rows], pos, layer, style)
    out = _launch(what, q, k, v, cos, sin, k_cache, v_cache, pos.contiguous(), 0, layer, style,
                  False, B, row0)
    kernels.launches["rope_cache_update_batched"] += 1
    return out


def rope_cache_update_verify(q, k, v, cos, sin, k_cache, v_cache, pos: torch.Tensor,
                             layer: int, style: str = INTERLEAVED,
                             row0: int = 0) -> torch.Tensor:
    """Speculative verify: B sequences of T draft rows each (T <= MAX_T), q
    [B, T, H, hd], k, v [B, T, kv, hd]; row (b, t) rotated with table row
    min(pos[b] + t, R - 1) and landing at (layer, row0 + b, clamp(pos[b],
    0, S - T) + t), as the vmapped ``dynamic_update_slice`` clamps. ``pos``
    int32 [B] on the caches' device; ``row0`` as in
    :func:`rope_cache_update_batched`. Returns q rotated, [B, T, H, hd]."""
    what = "rope_cache_update_verify"
    if k_cache.dim() != 5 or q.dim() != 4:
        raise ValueError(f"{what}: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    B = q.shape[0]
    _check_rows(what, k_cache, B, row0)
    _check(what, q, k, v, cos, sin, k_cache, v_cache, layer, style, (B, q.shape[1]),
           k_cache.shape[2])
    _check_pos(what, pos, B, k_cache.device)
    if k_cache.device.type == "cpu":
        rows = slice(row0, row0 + B)
        return rope_cache_update_verify_ref(q, k, v, cos, sin, k_cache[:, rows],
                                            v_cache[:, rows], pos, layer, style)
    out = _launch(what, q, k, v, cos, sin, k_cache, v_cache, pos.contiguous(), 0, layer, style,
                  False, B, row0)
    kernels.launches["rope_cache_update_verify"] += 1
    return out
