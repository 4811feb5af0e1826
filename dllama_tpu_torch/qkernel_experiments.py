"""Candidate Q40 kernel variants, A/B'd on the card: the port of
``scripts/qkernel_experiments.py``.

Each variant computes ``x @ dequant(qt)`` for one Q40 matrix, is checked
against the dense dequantized product (:func:`check`, the JAX script's
tolerances) and timed with CUDA events over enough weight copies to defeat
the 50 MB L2, as a decode step finds its weights (:func:`timed`).

  A  K1 with ``nosub`` False (the subtracting kernel)
  B  K6 — the nosub dot, nibbles 0..15, no correction — plus the correction
     ``8 * (xs_lo @ s_lo + xs_hi @ s_hi)`` in torch f32 outside any kernel
  C  K1 with ``nosub`` True (correction folded into the kernel; the
     production path)
  D  K1 (subtracting) on scales rounded to bf16; stored f32, because K1
     reads f32 planes, so D moves the f32 bytes
  E  K7 — Q80-quantized activations times Q40 nibbles as an int32 dot per
     32-block, scaled afterwards (the reference's matmulQ40vQ80) — plus the
     same correction against the quantized x, in torch. On the card K7 is
     ``csrc/q40_int8_matmul.cu``: K1's decode-GEMV skeleton (a per-warp
     cp.async ring, 4 warps along K per 128-column strip, split-K summed
     in the kernel by :func:`int8_plan`) with each block's dot on the int8
     tensor cores, one launch a call, any T in row tiles of 8
  F  B with twice the output columns per CUDA block (1024; the card's
     stand-in for the TPU's 2048-lane tile)
  G  B with the correction reading cached bf16 copies of the scale planes
  S  K1 sub against nosub over 8 stacked layers taken as views

    python -m dllama_tpu_torch.qkernel_experiments [A|B|C|D|E|F|G|S|all] [K] [O]

(defaults all, 4096, 11008) on the card. :func:`main` also takes
``device="cpu"``, where it runs the plain versions and checks only.
"""

from __future__ import annotations

import math
import statistics
import sys

import numpy as np
import torch

from dllama_tpu_torch import kernels, resolve_device
from dllama_tpu_torch.ops import qmatmul
from dllama_tpu_torch.ops.qmatmul import QK, QuantTensor, _pad_cols


# ---------------------------------------------------------------------------
# K6 and K7: wrappers and plain versions
# ---------------------------------------------------------------------------

def q40_nosub_matmul_ref(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                         s_hi: torch.Tensor) -> torch.Tensor:
    """K6's function: ``sum_k bf16(x) * bf16(nibble * delta)`` in f32 with
    nibbles 0..15 and no correction, x zero-padded to the packed K."""
    xb = _pad_cols(x.to(torch.bfloat16), packed.shape[0] * 2).float()
    return qmatmul.q40_dot_ref(xb, packed, s_lo, s_hi, 0.0)


def q40_nosub_matmul(x: torch.Tensor, packed: torch.Tensor, s_lo: torch.Tensor,
                     s_hi: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """K6: ``csrc/q40_matmul.cu`` in its no-correction mode for a CUDA
    ``packed`` — K1's decode GEMV up to ``GEMV_MAX_T`` rows (``wide``: two
    column tiles a block, 1024 columns up to 4 rows), the tensor-core tile
    beyond in either mode — :func:`q40_nosub_matmul_ref` for a CPU one."""
    if packed.device.type == "cpu":
        return q40_nosub_matmul_ref(x, packed, s_lo, s_hi)
    if packed.device.type != "cuda":
        raise ValueError(f"q40_nosub_matmul: unsupported device {packed.device}")
    K2, O = packed.shape
    K = 2 * K2
    if s_lo.shape != (K // 64, O) or s_hi.shape != (K // 64, O) or packed.dtype != torch.uint8:
        raise ValueError("q40_nosub_matmul: planes disagree")
    qmatmul.check_operands("q40_nosub_matmul", x, packed, K, [s_lo, s_hi])
    xk = _pad_cols(x.to(torch.bfloat16), K).contiguous()
    T = xk.shape[0]
    if T > qmatmul.GEMV_MAX_T:  # both modes: the TPU's 2048-lane block is a tiling knob
        out = qmatmul.q40_tile(xk, packed, s_lo, s_hi, qmatmul.Q40_NOSUB_RAW)
    else:
        out = qmatmul.q40_gemv(xk, packed, s_lo, s_hi, qmatmul.Q40_NOSUB_RAW, wide=wide)
    kernels.launches["q40_nosub_matmul"] += 1
    return out


def q40_int8_matmul_ref(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
                        s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """K7's function: per 32-row block, the integer dot of int8 ``xq [T, K]``
    with the nibbles (0..15), times ``sx [T, K/32] * delta``, summed over
    blocks in f32. A block's dot is at most 60,960 in magnitude, so the f32
    matmuls here compute it exactly; only the order of the block sums
    differs from the kernel."""
    T, K = xq.shape
    nsb, O = s_lo.shape
    lo = (packed & 0xF).float().reshape(nsb, QK, O)
    hi = (packed >> 4).float().reshape(nsb, QK, O)
    xr = xq.float().reshape(T, nsb, 2, QK).transpose(0, 1)  # [nsb, T, 2, 32]
    d_lo = torch.bmm(xr[:, :, 0], lo)  # [nsb, T, O]
    d_hi = torch.bmm(xr[:, :, 1], hi)
    sxr = sx.reshape(T, nsb, 2).transpose(0, 1)  # [nsb, T, 2]
    return (d_lo * (sxr[:, :, 0:1] * s_lo[:, None])
            + d_hi * (sxr[:, :, 1:2] * s_hi[:, None])).sum(0)


#: output columns one K7 block covers: one 128-column strip, 4 warps along K
INT8_COLS = 128


def int8_plan(T: int, K: int, O: int, n_sm: int, per_sm: int) -> tuple[int, int, int]:
    """(row tiles, ksplit, rows per split) for K7 over T rows: tiles of up to
    ``GEMV_MAX_T`` rows (the mma's n of 8), each with
    ``qmatmul.gemv_plan``'s split of K over :data:`INT8_COLS`-column blocks,
    one wave of ``n_sm * per_sm`` resident blocks holding all tiles and
    splits. A function of the shape alone, so two calls sum alike."""
    tiles = math.ceil(T / qmatmul.GEMV_MAX_T)
    ksplit, rows = qmatmul.gemv_plan(min(T, qmatmul.GEMV_MAX_T), K, O, n_sm, per_sm,
                                     INT8_COLS, tiles)
    return tiles, ksplit, rows


def int8_blocks_per_sm(T: int) -> int:
    """K7's resident blocks per SM for T rows (a row tile of at most 8),
    from the CUDA occupancy calculator (cached)."""
    return qmatmul.occupancy("dllama_q40_int8_blocks_per_sm", min(T, qmatmul.GEMV_MAX_T))


def q40_int8_matmul(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
                    s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """K7: ``csrc/q40_int8_matmul.cu`` for a CUDA ``packed`` (one launch:
    the int8 tensor-core GEMV, K split by :func:`int8_plan` and the splits
    added in the kernel), :func:`q40_int8_matmul_ref` for a CPU one. ``xq``
    int8 [T, K] and ``sx`` f32 [T, K/32] at the packed K."""
    if packed.device.type == "cpu":
        return q40_int8_matmul_ref(xq, sx, packed, s_lo, s_hi)
    if packed.device.type != "cuda":
        raise ValueError(f"q40_int8_matmul: unsupported device {packed.device}")
    K2, O = packed.shape
    K = 2 * K2
    T = xq.shape[0]
    if xq.dtype != torch.int8 or xq.shape != (T, K) or sx.shape != (T, K // QK):
        raise ValueError(f"q40_int8_matmul: xq {tuple(xq.shape)} {xq.dtype}, "
                         f"sx {tuple(sx.shape)} vs packed K {K}")
    if s_lo.shape != (K // 64, O) or s_hi.shape != (K // 64, O) or packed.dtype != torch.uint8:
        raise ValueError("q40_int8_matmul: planes disagree")
    qmatmul.check_operands("q40_int8_matmul", xq, packed, K, [s_lo, s_hi])
    xq, sx = qmatmul._aligned(xq.contiguous()), sx.float().contiguous()
    tiles, ksplit, rows = int8_plan(T, K, O, kernels.sm_count(packed.device),
                                    int8_blocks_per_sm(T))
    out, partials = qmatmul._split_outputs(T, O, ksplit, packed.device)
    counters = kernels.counters(packed.device, tiles * math.ceil(O / INT8_COLS))
    with torch.cuda.device(packed.device):
        rc = kernels.lib().dllama_q40_int8_matmul(
            xq.data_ptr(), sx.data_ptr(), T, K, packed.data_ptr(), s_lo.data_ptr(),
            s_hi.data_ptr(), O, ksplit, rows, partials.data_ptr(), counters.data_ptr(),
            out.data_ptr(), kernels.stream_of(packed))
    kernels.check(rc, "q40_int8_matmul")
    kernels.launches["q40_int8_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# The variants: fn(x [T, K], qt) -> [T, O] f32
# ---------------------------------------------------------------------------

#: per-matrix derived planes (bf16-rounded scales), made once outside the
#: timed loop; each entry keeps its QuantTensor alive, so a recycled id()
#: can never alias another matrix's planes
_DERIVED: dict = {}


def _derived(qt: QuantTensor, tag: str, make):
    key = (id(qt), tag)
    if key not in _DERIVED or _DERIVED[key][0] is not qt:
        _DERIVED[key] = (qt, make())
    return _DERIVED[key][1]


def _correction(xs: torch.Tensor, s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """``8 * (xs_lo @ s_lo + xs_hi @ s_hi)`` from per-32-block sums ``xs``
    [T, K/32]: the exact recentering term the nosub dots leave out."""
    return 8.0 * (xs[:, 0::2] @ s_lo + xs[:, 1::2] @ s_hi)


def _nosub_plus_correction(x, qt, wide=False, s_lo=None, s_hi=None):
    xp = _pad_cols(x.to(torch.bfloat16), qt.k_padded)
    out = q40_nosub_matmul(xp, qt.w, qt.s, qt.s2, wide=wide)
    xs = xp.float().reshape(xp.shape[0], -1, QK).sum(-1)
    return out - _correction(xs, qt.s if s_lo is None else s_lo,
                             qt.s2 if s_hi is None else s_hi)


def variant_a(x, qt):
    return qmatmul.q40_matmul(x.to(torch.bfloat16), qt.w, qt.s, qt.s2, nosub=False)


def variant_b(x, qt):
    return _nosub_plus_correction(x, qt)


def variant_c(x, qt):
    return qmatmul.q40_matmul(x.to(torch.bfloat16), qt.w, qt.s, qt.s2, nosub=True)


def variant_d(x, qt):
    s_lo, s_hi = _derived(qt, "bf16-in-f32", lambda: (
        qt.s.to(torch.bfloat16).float(), qt.s2.to(torch.bfloat16).float()))
    return qmatmul.q40_matmul(x.to(torch.bfloat16), qt.w, s_lo, s_hi, nosub=False)


def quantize_q80_rows(x: torch.Tensor, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(xq int8 [T, K], sx f32 [T, K/32]): x quantized per 32-block as the
    JAX experiment does — ``absmax / 127`` scales, IEEE division,
    round-half-to-even — at the packed K."""
    xp = _pad_cols(x.float(), K)
    xb = xp.reshape(xp.shape[0], K // QK, QK)
    scale = xb.abs().amax(-1, keepdim=True) / 127.0
    xq = torch.round(xb / torch.where(scale == 0.0, torch.ones_like(scale), scale))
    return xq.to(torch.int8).reshape(xp.shape[0], K), scale[..., 0].contiguous()


def variant_e(x, qt):
    xq, sx = quantize_q80_rows(x, qt.k_padded)
    out = q40_int8_matmul(xq, sx, qt.w, qt.s, qt.s2)
    # the -8 correction against the same quantized x the kernel saw
    xs = sx * xq.float().reshape(xq.shape[0], -1, QK).sum(-1)
    return out - _correction(xs, qt.s, qt.s2)


def variant_f(x, qt):
    return _nosub_plus_correction(x, qt, wide=True)


def variant_g(x, qt):
    s_lo, s_hi = _derived(qt, "bf16", lambda: (qt.s.to(torch.bfloat16),
                                              qt.s2.to(torch.bfloat16)))
    return _nosub_plus_correction(x, qt, s_lo=s_lo.float(), s_hi=s_hi.float())


#: (fn, scale-plane byte multiplier), the JAX script's table: A reads the
#: scales once; B/C/E/F twice (the dot and the correction); D stores them
#: bf16 (0.5x) — here its rounded scales stay f32 planes, so D moves the 1x
#: bytes, which :func:`main` reports beside; G = f32 dot + bf16 correction
VARIANTS = {"A": (variant_a, 1.0), "B": (variant_b, 2.0),
            "C": (variant_c, 2.0), "D": (variant_d, 0.5),
            "E": (variant_e, 2.0), "F": (variant_f, 2.0),
            "G": (variant_g, 1.5)}


def nbytes_of(qt: QuantTensor, scale_mult: float) -> float:
    return qt.w.numel() + (qt.s.numel() + qt.s2.numel()) * 4 * scale_mult


def check(name: str, fn, qt: QuantTensor, K: int) -> tuple[bool, float]:
    """(passed, max-rel error) of ``fn`` against the dense product of the
    dequantized matrix, for two seeded rows: the JAX script's test and
    tolerances (3e-2; D 4e-2, its scales rounded to bf16)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, K)).astype(np.float32)
    dev = qt.w.device
    got = fn(torch.from_numpy(x).to(dev).to(torch.bfloat16), qt).float().cpu().numpy()
    want = x @ qmatmul.dequantize(qt)
    rel = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))
    tol = 3e-2 if name != "D" else 4e-2
    print(f"{name}: rel-err {rel:.2e}", flush=True)
    return rel < tol, rel


def _time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call of ``fn`` in ms, by CUDA events; a GPU
    sleep ahead of the series lets the host queue every launch first."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    events = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def copies_for_l2(qt: QuantTensor, nbytes: float, total: float = 200e6) -> list:
    """``qt`` and enough clones of its planes (at most 64) to rotate through
    more bytes than the 50 MB L2 holds."""
    n = min(64, max(1, math.ceil(total / nbytes)))
    return [qt] + [QuantTensor(qt.w.clone(), qt.s.clone(), qt.s2.clone(), qt.kind,
                               qt.k_logical) for _ in range(n - 1)]


def timed(name: str, fn, qts: list, K: int, nbytes: float) -> dict:
    """One decode row (T = 1) through ``fn``, rotating over ``qts``: ms per
    call and the bytes it must move per ms, as GB/s."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, K)).astype(np.float32))
    x = x.to(qts[0].w.device).to(torch.bfloat16)
    for qt in qts:  # derived planes are set-up, made before the timed series
        fn(x, qt)
    i = iter(range(1 << 30))
    ms = _time_ms(lambda: fn(x, qts[next(i) % len(qts)]))
    gbps = nbytes / (ms * 1e-3) / 1e9
    print(f"{name}: {ms:7.4f} ms/call -> {gbps:7.1f} GB/s", flush=True)
    return {"ms": ms, "gbps": gbps}


def stacked_ab(K: int, O: int, device, L: int = 8) -> list:
    """K1 with ``nosub`` False against True over L stacked layers, each call
    taking layer ``i % L`` as a view of the stacked planes (the decode
    loop's form): ms per layer-call and GB/s."""
    # random valid planes made on the card (as ``llama.random_quant_params``
    # makes them): the A/B times bytes only, and quantizing L matrices on
    # the host would take seconds each
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randint(0, 256, (L, K // 2, O), dtype=torch.uint8, device=device, generator=gen)
    s = torch.rand((L, K // 64, O), device=device, generator=gen) * 0.004
    s2 = torch.rand((L, K // 64, O), device=device, generator=gen) * 0.004
    x = torch.randn((1, K), device=device, generator=gen).to(torch.bfloat16)
    rows = []
    for name, nosub in (("S-sub", False), ("S-nosub", True)):
        i = iter(range(1 << 30))

        def call():
            j = next(i) % L
            qmatmul.q40_matmul(x, w[j], s[j], s2[j], nosub=nosub)

        ms = _time_ms(call, iters=8 * L)
        nb = (w.numel() + (s.numel() + s2.numel()) * 4 * (2.0 if nosub else 1.0)) / L
        gbps = nb / (ms * 1e-3) / 1e9
        print(f"{name}: {ms:7.4f} ms/layer-call -> {gbps:7.1f} GB/s", flush=True)
        rows.append({"variant": name, "ms": ms, "gbps": gbps, "bytes": nb})
    return rows


def main(argv=None, device=None) -> list:
    """Run the variants named by ``argv`` (``[which] [K] [O]``) on ``device``
    (the card unless the caller asks for the CPU, where it checks only).
    Returns one dict per variant; raises SystemExit(1) if a check fails."""
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    K = int(argv[1]) if len(argv) > 1 else 4096
    O = int(argv[2]) if len(argv) > 2 else 11008
    if which not in (*VARIANTS, "S", "all"):
        raise SystemExit(f"unknown variant {which!r}: one of {', '.join(VARIANTS)}, S, all")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rows = []
    if which in ("all", "S"):
        if on_card:
            rows += stacked_ab(K, O, dev)
        else:
            print("stacked A/B skipped: not on the card", flush=True)
        if which == "S":
            return rows
    qt = qmatmul.quantize_tensor(
        np.random.default_rng(0).standard_normal((K, O)).astype(np.float32) * 0.1, "q40", dev)
    qts = copies_for_l2(qt, nbytes_of(qt, 1.0)) if on_card else [qt]
    ok = True
    for name in (list(VARIANTS) if which == "all" else [which]):
        fn, scale_mult = VARIANTS[name]
        passed, rel = check(name, fn, qt, K)
        row = {"variant": name, "rel_err": rel, "ok": passed,
               "bytes": nbytes_of(qt, scale_mult)}
        if passed and on_card:
            row.update(timed(name, fn, qts, K, row["bytes"]))
            if name == "D":  # the f32 planes it really reads
                row["gbps_f32_scales"] = nbytes_of(qt, 1.0) / (row["ms"] * 1e-3) / 1e9
        ok = ok and passed
        rows.append(row)
    if not on_card:
        print("(CPU: plain versions, correctness only, no timing)", flush=True)
    if not ok:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
