#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It imports
nothing of JAX or of the JAX package. Phases (any failure exits non-zero):

0. The card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of the port's CUDA kernels from ``dllama_tpu_torch/csrc``, with
   ptxas's registers, shared memory and spills for each instance of the
   decode GEMVs, K5 and K7 (and every kernel that spills).
1. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (Llama-3-8B widths), with its stated tolerance, and timed
   with CUDA events (median of 30 launches queued behind a GPU sleep, so
   host launch overhead is not counted; weights rotate through enough copies
   to defeat the 50 MB L2, as a decode step finds them cold) beside its
   bound — the larger of bytes over 3.35 TB/s and operations over the
   card's peak for their type — its plain version and, where one PyTorch
   call computes the same function, that call. The Q40 (K1+K2) and Q80 (K3)
   dequant-matmuls run at T = 1 (decode), 128 (prefill) and 512 (the
   tensor-core tile where bytes stop bounding; timed at the four layer
   widths), and at the batched step's T = 4 and 8 (timed, the kernel beside
   its bound and the library call), each with the fused-norm epilogue too,
   which must equal the unfused kernel bit for bit; each call's route
   (decode GEMV or tile), its split or tile plan and its error over the
   tolerance are logged; K1, K3 and flash decode (K4: every cache dtype,
   T in {1, 4, 16}, its grid logged, timed at pos 1000 and 116) must repeat
   their bits on the same inputs; the experiment kernels K6 and K7 run at
   the variant shootout's matrix and the Llama-3-8B widths (K7 also at T =
   3, 8 and 12, repeating its bits, one CUDA launch a call). The solo K4 is
   the one-row launch of the batched kernel; its time is logged beside its
   time before that (``SOLO_MS_BEFORE``). The batched K4 (every cache
   dtype at B = 1, 4 and 8, rows at mixed positions from 0 to S - 1, NaN
   past each row's prefix, two launches and a tight grid bound giving the
   same bits, a too-small bound still right) is timed at B = 8 beside its
   bound, plain version and ``scaled_dot_product_attention`` with a per-row
   live mask. K5 (q's rope, K's rope and the cache write in one launch) in
   each form — solo T = 1 and 4 at the cache's end, batched B = 8 with a row
   past S, verify B = 8 x T = 9 and 16 with rows whose angle and write rows
   part — on q, k and v sliced from one fused qkv projection, bf16 and f8
   caches, both styles: q rotated and the caches must equal its plain
   version bit for bit and repeat their bits; timed (T = 1, B = 8, B = 8 x
   T = 9) beside its bound with q's bytes and the time of the K-only kernel
   it replaced (``K5_MS_BEFORE``). K1 and K3 are also checked and timed at the verify
   step's T = 9, 16 and 72.
2. ``Engine.generate`` (eager steps) on a Llama-3-8B-shape model (random Q40 params made on
   the card from a seeded generator, seq_len 1024): a 100-token prompt
   (bucket 128) and 32 greedy decode tokens. Launch counters show every
   decode token went through the Q40 matmul (4 per layer + the classifier),
   rope + cache write and flash decode (one each per layer); the first
   decode step's logits are held against the same step with every kernel
   swapped for its plain version. Then the same with random Q80 params (the
   Q40 model freed first): 129 Q80 matmuls per token. The profiler's device
   time per token is split by kernel; each flash-decode call, each rope
   launch and each matmul (the Q40 or Q80 decode GEMV) must be one CUDA
   launch: no ``sum_splits_kernel`` on either decode. One more prefill runs
   under the profiler, its device time split by kernel the same way.
   2b. For each model, one decode step with ``DLLAMA_FUSE_NORM=1`` against
   ``=0``: the logits must be bit-equal.
   2c. ``python -m dllama_tpu_torch.qkernel_experiments all`` as its entry
   point runs it (every variant checked and timed at K 4096, O 11008); the
   launch counters show it went through K1, K6 and K7.
3. ``python -m dllama_tpu_torch.cli generate`` as a subprocess on small Q40
   and Q80 `.m`/`.t` pairs written by the port's own writers; with no
   weight flag the card keeps the file's format, and with f32 activations
   it must print the token ids the CPU run (plain versions) prints, and so
   must ``--spec-draft 8`` on the card.
4. ``Engine.generate_batch`` (eager steps) on the Llama-3-8B shape (random Q40, bf16
   batch cache [32, 8, 1024, 8, 128]), 8 seeded prompts of 20-100 tokens
   and 32 greedy steps. Gates: (a) one batched step's logits, row by row,
   against the same row's solo ``forward`` at T = 1 within phase 2's
   decode-step tolerance; (b) row 0's tokens bit-identical across two
   batches of 8 that differ in every other row; (c) in a
   ``BatchSession(max_batch=4)`` a prompt admitted mid-flight gives the
   tokens it gives admitted at the start, bit for bit; (d) every step
   launches the batched K4 and K5 once per layer. Logged at B = 1, 4 and 8:
   ms per batched step (median over chunks, one sync per chunk), aggregate
   tokens/s against solo ``generate``'s, the profiler's device busy ms per
   step by kernel family, launches per step, the idle share, and how many
   greedy tokens of each row equal its solo stream; at B = 8 also the ms
   per step sampled (temperature 0.8, top-p 0.9). Then Q80 at B = 8
   (gates a and d).
5. Prompt-lookup speculative decoding on phase 4's Q40 model (draft 8).
   Gates: (a) one ``forward_batched_verify`` at B = 8, T = 9, rows at mixed
   positions, row by row against the solo ``forward`` at (T = 9, pos[b]),
   and (b) against the same step through the plain versions, both within
   phase 2's tolerance; every verify step launches K1 (the tile at 72
   rows) 129 times and K5's verify form once per layer, and every solo
   verify step the solo K4 and K5 once per layer; no verify forward (solo
   or batched) and no generator snapshot waits for the device; sampled
   ``generate_spec`` with no draft (T = 1 verify steps) gives plain sampled
   ``generate``'s tokens; (c) a CUDA generator restored to the state noted
   after draw k makes draw k + 1; (d) the sampled verify of T = 9 logits
   picks what row-by-row ``sample_dynamic`` picks with the same seed; (e)
   a plain sampled stream's tokens recomputed through T = 1 steps with its
   own noise are its tokens (logged beside: what the same noise picks from
   the T = 9 verify logits of those positions). Logged: solo
   ``generate_spec`` on phase 2's prompt with no history and with phase
   2's greedy stream as history (ms, tokens and rows fed per verify step,
   ms per token against phase 2's, the device split and CUDA launches per
   verify step, greedy tokens equal to phase 2's), sampled with draft 8
   against plain sampled ``generate``, and ``generate_batch_spec`` at B =
   8 (ms and rows fed per verify step, tokens/s against phase 4's B = 8,
   the device split at T = 9, the plain verify attention's time).
6. CUDA-graphed decode (``Engine(cuda_graphs=True)``, one ``StepGraph``
   replay per decode step) on phase 2's model and prompt and phase 4's
   prompts, Q40 then Q80, beside an eager engine on the same parameters
   (phases 2 and 4 run eager). First K4 at B = 1 with the graphs' grid
   bound S against the solo launch's tight grid at pos 116 and 1000 (bits
   equal, the cost per token logged). Gates: (a) the first graphed step's
   logits and cache bit-equal to eager ``forward`` at T = 1, one replay
   counting 129 matmuls and 32 batched K4 and K5; (b) 33 greedy tokens of
   graphed ``generate`` = eager; (c) ``generate_fused`` for 97 tokens
   (decode chunks of 64 and 32) = ``generate``; (d, Q40) sampled at 0.8 /
   0.9 the graphed streams = eager, solo and for 8 ``generate_batch`` rows;
   (e) graphed batched chunks at B = 1, 4, 8 (Q80: 8) bit-equal to eager,
   and phase 4's mid-flight admission through graphs; (f) no host sync
   (``set_sync_debug_mode("error")``) and no allocation in a chunk's
   replays; (g) a graphed Q40 token runs at least 15 kernels per layer
   fewer than the 1,980 it ran before (``GRAPHED_KERNELS_BEFORE``: one rope
   launch per layer in place of q's rope, the table gathers and the k/v
   copies). Logged: ms per token of graphed
   ``generate`` and ``generate_fused`` beside eager, ms per step and tokens/s batched, the
   profiler's device busy, idle share and host launch calls per token or
   step, capture ms and pool memory per graph.

7. Mixture-of-experts. (a) K1's and K3's expert-indexed GEMVs
   (``dllama_{q40,q80}_gemv_indexed``: the expert ids read from device
   memory) at the Mixtral-8x7B and Grok-1 expert widths (up|gate and down),
   T = 1, 2 and 3, 2 and 6 experts a launch, on layer 1 of a 2-layer stack
   of 8: within 1e-5 * max|ref| of the plain version, output j bit-equal to
   the plain launch on the view of its expert, repeat bits; timed beside
   the experts' bytes at 3.35 TB/s and bf16 ``torch.matmul`` on the
   dequantized experts. (b) A Mixtral-8x7B-shape model (random Q40 made on
   the card, 29 GB of experts, seq_len 1024; phases 2-6's models freed):
   a 100-token prefill; the first decode step within phase 2's tolerance of
   the plain versions; the first graphed step bit-equal to eager
   ``forward``, one replay launching 65 K1, 64 indexed, 32 K4 and 32 K5;
   33 greedy tokens graphed = eager; a graphed chunk with no host sync;
   graphed ``generate_batch`` at B = 2 (the selected experts) and 8 (the
   dense combine) = eager. Logged: ms per token graphed and eager beside
   the bound (the bytes a token must read: attention, 2 of 8 experts a
   layer and wcls), device busy, idle share and kernels per graphed token,
   tokens/s per B. (c) Grok-1 at full width, 4 of its 64 layers, the same
   gates solo. (d) Mixtral in Q80 at 8 layers, the same gates with 8
   tokens.

8. The OpenAI-compatible server (``serving.api_server``), in-process on
   phase 6's graphed Q40 engine (kept from phase 6; run after phase 7,
   since once the server's threads have run, each later profiler window
   of the process loses its first kernel records), over a synthetic
   128,256-piece tokenizer. (a) solo (``--batch-window 0``):
   chat completions plain and streamed, ``n = 2``, a stop sequence,
   ``max_tokens`` and a second turn on the first turn's prefix session;
   greedy ids = ``engine.generate`` on the rendered prompt ids bit for bit,
   the prefill and decode-step histograms count each call, ``/health``,
   ``/ready`` and ``/metrics`` answer, and evicting a session returns at
   least one cache's bytes. (b) batched (``--batch-window 30 --batch-max 8
   --kv-buckets 0``, prefill chunk 64): eight greedy and sampled requests
   at once = a direct ``BatchSession`` of the same prompts and seeds bit
   for bit, and a second wave captures no graph. (c) that wave under
   ``logits:nan:row=3``: one request 500s, seven return (b)'s ids. K1, K4
   and K5 must have launched. (d) ``cli verify`` on phase 3's small model
   and on a copy with one byte flipped; ``cli generate --profile`` writes a
   trace holding ``q40_gemv_kernel``. Logged beside the card: solo time to
   first token and ms/token through HTTP against phase 6's ``generate``,
   the wave's tokens/s and p50/p99 latency, prefill pieces per admission.

The last lines are the card's name and power limit, one JSON object with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # tensor-core bf16 peak: the least time for bf16 products
F32_FLOPS = 67e12  # CUDA-core float32 peak
INT8_OPS = 1979e12  # tensor-core int8 peak: the least time for int8 products
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU spin ahead of each timed series
#: per-launch times of the solo K4 (pos 1000, pos 116) on the NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md) before it became the one-row launch of the
#: batched kernel
SOLO_MS_BEFORE = {"flash_decode@1000": 0.0194, "flash_decode@116": 0.0157}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 30) -> float:
    """Median device time of one call of ``fn``, in ms: a GPU sleep lets the
    host queue every launch first, so each event pair brackets device work
    only."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple:
    """(least time in ms, what bounds it) for ``nbytes`` moved and ``flops``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ptxas_report(text: str) -> list:
    """[{kernel, registers, static_smem, stack, spill_stores, spill_loads}] for each entry
    function in nvcc's ``-Xptxas -v`` output, names demangled where
    ``c++filt`` is there."""
    import re

    rows, cur = [], {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m and cur:
            cur["registers"] = int(m.group(1))
            cur["static_smem"] = int(m.group(2) or 0)
            rows.append(cur)
            cur = {}
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) == len(rows):
        for r, n in zip(rows, names):
            r["kernel"] = n.replace("(anonymous namespace)::", "").replace("void ", "")
    return rows


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

#: Llama-3-8B projection widths (K -> O) and launches per decode token
SHAPES = [("wqkv", 4096, 6144, 32), ("wo", 4096, 4096, 32),
          ("w13", 4096, 28672, 32), ("w2", 14336, 4096, 32),
          ("wcls", 4096, 128256, 1)]
#: the shapes whose input is an rmsnorm's output: the fused-norm epilogue's
FUSED = ("wqkv", "w13")
#: rows of a speculative verify step: solo at draft 8 (9), solo at the
#: kernels' most rows (16), and B = 8 sequences of 9 (72)
VERIFY_T = (9, 16, 72)


def quant_planes(torch, dev, gen, kind: str, K: int, O: int) -> tuple:
    """Random planes of a ``kind`` matrix [K, O], as random_quant_params
    makes them."""
    if kind == "q40":
        return (torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen),
                torch.rand((K // 64, O), device=dev, generator=gen) * 0.004,
                torch.rand((K // 64, O), device=dev, generator=gen) * 0.004)
    return (torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen),
            torch.rand((K // 32, O), device=dev, generator=gen) * 0.0003)


def plane_bytes(planes) -> int:
    return sum(p.numel() * p.element_size() for p in planes)


def dequant_bf16(torch, kind, planes, sub=8.0):
    """The dense bf16 [K, O] matrix the planes hold (``sub`` 0: the nosub
    dot's weight)."""
    if kind == "q80":
        w, s = planes
        return (w.float() * s.repeat_interleave(32, 0)).to(torch.bfloat16)
    w, s_lo, s_hi = planes
    K2, O = w.shape
    lo = (((w & 0xF).float() - sub) * s_lo.repeat_interleave(32, 0)).reshape(K2 // 32, 32, O)
    hi = (((w >> 4).float() - sub) * s_hi.repeat_interleave(32, 0)).reshape(K2 // 32, 32, O)
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, O).to(torch.bfloat16)


def rotating(planes: list):
    """A counter over weight copies: each call takes the next, so L2 helps
    no launch."""
    it = itertools.count()
    return lambda: planes[next(it) % len(planes)]


def library_ms(torch, kind, planes: list, x, sub=8.0) -> float:
    """The yardstick: bf16 torch.matmul on a pre-dequantized weight (as many
    copies as the quantized planes need to defeat L2)."""
    K, O = x.shape[1], planes[0][0].shape[1]
    n = max(1, math.ceil(200e6 / (K * O * 2)))
    wds = [dequant_bf16(torch, kind, planes[i % len(planes)], sub) for i in range(n)]
    nxt = rotating(wds)
    ms = time_ms(torch, lambda: torch.matmul(x, nxt()))
    del wds
    return ms


def phase1_matmul(torch, dev, gen, kind: str) -> list:
    """K1+K2 (q40) or K3 (q80) at every Llama-3-8B width, plain and with the
    fused-norm epilogue: each against its plain version within 1e-5 *
    max|ref|, the fused form bit-equal to the unfused one, and two launches
    on the same inputs bit-equal. T = 1, 128 and 512, the batched decode
    step's T = B = 4 and the GEMV's largest T (``GEMV_MAX_T``), and the
    speculative verify step's T (``VERIFY_T``). Timed at T = 1 (decode),
    T = 128 (prefill), T = 512 (not wcls), and at the batched T and the
    verify T (the kernel and the library call only), each beside bf16
    ``torch.matmul`` on the dequantized weight."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.ops import qmatmul
    from dllama_tpu_torch.ops.norms import rmsnorm

    def kern(x, p, nosub, **kw):
        if kind == "q40":
            return qmatmul.q40_matmul(x, *p, nosub=nosub, **kw)
        return qmatmul.q80_matmul(x, *p, **kw)

    def plain(x, p, nosub, **kw):
        if kind == "q40":
            return qmatmul.q40_matmul_ref(x, *p, nosub=nosub, **kw)
        return qmatmul.q80_matmul_ref(x, *p, **kw)

    n_sm = kernels.sm_count(dev)
    batched_t = (4, qmatmul.GEMV_MAX_T)
    ts = (1, *batched_t, *VERIFY_T, 128, 512)
    rows = []
    for name, K, O, per_token in SHAPES:
        planes = [quant_planes(torch, dev, gen, kind, K, O)]
        planes += [quant_planes(torch, dev, gen, kind, K, O)
                   for _ in range(math.ceil(200e6 / plane_bytes(planes[0])) - 1)]
        nw = 1.0 + 0.1 * torch.randn(K, device=dev, generator=gen)
        for T in ts:
            x = torch.randn((T, K), device=dev, generator=gen).to(torch.bfloat16)
            inv = qmatmul.rmsnorm_inv(x)
            for nosub in ((True, False) if kind == "q40" else (None,)):
                p = planes[0]
                got = kern(x, p, nosub)
                fused = kern(x, p, nosub, norm_w=nw, norm_inv=inv)
                unfused = kern(rmsnorm(x, nw), p, nosub)
                again = kern(x, p, nosub)
                torch.cuda.synchronize()
                ref = plain(x, p, nosub)
                ref_n = plain(x, p, nosub, norm_w=nw, norm_inv=inv)
                err = (got - ref).abs().max().item()
                err_n = (fused - ref_n).abs().max().item()
                tol, tol_n = 1e-5 * ref.abs().max().item(), 1e-5 * ref_n.abs().max().item()
                bit_equal = bool(torch.equal(fused, unfused))
                repeat = bool(torch.equal(got, again))
                row = {"matrix": name, "K": K, "O": O, "T": T, "nosub": nosub,
                       "max_abs_err": err, "tol": tol, "fused_max_abs_err": err_n,
                       "fused_tol": tol_n, "err_over_tol": max(err / tol, err_n / tol_n),
                       "fused_bit_equal_unfused": bit_equal, "repeat_bit_equal": repeat}
                per_sm = 0
                if T <= qmatmul.GEMV_MAX_T:
                    per_sm = (qmatmul.q40_gemv_blocks_per_sm(T) if kind == "q40"
                              else qmatmul.gemv_blocks_per_sm(T, False))
                route, ksplit, per = (qmatmul.q40_plan if kind == "q40"
                                      else qmatmul.q80_plan)(T, K, O, n_sm, per_sm)
                row.update(route=route, ksplit=ksplit)
                tag = f" nosub={int(nosub)}" if kind == "q40" else ""
                tag += f" {route} ksplit={ksplit}"
                if route == "tile":
                    row["tile_plan"] = qmatmul.tile_plan(T, K, O, n_sm)
                    tag += f" tile_plan(m, n, ksplit, per)={row['tile_plan']}"
                else:
                    row.update(rows_per_split=per, gemv_blocks_per_sm=per_sm)
                    tag += f" rows_per_split={per} blocks_per_sm={per_sm}"
                log(f"  {kind}_matmul {name:5s} {K:5d}->{O:6d} T={T:3d}{tag} max_abs_err "
                    f"{err:.3e} (tol 1e-5*max|ref| = {tol:.3e}); fused norm {err_n:.3e} "
                    f"(tol {tol_n:.3e}); worst err/tol {row['err_over_tol']:.3f}; bit-equal to "
                    f"unfused: {bit_equal}; repeat bit-equal: {repeat}")
                if not (err <= tol and err_n <= tol_n and bit_equal):
                    fail(f"{kind}_matmul {name} T={T}{tag}: {err} > {tol}, {err_n} > {tol_n} "
                         f"or fused != unfused")
                if not repeat:
                    fail(f"{kind}_matmul {name} T={T}: two launches on the same inputs differ")
                if ((kind == "q40" and nosub != qmatmul.Q40_NOSUB)
                        or (T == 512 and name == "wcls")):
                    rows.append(row)
                    continue
                nxt = rotating(planes)
                row["ms"] = time_ms(torch, lambda: kern(x, nxt(), nosub))
                row["library_ms"] = library_ms(torch, kind, planes, x)
                b, by = bound_ms(plane_bytes(p) + T * K * 2 + T * O * 4, 2.0 * T * K * O, BF16_FLOPS)
                row["bound_ms"], row["bound_by"] = b, by
                row["launches_per_token"] = per_token if T == 1 else None
                if T in (*batched_t, *VERIFY_T):  # batched and verify rows: kernel, library
                    log(f"    time {row['ms']:.4f} ms  bound {b:.4f} ms ({by})  bf16 "
                        f"torch.matmul {row['library_ms']:.4f} ms")
                    rows.append(row)
                    continue
                row["fused_ms"] = time_ms(torch, lambda: kern(x, nxt(), nosub, norm_w=nw,
                                                            norm_inv=inv))
                row["plain_ms"] = time_ms(torch, lambda: plain(x, p, nosub), 20)
                row["fused_plain_ms"] = time_ms(
                    torch, lambda: plain(x, p, nosub, norm_w=nw, norm_inv=inv), 20)
                log(f"    time {row['ms']:.4f} ms (fused norm {row['fused_ms']:.4f})  bound "
                    f"{b:.4f} ms ({by})  plain {row['plain_ms']:.4f} ms  bf16 torch.matmul "
                    f"{row['library_ms']:.4f} ms")
                rows.append(row)
        del planes
        torch.cuda.empty_cache()
    return rows


#: K6/K7 shapes: the experiment's default matrix and the Llama-3-8B widths
VARIANT_SHAPES = [("exp", 4096, 11008), ("wqkv", 4096, 6144), ("w13", 4096, 28672),
                  ("w2", 14336, 4096)]


def k7_one_launch(torch, qe, xq, sx, p) -> dict:
    """The CUDA kernels one K7 call launches, by the profiler: the int8 GEMV
    alone, no ``sum_splits_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    qe.q40_int8_matmul(xq, sx, *p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        qe.q40_int8_matmul(xq, sx, *p)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    counts = {n: names.count(n) for n in set(names)}
    if not names:
        fail("K7: the profiler recorded no CUDA kernel, so one launch a call is unchecked")
    if (sum("q40_int8_kernel" in n for n in names) != 1
            or any("sum_splits" in n for n in names)):
        fail(f"K7: one call launched {counts}, want one q40_int8_kernel and no sum_splits")
    return counts


def phase1_variants(torch, dev, gen) -> list:
    """K6 (the nosub dot without correction, 512- and 1024-column blocks) and
    K7 (the Q40 x Q80 integer dot) against their plain versions at T = 1;
    K7 also at T = 3, 8 and 12 (two row tiles) on the shootout's matrix,
    each call's bits repeated by a second call, and one CUDA launch a call."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch import qkernel_experiments as qe

    rows = []
    for name, K, O in VARIANT_SHAPES:
        planes = [quant_planes(torch, dev, gen, "q40", K, O)]
        planes += [quant_planes(torch, dev, gen, "q40", K, O)
                   for _ in range(math.ceil(200e6 / plane_bytes(planes[0])) - 1)]
        p = planes[0]
        x = torch.randn((1, K), device=dev, generator=gen).to(torch.bfloat16)
        xq, sx = qe.quantize_q80_rows(x, K)
        got = qe.q40_nosub_matmul(x, *p)
        wide = qe.q40_nosub_matmul(x, *p, wide=True)
        got7 = qe.q40_int8_matmul(xq, sx, *p)
        again7 = qe.q40_int8_matmul(xq, sx, *p)
        torch.cuda.synchronize()
        ref = qe.q40_nosub_matmul_ref(x, *p)
        ref7 = qe.q40_int8_matmul_ref(xq, sx, *p)
        err = max((got - ref).abs().max().item(), (wide - ref).abs().max().item())
        err7 = (got7 - ref7).abs().max().item()
        tol, tol7 = 1e-5 * ref.abs().max().item(), 1e-5 * ref7.abs().max().item()
        repeat7 = bool(torch.equal(got7, again7))
        plan7 = qe.int8_plan(1, K, O, kernels.sm_count(dev), qe.int8_blocks_per_sm(1))
        log(f"  q40_nosub_matmul {name:4s} {K:5d}->{O:6d} T=1 (512 and 1024 columns a block) "
            f"max_abs_err {err:.3e} (tol 1e-5*max|ref| = {tol:.3e}); q40_int8_matmul "
            f"{err7:.3e} (tol {tol7:.3e}), repeat bit-equal {repeat7}, plan (row tiles, "
            f"ksplit, rows a split) {plan7}, {qe.int8_blocks_per_sm(1)} blocks an SM")
        if not (err <= tol and err7 <= tol7 and repeat7):
            fail(f"K6/K7 at {name}: {err} > {tol} or {err7} > {tol7} or K7 repeat {repeat7}")
        more7 = {}
        if name == "exp":
            for T in (3, 8, 12):
                xt = torch.randn((T, K), device=dev, generator=gen).to(torch.bfloat16)
                xqt, sxt = qe.quantize_q80_rows(xt, K)
                a = qe.q40_int8_matmul(xqt, sxt, *p)
                b = qe.q40_int8_matmul(xqt, sxt, *p)
                torch.cuda.synchronize()
                want = qe.q40_int8_matmul_ref(xqt, sxt, *p)
                e, tl = (a - want).abs().max().item(), 1e-5 * want.abs().max().item()
                log(f"    q40_int8_matmul T={T}: max_abs_err {e:.3e} (tol {tl:.3e}), repeat "
                    f"bit-equal {torch.equal(a, b)}")
                if not (e <= tl and torch.equal(a, b)):
                    fail(f"K7 at T={T}: {e} > {tl} or two calls differ")
                more7[T] = {"max_abs_err": e, "tol": tl}
                err7 = max(err7, e)
            more7["one_call_launches"] = k7_one_launch(torch, qe, xq, sx, p)
            log(f"    one K7 call launches {more7['one_call_launches']}")
        nxt = rotating(planes)
        k6 = {"name": "q40_nosub_matmul", "matrix": name, "K": K, "O": O, "max_abs_err": err,
              "tol": tol,
              "ms": time_ms(torch, lambda: qe.q40_nosub_matmul(x, *nxt())),
              "wide_ms": time_ms(torch, lambda: qe.q40_nosub_matmul(x, *nxt(), wide=True)),
              "plain_ms": time_ms(torch, lambda: qe.q40_nosub_matmul_ref(x, *p), 20),
              "library_ms": library_ms(torch, "q40", planes, x, sub=0.0)}
        k6["bound_ms"], k6["bound_by"] = bound_ms(plane_bytes(p) + K * 2 + O * 4, 2.0 * K * O,
                                                  BF16_FLOPS)
        k7 = {"name": "q40_int8_matmul", "matrix": name, "K": K, "O": O, "max_abs_err": err7,
              "tol": tol7, "plan": plan7, "repeat_bit_equal": repeat7, **more7,
              "ms": time_ms(torch, lambda: qe.q40_int8_matmul(xq, sx, *nxt())),
              "plain_ms": time_ms(torch, lambda: qe.q40_int8_matmul_ref(xq, sx, *p), 20),
              "library_ms": None}
        k7["bound_ms"], k7["bound_by"] = bound_ms(
            plane_bytes(p) + K + K // 32 * 4 + O * 4, 2.0 * K * O, INT8_OPS)
        for r in (k6, k7):
            log(f"    {r['name']}: time {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})  plain {r['plain_ms']:.4f} ms  library {r['library_ms']}")
        log(f"    K7 / K6 time {k7['ms'] / k6['ms']:.3f}; K7 at {k7['bound_ms'] / k7['ms']:.3f} of "
            f"its bound")
        rows += [k6, k7]
        del planes
        torch.cuda.empty_cache()
    return rows


def phase1_flash(torch, dev, gen) -> list:
    """K4 against its plain version for every cache dtype and T in {1, 4,
    16} at pos 1000 (bf16 out within 2^-7 * max|ref|, f32 out within 1e-5 *
    max|ref|); two launches on the same inputs must give the same bits.
    Timed (T = 1, bf16 cache, cold) at pos 1000 and at the decode run's pos
    116, beside its bound, its plain version and scaled_dot_product_attention
    on the live prefix."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.ops import flash_decode

    rows = []
    L, S, kv, group, hd = 64, 1024, 8, 4, 128  # 256 MB: cold in L2
    n_sm = kernels.sm_count(dev)
    for dtype in (torch.bfloat16, torch.float32, torch.float8_e4m3fn):
        kc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(dtype)
        vc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(dtype)
        for T in (1, 4, 16):
            pos = 1000
            q = torch.randn((T, kv * group, hd), device=dev, generator=gen).to(torch.bfloat16)
            got = flash_decode.flash_decode_attention(q, kc, vc, pos, 2).float()
            got32 = flash_decode.flash_decode_attention(q.float(), kc, vc, pos, 2)
            again32 = flash_decode.flash_decode_attention(q.float(), kc, vc, pos, 2)
            torch.cuda.synchronize()
            ref = flash_decode.flash_decode_attention_ref(q, kc, vc, pos, 2).float()
            ref32 = flash_decode.flash_decode_attention_ref(q.float(), kc, vc, pos, 2)
            err = (got - ref).abs().max().item()
            err32 = (got32 - ref32).abs().max().item()
            scale = ref32.abs().max().item()
            repeat = bool(torch.equal(got32, again32))
            # bf16 output: one bf16 ulp at the output's magnitude; f32: 1e-5
            tol, tol32 = 2.0 ** -7 * scale, 1e-5 * scale
            n_split, chunk = flash_decode.split_plan(min(pos + T, S), kv, n_sm)
            log(f"  flash_decode cache={str(dtype).split('.')[-1]} T={T} S={S} kv={kv} "
                f"group={group} hd={hd} pos={pos}: grid ({kv}, {n_split}) = {kv * n_split} "
                f"blocks, chunk {chunk}; bf16 out max_abs_err {err:.3e} (tol 2^-7*max = "
                f"{tol:.3e}), f32 out {err32:.3e} (tol 1e-5*max = {tol32:.3e}); repeat "
                f"bit-equal: {repeat}")
            if not (err <= tol and err32 <= tol32 and repeat):
                fail(f"flash_decode {dtype} T={T}: {err} > {tol}, {err32} > {tol32} or two "
                     f"launches differ")
            row = {"cache": str(dtype), "T": T, "S": S, "pos": pos, "max_abs_err": err,
                   "tol": tol, "max_abs_err_f32": err32, "tol_f32": tol32,
                   "repeat_bit_equal": repeat, "n_split": n_split, "chunk": chunk,
                   "grid": [kv, n_split]}
            rows.append(row)
            if dtype != torch.bfloat16 or T != 1:
                continue
            for tpos in (1000, 116):
                n_split, chunk = flash_decode.split_plan(tpos + T, kv, n_sm)
                layers = itertools.count()
                ms = time_ms(torch, lambda: flash_decode.flash_decode_attention(
                    q, kc, vc, tpos, next(layers) % L))
                plain = time_ms(
                    torch, lambda: flash_decode.flash_decode_attention_ref(q, kc, vc, tpos, 2))
                live = tpos + T
                kl = kc[2, :live].permute(1, 0, 2).unsqueeze(0).contiguous()  # [1, kv, live, hd]
                vl = vc[2, :live].permute(1, 0, 2).unsqueeze(0).contiguous()
                ql = q.permute(1, 0, 2).unsqueeze(0).contiguous()  # [1, H, T, hd]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib = time_ms(torch, lambda: sdpa(ql, kl, vl, enable_gqa=True))
                nbytes = 2 * live * kv * hd * kc.element_size() + 2 * q.numel() * 2
                b, by = bound_ms(nbytes, 4.0 * T * kv * group * live * hd, BF16_FLOPS)
                was = SOLO_MS_BEFORE[f"flash_decode@{tpos}"]
                timed = {"pos": tpos, "ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": b, "bound_by": by, "n_split": n_split, "chunk": chunk,
                         "grid": [kv, n_split, 1], "before_ms": was, "change": ms / was - 1.0}
                row.setdefault("timed", []).append(timed)
                log(f"    pos {tpos}: grid ({kv}, {n_split}, 1): time {ms:.4f} ms (before {was} ms: "
                    f"{100 * (ms / was - 1):+.1f}%)  bound {b:.5f} ms ({by})  plain {plain:.4f} ms"
                    f"  sdpa {lib:.4f} ms")
        del kc, vc
        torch.cuda.empty_cache()
    return rows


#: kernels a graphed Q40 decode token ran on the NVIDIA H100 80GB HBM3 before
#: q's rope moved into the rope launch (PERF.md)
GRAPHED_KERNELS_BEFORE = 1980
#: Llama-3-8B attention: q heads, kv heads, head size
ROPE_HEADS = (32, 8, 128)
#: per-launch CUDA-event times of the K-only rope + cache-write kernel this
#: launch replaced (q's rope, the table gathers and the k/v copies ran as
#: PyTorch kernels beside it) on the NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
K5_MS_BEFORE = {"rope_cache_update": 0.0054, "rope_cache_update_batched": 0.0055,
                "rope_cache_update_verify": 0.0058}


def rope_launches(torch, dev, gen, form: str, cases: list, timed_case: int) -> list:
    """One K5 launch form against its plain version at Llama-3-8B widths: q,
    k and v sliced from one fused bf16 qkv projection (as the decode step
    hands them over), the f32 tables of S = 1024 rows, bf16 and f8 caches,
    both rope styles. q rotated and both caches must be bit-equal, and a
    second launch on the same inputs must give the same bits. ``cases``:
    (rows, pos, cache shape); case ``timed_case`` (bf16, interleaved) is
    timed by CUDA events beside its byte bound (q read and written, k and v
    read, the cache rows written, the table rows read) and its plain
    version."""
    from dllama_tpu_torch.ops import fused_rope_cache
    from dllama_tpu_torch.ops.rope import HALF, INTERLEAVED, rope_table

    name = {"solo": "rope_cache_update", "batched": "rope_cache_update_batched",
            "verify": "rope_cache_update_verify"}[form]
    fn, ref = getattr(fused_rope_cache, name), getattr(fused_rope_cache, name + "_ref")
    H, kv, hd = ROPE_HEADS
    S = cases[0][2][-3]
    cos, sin = (torch.from_numpy(t).to(dev) for t in rope_table(S, hd, 500000.0))
    rows = []
    for i, (lead, pos_l, shape) in enumerate(cases):
        n = math.prod(lead)
        pos = pos_l if form == "solo" else torch.tensor(pos_l, dtype=torch.int32, device=dev)
        for style in (INTERLEAVED, HALF):
            for dtype in (torch.bfloat16, torch.float8_e4m3fn):
                qkv = torch.randn((n, (H + 2 * kv) * hd), device=dev, generator=gen)
                qkv = qkv.to(torch.bfloat16)
                q, k, v = (t.reshape(*lead, -1, hd) for t in (
                    qkv[:, :H * hd], qkv[:, H * hd:(H + kv) * hd], qkv[:, (H + kv) * hd:]))
                kc = torch.randn(shape, device=dev, generator=gen).to(dtype)
                vc = torch.randn(shape, device=dev, generator=gen).to(dtype)
                kr, vr, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                got = fn(q, k, v, cos, sin, kc, vc, pos, 1, style)
                again = fn(q, k, v, cos, sin, k2, v2, pos, 1, style)
                torch.cuda.synchronize()
                want = ref(q, k, v, cos, sin, kr, vr, pos, 1, style)
                diff = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                           for a, b in ((got, want), (kc, kr), (vc, vr)))
                repeat = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                             for a, b in ((got, again), (kc, k2), (vc, v2)))
                err = max((a.float() - b.float()).abs().nan_to_num().max().item()
                          for a, b in ((got, want), (kc, kr), (vc, vr)))
                log(f"  {name} {style:11s} rows {lead} pos={pos_l} "
                    f"cache={str(dtype).split('.')[-1]}: {diff} bytes of q rotated and the "
                    f"caches differ (tol 0: bit-equal); repeat bit-equal: {repeat}")
                if diff or not repeat:
                    fail(f"{name} {style} rows {lead} {dtype}: {diff} bytes differ or two "
                         f"launches differ")
                row = {"style": style, "rows": list(lead), "pos": pos_l, "cache": str(dtype),
                       "bytes_differ": diff, "repeat_bit_equal": repeat, "max_abs_err": err}
                if i == timed_case and style == INTERLEAVED and dtype == torch.bfloat16:
                    row["ms"] = time_ms(torch, lambda: fn(q, k, v, cos, sin, kc, vc, pos, 1,
                                                          style))
                    row["plain_ms"] = time_ms(torch, lambda: ref(q, k, v, cos, sin, kr, vr, pos,
                                                                 1, style))
                    nbytes = n * (2 * H * hd * 2 + 2 * kv * hd * 2 + 2 * kv * hd * 2 + hd * 4)
                    b_ms, by = bound_ms(nbytes, 6.0 * n * (H + kv) * hd // 2, F32_FLOPS)
                    row.update(bound_ms=b_ms, bound_by=by, bound_bytes=nbytes, library_ms=None)
                    was = K5_MS_BEFORE[name]
                    row["k_only_ms_from_perf_md"] = was
                    log(f"    rows {lead}: time {row['ms']:.4f} ms per launch (the K-only kernel "
                        f"before, from PERF.md, not this run: {was} ms)  bound {b_ms:.6f} ms "
                        f"({by}, {nbytes} bytes with q's)  plain {row['plain_ms']:.4f} ms  (no "
                        f"single PyTorch call)")
                rows.append(row)
                del kc, vc, kr, vr, k2, v2
    torch.cuda.empty_cache()
    return rows


def phase1_rope(torch, dev, gen) -> list:
    """The solo K5 launch: T = 1 at pos 700 (timed) and T = 4 at pos 1022,
    whose rows clamp to 1020..1023, angles with them."""
    _, kv, hd = ROPE_HEADS
    shape = (4, 1024, kv, hd)
    return rope_launches(torch, dev, gen, "solo", [((1,), 700, shape), ((4,), 1022, shape)], 0)


#: mixed row positions of S = 1024 for the batched forms (first slot, the
#: decode run's 116, long, last slot, a tile edge, ...)
BATCH_POS = [0, 116, 1000, 1023, 31, 32, 500, 7]
#: (L, S, kv, group, hd) of the batched K4 checks: 268 MB of bf16 cache at
#: B = 8, cold in L2
BATCH_SHAPE = (8, 1024, 8, 4, 128)


def phase1_flash_batched(torch, dev, gen) -> list:
    """Batched K4 against its plain version for every cache dtype at B = 1,
    4 and 8 (kv 8, group 4, hd 128, S 1024), rows at mixed positions: bf16
    out within 2^-7 * max|ref|, f32 out within 1e-5 * max|ref|; two launches
    and a launch with the tight host bound (max pos + 1) give the same bits;
    NaN past each row's prefix leaves the bits as they are. Timed at B = 8
    (bf16 cache, cold, the tight bound the engine passes) beside the bytes
    of the rows' live prefixes over 3.35 TB/s, the plain version, and one
    ``scaled_dot_product_attention`` over [B, H, 1, hd] against the row
    slabs with a per-row live mask."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.ops import flash_decode

    rows = []
    L, S, kv, group, hd = BATCH_SHAPE
    n_sm = kernels.sm_count(dev)
    for dtype in (torch.bfloat16, torch.float32, torch.float8_e4m3fn):
        kc8 = torch.randn((L, 8, S, kv, hd), device=dev, generator=gen).to(dtype)
        vc8 = torch.randn((L, 8, S, kv, hd), device=dev, generator=gen).to(dtype)
        for B in (1, 4, 8):
            kc, vc = (kc8, vc8) if B == 8 else (kc8[:, :B].contiguous(), vc8[:, :B].contiguous())
            pos_l = [1000] if B == 1 else BATCH_POS[:B]
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            tight = max(pos_l) + 1
            q = torch.randn((B, kv * group, hd), device=dev, generator=gen).to(torch.bfloat16)
            got = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 2).float()
            got32 = flash_decode.flash_decode_attention_batched(q.float(), kc, vc, pos, 2)
            again32 = flash_decode.flash_decode_attention_batched(q.float(), kc, vc, pos, 2)
            tight32 = flash_decode.flash_decode_attention_batched(q.float(), kc, vc, pos, 2, tight)
            # a bound below the rows' pos + 1: fewer chunks, every prefix still read
            short = max(1, tight // 4)
            short32 = flash_decode.flash_decode_attention_batched(q.float(), kc, vc, pos, 2, short)
            torch.cuda.synchronize()
            ref = flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, 2).float()
            ref32 = flash_decode.flash_decode_attention_batched_ref(q.float(), kc, vc, pos, 2)
            err = (got - ref).abs().max().item()
            err32 = (got32 - ref32).abs().max().item()
            err_short = (short32 - ref32).abs().max().item()
            scale = ref32.abs().max().item()
            repeat = bool(torch.equal(got32, again32) and torch.equal(got32, tight32))
            tol, tol32 = 2.0 ** -7 * scale, 1e-5 * scale
            max_split = flash_decode.max_splits(B * kv, n_sm)
            grid = [kv, flash_decode.n_chunks(S, max_split), B]
            grid_tight = [kv, flash_decode.n_chunks(tight, max_split), B]
            log(f"  flash_decode_batched cache={str(dtype).split('.')[-1]} B={B} pos={pos_l}: grid "
                f"{tuple(grid)} (tight bound {tight}: {tuple(grid_tight)}), at most {max_split} "
                f"chunks a row; bf16 out max_abs_err {err:.3e} (tol 2^-7*max = {tol:.3e}), f32 "
                f"out {err32:.3e} (tol 1e-5*max = {tol32:.3e}); repeat and tight-bound "
                f"bit-equal: {repeat}; too-small bound {short} (grid "
                f"{flash_decode.n_chunks(short, max_split)} chunks) f32 out {err_short:.3e}")
            if not (err <= tol and err32 <= tol32 and err_short <= tol32 and repeat):
                fail(f"flash_decode_batched {dtype} B={B}: {err} > {tol}, {err32} or "
                     f"{err_short} (bound {short}) > {tol32}, or launches differ")
            row = {"cache": str(dtype), "B": B, "pos": pos_l, "max_abs_err": err, "tol": tol,
                   "max_abs_err_f32": err32, "tol_f32": tol32, "repeat_bit_equal": repeat,
                   "short_bound": short, "max_abs_err_short_bound": err_short,
                   "grid": grid, "grid_tight": grid_tight, "max_split": max_split}
            if dtype == torch.bfloat16 and B == 8:
                kn, vn = kc.clone(), vc.clone()
                for b, p in enumerate(pos_l):
                    kn[:, b, p + 1:] = float("nan")
                    vn[:, b, p + 1:] = float("nan")
                poisoned = flash_decode.flash_decode_attention_batched(q.float(), kn, vn, pos, 2)
                torch.cuda.synchronize()
                nan_ok = bool(torch.isfinite(poisoned).all() and torch.equal(poisoned, got32))
                log(f"    NaN past every row's prefix: finite and bit-equal to the clean launch: "
                    f"{nan_ok}")
                if not nan_ok:
                    fail("flash_decode_batched: NaN past a row's prefix reached its output")
                del kn, vn
                row["nan_past_prefix_bit_equal"] = nan_ok
                layers = itertools.count()
                row["ms"] = time_ms(torch, lambda: flash_decode.flash_decode_attention_batched(
                    q, kc, vc, pos, next(layers) % L, tight))
                row["plain_ms"] = time_ms(torch, lambda: (
                    flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, 2)), 10)
                # the row slabs with each kv head repeated for its group: [B, H, S, hd]
                ks = kc[2].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
                vs = vc[2].permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
                qs = q[:, :, None]  # [B, H, 1, hd]
                live = torch.arange(S, device=dev)[None, :] <= pos[:, None].long()
                mask = live[:, None, None, :]  # [B, 1, 1, S]
                sdpa = torch.nn.functional.scaled_dot_product_attention
                row["library_ms"] = time_ms(torch, lambda: sdpa(qs, ks, vs, attn_mask=mask))
                nbytes = (2 * sum(p + 1 for p in pos_l) * kv * hd * kc.element_size()
                          + 2 * q.numel() * 2)
                b_ms, by = bound_ms(nbytes, 4.0 * sum(p + 1 for p in pos_l) * kv * group * hd,
                                    BF16_FLOPS)
                row["bound_ms"], row["bound_by"] = b_ms, by
                log(f"    B=8 time {row['ms']:.4f} ms per launch (grid {tuple(grid_tight)})  bound "
                    f"{b_ms:.5f} ms ({by}: the rows' live prefixes)  plain {row['plain_ms']:.4f} "
                    f"ms  sdpa with a live mask {row['library_ms']:.4f} ms")
            rows.append(row)
        del kc8, vc8, kc, vc
        torch.cuda.empty_cache()
    return rows


def phase1_rope_batched(torch, dev, gen) -> list:
    """The batched K5 launch at B = 8 (timed), a row at S - 1 and one past it
    (written at S - 1, rotated with table row S - 1)."""
    L, S, kv, _, hd = BATCH_SHAPE
    pos_l = [0, 116, 1000, S - 1, S + 5, 32, 500, 7]
    return rope_launches(torch, dev, gen, "batched", [((8,), pos_l, (L, 8, S, kv, hd))], 0)


def phase1_rope_verify(torch, dev, gen) -> list:
    """The verify K5 launch, B = 8 sequences of T = 9 (draft 8, timed) and 16
    (``MAX_T``) rows at pos 0, in the middle, at S - T and past it: rows at
    S - T + 4 and S + 5 write at S - T.. but rotate with table rows
    min(pos + t, S - 1), where angle and write row part."""
    from dllama_tpu_torch.ops import fused_rope_cache

    L, S, kv, _, hd = BATCH_SHAPE
    cases = [((8, T), [0, 116, 500, S - T, S - T + 4, S + 5, 31, 7], (L, 8, S, kv, hd))
             for T in (9, fused_rope_cache.MAX_T)]
    return rope_launches(torch, dev, gen, "verify", cases, 0)


# ---------------------------------------------------------------------------
# Phase 2: full-width decode through Engine.generate
# ---------------------------------------------------------------------------

#: the port's CUDA kernels, as the profiler's names begin (the rest is "other")
KERNEL_FAMILIES = ("q40_gemv_kernel", "q80_gemv_kernel", "dq_tile_kernel",
                   "sum_splits_kernel", "flash_decode_kernel", "rope_cache_kernel")

LLAMA3_8B = dict(arch="llama", dim=4096, hidden_dim=14336, n_layers=32, n_heads=32,
                 n_kv_heads=8, vocab_size=128256, seq_len=1024, head_size=128,
                 kv_dim=1024, rope_theta=500000.0, dtype="bfloat16")


class plain_versions:
    """Within the block, the model's kernel wrappers run their plain PyTorch
    versions instead (for the end-to-end reference step)."""

    def __enter__(self):
        from dllama_tpu_torch.models import llama
        from dllama_tpu_torch.ops import flash_decode, fused_rope_cache, qmatmul

        self.saved = [(qmatmul, "q40_matmul", qmatmul.q40_matmul),
                      (qmatmul, "q80_matmul", qmatmul.q80_matmul),
                      (qmatmul, "q40_matmul_stacked", qmatmul.q40_matmul_stacked),
                      (qmatmul, "q80_matmul_stacked", qmatmul.q80_matmul_stacked),
                      (llama, "rope_cache_update", llama.rope_cache_update),
                      (llama, "rope_cache_update_batched", llama.rope_cache_update_batched),
                      (llama, "rope_cache_update_verify", llama.rope_cache_update_verify),
                      (flash_decode, "flash_decode_attention",
                       flash_decode.flash_decode_attention),
                      (flash_decode, "flash_decode_attention_batched",
                       flash_decode.flash_decode_attention_batched)]
        qmatmul.q40_matmul = qmatmul.q40_matmul_ref
        qmatmul.q80_matmul = qmatmul.q80_matmul_ref
        qmatmul.q40_matmul_stacked = qmatmul.q40_matmul_stacked_ref
        qmatmul.q80_matmul_stacked = qmatmul.q80_matmul_stacked_ref
        llama.rope_cache_update = fused_rope_cache.rope_cache_update_ref
        llama.rope_cache_update_batched = fused_rope_cache.rope_cache_update_batched_ref
        llama.rope_cache_update_verify = fused_rope_cache.rope_cache_update_verify_ref
        flash_decode.flash_decode_attention = flash_decode.flash_decode_attention_ref
        flash_decode.flash_decode_attention_batched = (
            lambda q, kc, vc, pos, layer, bound=None:
            flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, layer))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class rows_fed:
    """Within the block, note the row count (``tokens.shape[axis]``) of every
    call of ``module.name`` that feeds at most ``max_t`` rows (a verify
    forward; a prefill feeds its bucket)."""

    def __init__(self, module, name: str, axis: int, max_t: int = 16):
        self.module, self.name, self.axis, self.max_t = module, name, axis, max_t
        self.ts: list = []

    def __enter__(self):
        fn = self.saved = getattr(self.module, self.name)

        def noted(cfg, params, rope, tokens, *a, **kw):
            if tokens.shape[self.axis] <= self.max_t:
                self.ts.append(int(tokens.shape[self.axis]))
            return fn(cfg, params, rope, tokens, *a, **kw)

        setattr(self.module, self.name, noted)
        return self.ts

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def t_histogram(ts: list) -> dict:
    """{T: how many steps fed T rows}, in order of T."""
    return {t: ts.count(t) for t in sorted(set(ts))}


class fuse_norm:
    """Within the block, DLLAMA_FUSE_NORM is ``value``."""

    def __init__(self, value: str):
        self.value = value

    def __enter__(self):
        self.saved = os.environ.get("DLLAMA_FUSE_NORM")
        os.environ["DLLAMA_FUSE_NORM"] = self.value
        return self

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("DLLAMA_FUSE_NORM", None)
        else:
            os.environ["DLLAMA_FUSE_NORM"] = self.saved


def device_time(prof, n: int) -> tuple:
    """(ms per kernel name, ms and launches per kernel family) of a profiler
    run, divided by ``n`` (the tokens or calls it covered)."""
    by_name, calls = {}, {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if dt and str(ev.device_type).endswith("CUDA"):
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.replace("dllama::tile::", "")
            name = name.split("(")[0][:80]
            by_name[name] = by_name.get(name, 0.0) + dt / 1e3 / n
            calls[name] = calls.get(name, 0) + ev.count / n
    families = {fam: {"ms": 0.0, "launches": 0.0} for fam in (*KERNEL_FAMILIES, "other")}
    for name, ms in by_name.items():
        fam = next((f for f in KERNEL_FAMILIES if name.startswith(f)), "other")
        families[fam]["ms"] += ms
        families[fam]["launches"] += calls[name]
    return by_name, families


def phase2(torch, dev, kind: str) -> dict:
    """Engine.generate on the Llama-3-8B shape with random ``kind`` weights,
    then (phase 2b) one decode step with DLLAMA_FUSE_NORM=1 against =0."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.ops import qmatmul
    from dllama_tpu_torch.ops.qmatmul import QuantTensor
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    cfg = ModelConfig(**LLAMA3_8B)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = llama.random_quant_params(cfg, dev, gen, kind)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q_bytes = 0
    for leaf in [params["wcls"], *params["layers"].values()]:
        if isinstance(leaf, QuantTensor):
            q_bytes += plane_bytes((leaf.w, leaf.s, leaf.s2))
    bound = q_bytes / HBM_BYTES_PER_S * 1e3
    engine = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                    cache_dtype=torch.bfloat16, device=dev, cuda_graphs=False)
    prompt = torch.randint(0, cfg.vocab_size, (100,), generator=torch.Generator().manual_seed(1))
    prompt = prompt.tolist()
    log(f"  Llama-3-8B shape, random {kind.upper()} params built on the card in {build_s:.2f} s; "
        f"{kind.upper()} planes {q_bytes / 1e9:.3f} GB; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    logits, _ = engine.prefill(engine.new_cache(), prompt)
    if logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")

    # one warm run (allocator, first launches), then the counted run
    for _ in engine.generate(prompt, 4):
        pass
    steps = 33  # the first token comes from the prefill logits
    kernels.reset_launches()
    seen = dict(kernels.launches)
    per_token, stats, tokens = [], [], []
    for tok, st in engine.generate(prompt, steps):
        now = dict(kernels.launches)
        per_token.append({k: now[k] - seen[k] for k in now})
        seen = now
        stats.append(st)
        tokens.append(tok)
    totals = dict(kernels.launches)
    if len(tokens) != steps:
        fail(f"generated {len(tokens)} tokens, wanted {steps}")
    want = {k: 0 for k in totals}
    want.update({f"{kind}_matmul": 4 * cfg.n_layers + 1, "flash_decode": cfg.n_layers,
                 "rope_cache_update": cfg.n_layers})
    for i, d in enumerate(per_token[1:], 1):
        if d != want:
            fail(f"decode token {i} launched {d}, want {want}")
    log(f"  launches over the run (prefill + 32 decode tokens): {totals}; every decode token: "
        f"{ {k: v for k, v in want.items() if v} }")

    decode_ms = [s.generation_ms for s in stats[1:]]
    device_wait_ms = [s.inference_ms for s in stats[1:]]
    out = {
        "kind": kind,
        "prefill_ms": engine.prefill_ms,
        "prompt_tokens": len(prompt),
        "decode_ms_median": statistics.median(decode_ms),
        "decode_ms_min": min(decode_ms),
        "decode_device_wait_ms_median": statistics.median(device_wait_ms),
        "weight_bytes_per_token": q_bytes,
        "weight_bound_ms": bound,
        "launches": totals,
        "launches_per_decode_token": {k: v for k, v in want.items() if v},
        "prompt": prompt,
        "tokens": tokens,
    }
    log(f"  prefill {engine.prefill_ms:.2f} ms ({len(prompt)} tokens, bucket 128); decode "
        f"{out['decode_ms_median']:.3f} ms/token median (min {out['decode_ms_min']:.3f}, "
        f"device wait {out['decode_device_wait_ms_median']:.3f}); {kind.upper()} weight-byte "
        f"bound {bound:.3f} ms/token")

    # where a decode token's device time goes
    from torch.profiler import ProfilerActivity, profile

    session = engine.final_session
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in engine.generate([], 3, session=session):
            pass
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / 3
    by_name, families = device_time(prof, 3)
    busy = sum(by_name.values())
    if busy > 0:
        out["profile_ms_per_token"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
        out["profile_kernels_per_token"] = families
        out["profile_device_busy_ms_per_token"] = busy
        out["profile_wall_ms_per_token"] = wall
        out["profile_idle_share"] = max(0.0, 1.0 - busy / wall)
        log(f"  profiler, 3 decode tokens: device busy {busy:.3f} ms/token of {wall:.3f} ms "
            f"wall (idle share {out['profile_idle_share']:.3f}); per token by kernel:")
        for fam, v in families.items():
            log(f"    {v['ms']:.4f} ms ({v['ms'] / busy:.3f} of busy) in {v['launches']:.0f} "
                f"CUDA launches  {fam}")
        for k, v in list(out["profile_ms_per_token"].items())[:6]:
            log(f"    {v:.4f} ms  {k}")
        # one CUDA launch per wrapper call: no split-sum pass after the decode
        # GEMV, no merge kernel after flash decode, one rope launch a layer
        want = {"flash_decode_kernel": cfg.n_layers, f"{kind}_gemv_kernel": 4 * cfg.n_layers + 1,
                "sum_splits_kernel": 0, "rope_cache_kernel": cfg.n_layers}
        for fam, n in want.items():
            if abs(families[fam]["launches"] - n) > 1e-6:
                fail(f"{kind} decode token: {families[fam]['launches']} CUDA launches of "
                     f"{fam}, want {n}")
    else:
        fail(f"{kind} decode token: the profiler showed no device time, so one launch per "
             f"wrapper call and one rope launch a layer are unchecked")

    # where a prefill's device time goes (the 100-token prompt, bucket 128)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        engine.prefill(engine.new_cache(), prompt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    by_name, families = device_time(prof, 1)
    busy = sum(by_name.values())
    if busy > 0:
        out["prefill_profile"] = {"device_busy_ms": busy, "wall_ms": wall,
                                  "kernels": families,
                                  "top": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}
        log(f"  profiler, one prefill: device busy {busy:.3f} ms of {wall:.3f} ms wall (profiled); "
            f"by kernel:")
        for fam, v in families.items():
            if v["launches"]:
                log(f"    {v['ms']:.4f} ms ({v['ms'] / busy:.3f} of busy) in {v['launches']:.0f} "
                    f"CUDA launches  {fam}")
        for k, v in list(out["prefill_profile"]["top"].items())[:6]:
            log(f"    {v:.4f} ms  {k}")
    else:
        out["prefill_profile"] = "not measured"

    # the first decode step against the same step through the plain versions
    cache = engine.new_cache()
    last, cache = engine.prefill(cache, prompt)
    nxt = torch.argmax(last).reshape(1)
    pos = len(prompt)
    snapshot = (cache["k"].clone(), cache["v"].clone())

    def step(fuse: str):
        c = {"k": snapshot[0].clone(), "v": snapshot[1].clone()}
        with fuse_norm(fuse):
            return llama.forward(cfg, engine.params, engine.rope, nxt, c, pos)[0]

    lk = step("0")
    with plain_versions():
        lr = step("0")
    err = (lk - lr).abs().max().item()
    scale = lr.abs().max().item()
    tol = 5e-2 * scale
    log(f"  decode step vs plain versions: max |dlogit| {err:.4e} (tol 5e-2*max|logit| = "
        f"{tol:.4e}; bf16 activations through 32 layers), argmax {int(lk.argmax())} vs "
        f"{int(lr.argmax())}")
    if not (bool(torch.isfinite(lk).all()) and err <= tol and int(lk.argmax()) == int(lr.argmax())):
        fail(f"{kind} decode step vs plain versions: {err} > {tol} or argmax differs")
    out["decode_vs_plain_max_abs_err"] = err

    log(f"== phase 2b: {kind.upper()} decode step, DLLAMA_FUSE_NORM=1 against =0")
    with fuse_norm("1"):
        engaged = qmatmul.norm_fusion_engages(engine.params["layers"]["wqkv"])
    kernels.reset_launches()
    lf = step("1")
    fused_launches = dict(kernels.launches)
    equal = bool(torch.equal(lf, lk))
    log(f"  fused norm engaged: {engaged}; launches {fused_launches}; logits bit-equal to the "
        f"unfused step: {equal}")
    if not (engaged and equal and fused_launches[f"{kind}_matmul"] == 4 * cfg.n_layers + 1):
        fail(f"{kind} fused-norm decode step: engaged {engaged}, bit-equal {equal}")
    out["fused_norm_bit_equal"] = equal
    del engine, params
    torch.cuda.empty_cache()
    return out


def phase_experiments(torch) -> dict:
    """The kernel-variant entry point as a user runs it (all variants at the
    default K = 4096, O = 11008), counting the launches it makes."""
    from dllama_tpu_torch import kernels, qkernel_experiments

    kernels.reset_launches()
    rows = qkernel_experiments.main(["all"])
    counts = dict(kernels.launches)
    log(f"  launches: {counts}")
    for name in ("q40_matmul", "q40_nosub_matmul", "q40_int8_matmul"):
        if counts[name] == 0:
            fail(f"the variant run never launched {name}")
    return {"rows": rows, "launches": counts}


# ---------------------------------------------------------------------------
# Phase 3: the CLI on small models written by the port's writers
# ---------------------------------------------------------------------------

def write_small_model(workdir: Path, kind: str) -> tuple:
    import numpy as np

    from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
    from dllama_tpu_torch.formats.weights import tensor_plan, write_model
    from dllama_tpu_torch.quants import blocks

    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    words = [b" ", b"He", b"ll", b"o", b" w", b"or", b"ld", b"Hello", b" world", b"!"]
    vocab += words
    vocab += [f"tok{i}".encode() for i in range(512 - len(vocab))]
    scores = [0.0] * 259 + [float(i) for i in range(len(vocab) - 259)]
    tok_path = workdir / "small.t"
    write_tokenizer(str(tok_path), TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                     n_kv_heads=4, vocab_size=len(vocab), seq_len=256,
                     weights_float_type={"q40": blocks.Q40, "q80": blocks.Q80}[kind],
                     rope_theta=10000.0)
    rng = np.random.default_rng(0)
    tensors = {}
    for e in tensor_plan(spec):
        if e.name.startswith("rms") or ".rms" in e.name:
            tensors[e.name] = np.ones(e.d * e.n, np.float32)
        else:
            tensors[e.name] = 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32)
    model_path = workdir / f"small_{kind}.m"
    write_model(str(model_path), spec, tensors)
    return model_path, tok_path


def run_cli(model: Path, tok: Path, extra: list) -> tuple:
    """(token ids, stdout) of ``cli generate`` on ``model``."""
    cmd = [sys.executable, "-m", "dllama_tpu_torch.cli", "generate", "--model", str(model),
           "--tokenizer", str(tok), "--steps", "8", "--temperature", "0", "--seed", "0",
           "--prompt", "Hello world", *extra]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd[2:])} exited {proc.returncode}:\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-3000:]}")
    ids = [ln for ln in proc.stdout.splitlines() if ln.startswith("Token ids:")]
    if not ids or not ids[0].split(":", 1)[1].split():
        fail(f"{' '.join(cmd[2:])} printed no tokens:\n{proc.stdout[-2000:]}")
    return [int(t) for t in ids[0].split(":", 1)[1].split()], proc.stdout


def phase3() -> dict:
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for kind in ("q40", "q80"):
            model, tok = write_small_model(Path(d), kind)
            card, card_out = run_cli(model, tok, [])
            card32, _ = run_cli(model, tok, ["--dtype", "float32"])
            cpu32, _ = run_cli(model, tok, ["--dtype", "float32", "--device", "cpu",
                                            "--weights-float-type", kind])
            spec32, _ = run_cli(model, tok, ["--dtype", "float32", "--spec-draft", "8"])
            log(f"  {kind.upper()} model: cli generate on the card (bf16): {card}")
            log(f"  {kind.upper()} model: cli generate on the card (f32):  {card32}")
            log(f"  {kind.upper()} model: cli generate on the CPU  (f32):  {cpu32}")
            log(f"  {kind.upper()} model: cli generate --spec-draft 8 on the card (f32): {spec32}")
            if f"weights resident as {kind}" not in card_out:
                fail(f"the card run of the {kind} model did not keep {kind} weights")
            if card32 != cpu32:
                fail(f"{kind} model: card tokens {card32} differ from the CPU's {cpu32}")
            if spec32 != cpu32:
                fail(f"{kind} model: --spec-draft 8 tokens {spec32} differ from the CPU's plain "
                     f"{cpu32}")
            out[kind] = {"card_bf16": card, "card_f32": card32, "cpu_f32": cpu32,
                         "card_f32_spec_draft_8": spec32}
    return out


# ---------------------------------------------------------------------------
# Phase 4: batched decode through Engine.generate_batch and BatchSession
# ---------------------------------------------------------------------------

def batch_prompts(cfg, n: int, seed: int) -> list:
    """``n`` seeded prompts of 20-100 tokens."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(20, 101, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (m,), generator=g).tolist() for m in lens]


def leading_equal(a: list, b: list) -> int:
    """How many leading tokens two streams share."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase4(torch, dev, kind: str, batches: tuple, solo_ms: float, cfg_kw=None,
           steps: int = 32, then=None) -> dict:
    """``Engine.generate_batch`` on the Llama-3-8B shape with random ``kind``
    weights and a bf16 batch cache: the gates (a) step against solo, (d)
    launch counts, and for the largest batch of several (b) neighbours and
    (c) mid-flight admission; then ms per step, tokens/s, the profiler's
    device time and the solo-stream agreement at each batch size, and the
    largest batch's ms per step sampled. ``then(engine, prompts, out)``
    runs last on the same model, before it is freed."""
    from torch.profiler import ProfilerActivity, profile

    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig, row_seed

    cfg = ModelConfig(**(cfg_kw or LLAMA3_8B))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.random_quant_params(cfg, dev, gen, kind)
    engine = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                    cache_dtype=torch.bfloat16, device=dev, cuda_graphs=False)
    B_max = max(batches)
    prompts = batch_prompts(cfg, B_max, 2)
    out = {"kind": kind, "prompt_lens": [len(p) for p in prompts], "steps": steps}
    shape = (cfg.n_layers, B_max, cfg.seq_len, cfg.n_kv_heads, cfg.head_size)
    log(f"  {B_max} prompts of {out['prompt_lens']} tokens; bf16 batch cache {shape} x 2 = "
        f"{2 * math.prod(shape) * 2 / 1e9:.2f} GB")

    # (a) one batched step against each row's solo forward at T = 1, and
    # against the same batched step through the plain versions
    cache, pend, poss = engine._prefill_batch_rows(prompts)
    tokens = torch.tensor(pend, dtype=torch.long, device=dev)
    pos = torch.tensor(poss, dtype=torch.int32, device=dev)
    snapshot = {n: c.clone() for n, c in cache.items()}
    kernels.reset_launches()
    lb, _ = llama.forward_batched(cfg, engine.params, engine.rope, tokens, cache, pos,
                                  max(poss) + 1)
    step_launches = dict(kernels.launches)
    with plain_versions():
        lp, _ = llama.forward_batched(cfg, engine.params, engine.rope, tokens, snapshot, pos)
    del snapshot
    err_p = (lb - lp).abs().max().item()
    tol_p = 5e-2 * lp.abs().max().item()
    log(f"  (a) batched step vs the same step through the plain versions: max |dlogit| "
        f"{err_p:.4e} (tol 5e-2*max|logit| = {tol_p:.4e}, err/tol {err_p / tol_p:.4f})")
    if not err_p <= tol_p:
        fail(f"{kind} batched step vs plain versions: {err_p} > {tol_p}")
    out["step_vs_plain_err_over_tol"] = err_p / tol_p
    worst, argmax_same, row_err = 0.0, 0, []
    for b, p in enumerate(prompts):
        single = engine.new_cache()
        _, single = engine.prefill(single, p[:-1])
        ls, _ = llama.forward(cfg, engine.params, engine.rope, tokens[b:b + 1], single, poss[b])
        err = (lb[b] - ls[0]).abs().max().item()
        tol = 5e-2 * ls.abs().max().item()
        worst = max(worst, err / tol)
        row_err.append(err / tol)
        argmax_same += int(int(lb[b].argmax()) == int(ls[0].argmax()))
        if not (bool(torch.isfinite(lb[b]).all()) and err <= tol):
            fail(f"{kind} batched step row {b}: max |dlogit| {err} > {tol} (5e-2*max|logit|)")
        del single
    del cache
    torch.cuda.empty_cache()
    log(f"  (a) batched step vs solo forward, {B_max} rows: |dlogit|/tol by row "
        f"{[round(e, 4) for e in row_err]} (tol 5e-2*max|logit|, phase 2's); argmax equal in "
        f"{argmax_same}/{B_max} rows")
    out.update(step_vs_solo_worst_err_over_tol=worst, step_vs_solo_err_over_tol=row_err,
               step_argmax_equal=argmax_same)

    # (d) every step launches the batched K4 and K5 once per layer
    want = {k: 0 for k in step_launches}
    want.update({f"{kind}_matmul": 4 * cfg.n_layers + 1, "flash_decode_batched": cfg.n_layers,
                 "rope_cache_update_batched": cfg.n_layers})
    if step_launches != want:
        fail(f"{kind} batched step launched {step_launches}, want {want}")

    solo = {}
    for B in batches:
        rows = prompts[:B]
        kernels.reset_launches()
        got = engine.generate_batch(rows, steps)
        launches = dict(kernels.launches)
        if launches["flash_decode_batched"] != steps * cfg.n_layers or \
                launches["rope_cache_update_batched"] != steps * cfg.n_layers or \
                launches["flash_decode"] or launches["rope_cache_update"]:
            fail(f"{kind} generate_batch B={B}: launches {launches}")
        if any(len(r) != steps for r in got):
            fail(f"{kind} generate_batch B={B}: rows of {[len(r) for r in got]} tokens")
        # ms per step: chunks of 8 steps, one sync each
        cache, pend, poss = engine._prefill_batch_rows(rows)
        tok = torch.tensor(pend, dtype=torch.long, device=dev)
        p_dev = torch.tensor(poss, dtype=torch.int32, device=dev)
        temps, topps, gens = [0.0] * B, [1.0] * B, [None] * B
        host, per_step = list(poss), []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk, ok, p_dev = engine._decode_chunk_batch(cache, tok, p_dev, 8, temps, topps, gens,
                                                          host)
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3 / 8)
            tok, host = chunk[-1], [min(p + 8, cfg.seq_len - 1) for p in host]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            engine._decode_chunk_batch(cache, tok, p_dev, 3, temps, topps, gens, host)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / 3
        sampled = []
        if B == B_max:
            # the same chunks sampled: temperature 0.8, top-p 0.9, a generator per row
            s_gens = [torch.Generator(device=dev).manual_seed(row_seed(0, b)) for b in range(B)]
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine._decode_chunk_batch(cache, tok, p_dev, 8, [0.8] * B, [0.9] * B, s_gens,
                                           host)
                torch.cuda.synchronize()
                sampled.append((time.perf_counter() - t0) * 1e3 / 8)
        del cache
        by_name, families = device_time(prof, 3)
        busy = sum(by_name.values())
        ms = statistics.median(per_step)
        r = {"B": B, "ms_per_step_median": ms, "ms_per_step": per_step,
             "tokens_per_s": B * 1e3 / ms, "solo_tokens_per_s": 1e3 / solo_ms if solo_ms else None,
             "launches": launches, "prefill_ms": engine.prefill_ms, "decode_ms": engine.decode_ms,
             "tokens": got}
        if sampled:
            r.update(sampled_ms_per_step=sampled, sampled_ms_per_step_median=statistics.median(
                sampled))
        if busy > 0:
            r.update(device_busy_ms_per_step=busy, profiled_wall_ms_per_step=wall,
                     idle_share=max(0.0, 1.0 - busy / wall), kernels_per_step=families,
                     cuda_launches_per_step=sum(v["launches"] for v in families.values()))
        else:
            r.update(device_busy_ms_per_step="not measured", idle_share="not measured")
        # the rows' solo greedy streams (reported, not gated)
        for b in range(B):
            if b not in solo:
                solo[b] = [t for t, _ in engine.generate(prompts[b], steps)]
        r["leading_tokens_equal_solo"] = [leading_equal(got[b], solo[b]) for b in range(B)]
        vs = f" ({r['tokens_per_s'] * solo_ms / 1e3:.2f}x solo's {1e3 / solo_ms:.2f})" if solo_ms \
            else ""
        log(f"  B={B}: {ms:.3f} ms per step (median of 4 chunks of 8, one sync each), "
            f"{r['tokens_per_s']:.1f} tokens/s{vs}; launches over 32 steps {launches}")
        if sampled:
            log(f"    sampled (temperature 0.8, top-p 0.9, a generator per row): "
                f"{r['sampled_ms_per_step_median']:.3f} ms per step (median of 2 chunks of 8)")
        if busy > 0:
            log(f"    profiler, 3 steps: device busy {busy:.3f} ms/step of {wall:.3f} ms wall "
                f"(idle share {r['idle_share']:.3f}), {r['cuda_launches_per_step']:.0f} CUDA "
                f"launches per step; by kernel:")
            for fam, v in families.items():
                log(f"      {v['ms']:.4f} ms ({v['ms'] / busy:.3f} of busy) in "
                    f"{v['launches']:.0f} CUDA launches  {fam}")
        log(f"    greedy tokens equal to the row's solo stream (leading, of {steps}): "
            f"{r['leading_tokens_equal_solo']}")
        out[f"B{B}"] = r

    if len(batches) > 1:
        # (b) row 0 against neighbours that differ in every other row
        other = [prompts[0]] + batch_prompts(cfg, B_max - 1, 3)
        a = out[f"B{B_max}"]["tokens"][0]
        b0 = engine.generate_batch(other, steps)[0]
        log(f"  (b) row 0 bit-identical across two batches of {B_max} with other neighbours: "
            f"{a == b0}")
        if a != b0:
            fail(f"{kind} row 0 changed with its neighbours: {a} vs {b0}")
        # (c) mid-flight admission into a BatchSession of 4
        x = prompts[1]
        sess = engine.batch_session(max_batch=4, chunk=8)
        h = sess.admit(x, steps=16)
        start = []
        while not sess.is_done(h):
            start += sess.step_chunk().get(h, [])
        sess.close()
        sess = engine.batch_session(max_batch=4, chunk=8)
        for p in prompts[2:4]:
            sess.admit(p, steps=24)
        sess.step_chunk()
        h = sess.admit(x, steps=16)
        mid = []
        while not sess.is_done(h):
            mid += sess.step_chunk().get(h, [])
        sess.close()
        log(f"  (c) BatchSession(max_batch=4): admitted mid-flight == admitted at the start: "
            f"{mid == start} ({len(mid)} tokens)")
        if mid != start or len(mid) != 16:
            fail(f"{kind} mid-flight admission: {mid} vs {start}")
        out.update(neighbours_bit_equal=True, mid_flight_bit_equal=True)
    if then is not None:
        then(engine, prompts, out)
    del engine, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 5: speculative decoding through generate_spec and generate_batch_spec
# ---------------------------------------------------------------------------

def profile_window(torch, run) -> tuple:
    """(device busy ms, wall ms, ms by kernel name, families, steps) of
    ``run()`` under the profiler; ``run`` returns how many steps it made and
    every number is per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / n
    by_name, families = device_time(prof, n)
    return sum(by_name.values()), wall, by_name, families, n


def log_split(busy: float, wall: float, families: dict, what: str) -> dict:
    """Log a profiler window's split by kernel family; returns its record."""
    if busy <= 0:
        log(f"    profiler showed no device time: {what} device split not measured")
        return {"device_busy_ms": "not measured", "idle_share": "not measured"}
    launches = sum(v["launches"] for v in families.values())
    log(f"    profiler: device busy {busy:.3f} ms per {what} of {wall:.3f} ms wall (idle share "
        f"{max(0.0, 1.0 - busy / wall):.3f}), {launches:.0f} CUDA launches per {what}; by kernel:")
    for fam, v in families.items():
        if v["launches"]:
            log(f"      {v['ms']:.4f} ms ({v['ms'] / busy:.3f} of busy) in {v['launches']:.0f} "
                f"CUDA launches  {fam}")
    return {"device_busy_ms": busy, "profiled_wall_ms": wall,
            "idle_share": max(0.0, 1.0 - busy / wall), "cuda_launches": launches,
            "kernels": families}


def phase5(torch, dev, engine, prompts: list, solo: dict, batched: dict) -> dict:
    """Prompt-lookup speculative decoding on phase 4's Q40 model. Gates: (a)
    one ``forward_batched_verify`` at B = 8, T = 9 (rows at phase 4's mixed
    positions, random drafts), row by row against the solo ``forward`` at
    (T = 9, pos[b]), and (b) against the same step through the plain
    versions, both within phase 2's 5e-2 * max|logit|; every verify step
    launches K1 129 times and the K5 verify form once per layer; neither a
    verify forward (solo or batched) nor the generator's state snapshots
    wait for the device; sampled ``generate_spec`` with no draft (T = 1
    verify steps, plain decode's kernels) gives plain sampled ``generate``'s
    tokens. The sampled verify's replay, on the card: (c) restoring the
    state noted after draw k puts a CUDA generator where draw k + 1 starts;
    (d) ``verify_sampled`` on a T = 9 verify step's logits picks what
    ``sample_dynamic`` picks row by row with the same seed; (e) tokens 1..9
    of a plain sampled stream, recomputed through T = 1 steps with the
    stream's own noise, are the stream's tokens. Logged beside (e): the same
    noise on the T = 9 verify logits of the same positions (how far the
    routes' logits differ, and which tokens change). Logged: solo
    ``generate_spec`` (draft 8, phase 2's prompt and 33 tokens) with no
    history and with the prompt + phase 2's greedy stream as history (ms
    and tokens per verify step, rows fed per step, ms per token against
    phase 2's, the device split and launches per verify step), sampled with
    draft 8 against plain sampled ``generate``, and ``generate_batch_spec``
    at B = 8 (ms per verify step, rows fed per step, tokens/s against phase
    4's B = 8, the device split at T = 9, the plain verify attention's
    time)."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.ops.attention import gqa_attention_batched
    from dllama_tpu_torch.runtime.generate import verify_sampled
    from dllama_tpu_torch.runtime.sampler import (
        SamplerConfig, gumbel_noise, sample_dynamic, sample_rows,
    )

    cfg, B, T = engine.cfg, len(prompts), 9
    out = {}

    # (a), (b): one batched verify step
    cache, pend, poss = engine._prefill_batch_rows(prompts)
    drafts = torch.randint(0, cfg.vocab_size, (B, T - 1), generator=torch.Generator().manual_seed(4))
    tokens = torch.cat([torch.tensor(pend)[:, None], drafts], 1).to(dev)
    pos = torch.tensor(poss, dtype=torch.int32, device=dev)
    snapshot = {n: c.clone() for n, c in cache.items()}
    kernels.reset_launches()
    lv, _ = llama.forward_batched_verify(cfg, engine.params, engine.rope, tokens, cache, pos)
    torch.cuda.synchronize()
    step_launches = dict(kernels.launches)
    want = {k: 0 for k in step_launches}
    want.update(q40_matmul=4 * cfg.n_layers + 1, rope_cache_update_verify=cfg.n_layers)
    if step_launches != want:
        fail(f"verify step launched {step_launches}, want {want}")
    with plain_versions():
        lp, _ = llama.forward_batched_verify(cfg, engine.params, engine.rope, tokens, snapshot,
                                             pos)
    del snapshot
    err_p = (lv - lp).abs().max().item()
    tol_p = 5e-2 * lp.abs().max().item()
    log(f"  (b) verify step B={B} T={T} at pos {poss} vs the same step through the plain "
        f"versions: max |dlogit| {err_p:.4e} (tol 5e-2*max|logit| = {tol_p:.4e}, err/tol "
        f"{err_p / tol_p:.4f}); launches {step_launches}")
    if not (bool(torch.isfinite(lv).all()) and err_p <= tol_p):
        fail(f"verify step vs plain versions: {err_p} > {tol_p}")
    del lp
    row_err, argmax_same = [], 0
    for b, p in enumerate(prompts):
        _, single = engine.prefill(engine.new_cache(), p[:-1])
        ls, _ = llama.forward(cfg, engine.params, engine.rope, tokens[b], single, poss[b])
        err = (lv[b] - ls).abs().max().item()
        tol = 5e-2 * ls.abs().max().item()
        row_err.append(err / tol)
        argmax_same += int(torch.equal(lv[b].argmax(-1), ls.argmax(-1)))
        if not err <= tol:
            fail(f"verify step row {b}: max |dlogit| {err} > {tol} (5e-2*max|logit|) against "
                 f"its solo forward at T={T}, pos {poss[b]}")
        del single
    log(f"  (a) verify step vs each row's solo forward at (T={T}, pos[b]): |dlogit|/tol by row "
        f"{[round(e, 4) for e in row_err]}; all {T} argmaxes equal in {argmax_same}/{B} rows")
    out.update(verify_vs_plain_err_over_tol=err_p / tol_p, verify_vs_solo_err_over_tol=row_err,
               verify_rows_argmax_equal=argmax_same)

    # nothing inside a verify step waits for the device: the forwards (solo
    # and batched), and the sampled verify's generator snapshots
    g = torch.Generator(device=dev).manual_seed(1)

    def draws():
        states = []
        for _ in range(T):
            gumbel_noise(cfg.vocab_size, g, dev)
            states.append(g.get_state())
        g.set_state(states[3])

    _, single = engine.prefill(engine.new_cache(), prompts[0][:-1])
    for what, fn in (
            ("a B=8 verify forward", lambda: llama.forward_batched_verify(
                cfg, engine.params, engine.rope, tokens, cache, pos)),
            ("a solo verify forward (T=9)", lambda: llama.forward(
                cfg, engine.params, engine.rope, tokens[0], single, poss[0])),
            (f"{T} Gumbel draws with get_state after each and one set_state", draws)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            fail(f"{what} synchronizes with the device: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log(f"  {what}: no host sync (torch.cuda.set_sync_debug_mode('error'))")
    del single

    # solo generate_spec, two ways
    prompt, plain = solo["prompt"], solo["tokens"]
    steps = len(plain)
    list(engine.generate_spec(prompt, 4, history=prompt + plain))  # warm
    for way, hist in (("no history", None), ("history = prompt + greedy stream", prompt + plain)):
        kernels.reset_launches()
        toks, stats = [], []
        with rows_fed(llama, "forward", 0) as ts:
            for t, st in engine.generate_spec(prompt, steps, draft_len=8, history=hist):
                toks.append(t)
                stats.append(st)
        launches = dict(kernels.launches)
        verify = [st.generation_ms for st in stats[1:] if st.generation_ms > 0]
        n = len(verify)
        if launches["rope_cache_update_verify"] or launches["flash_decode"] != n * cfg.n_layers \
                or launches["rope_cache_update"] != n * cfg.n_layers:
            fail(f"solo generate_spec ({way}): {n} verify steps launched {launches}")
        r = {"tokens": toks, "verify_steps": n, "ms_per_verify_step_median": statistics.median(verify),
             "tokens_per_verify_step": (len(toks) - 1) / n,
             "ms_per_token": sum(verify) / (len(toks) - 1),
             "plain_decode_ms_per_token": solo["decode_ms_median"],
             "leading_tokens_equal_plain": leading_equal(toks, plain), "launches": launches,
             "rows_fed": t_histogram(ts)}
        log(f"  generate_spec, draft 8, {way}: {n} verify steps for {len(toks) - 1} tokens after "
            f"the prefill's ({r['tokens_per_verify_step']:.2f} a step; steps by rows fed T: "
            f"{r['rows_fed']}); "
            f"{r['ms_per_verify_step_median']:.3f} ms per verify step (median), "
            f"{r['ms_per_token']:.3f} ms per token against phase 2's plain decode "
            f"{solo['decode_ms_median']:.3f}; greedy tokens equal to phase 2's (leading, of "
            f"{steps}): {r['leading_tokens_equal_plain']}")
        # the device split: a continuation of the same prefill, verify steps only
        list(engine.generate_spec(prompt, 1))
        sess = engine.final_session
        window = (hist or []) + prompt

        def run():
            return sum(st.generation_ms > 0 for _, st in engine.generate_spec(
                [], 10, session=sess, draft_len=8, history=window))

        busy, wall, _, families, _ = profile_window(torch, run)
        r["profile"] = log_split(busy, wall, families, "verify step")
        out["solo_" + ("organic" if hist is None else "drafted")] = r

    # sampled: with no draft every verify step is the T = 1 forward plain
    # decode runs, so the replayed draws must give plain decode's tokens bit
    # for bit
    scfg = SamplerConfig(temperature=0.8, topp=0.9, seed=5)
    plain_s = [t for t, _ in engine.generate(prompt, 17, sampler=scfg)]
    one_row = [t for t, _ in engine.generate_spec(prompt, 17, sampler=scfg, draft_len=0)]
    log(f"  sampled (temperature 0.8, top-p 0.9, seed 5), draft 0 (T = 1 verify steps): tokens "
        f"equal to plain sampled generate: {one_row == plain_s} ({len(plain_s)} tokens)")
    if one_row != plain_s:
        fail(f"sampled generate_spec with no draft {one_row} != plain sampled {plain_s}")

    # tokens 1..T of that stream predicted from one cache two ways: plain
    # decode's T = 1 steps, and one T-row verify forward of tokens 0..T-1
    list(engine.generate(prompt, 1, sampler=scfg))
    sess = engine.final_session
    fed = torch.tensor(plain_s[:T], dtype=torch.long, device=dev)
    c = {n: x.clone() for n, x in sess.cache.items()}
    lv9, _ = llama.forward(cfg, engine.params, engine.rope, fed, c, sess.pos)
    c = {n: x.clone() for n, x in sess.cache.items()}
    lp9 = torch.cat([llama.forward(cfg, engine.params, engine.rope, fed[i:i + 1], c,
                                   sess.pos + i)[0] for i in range(T)])
    del c
    V = lp9.shape[-1]
    g0 = torch.Generator(device=dev).manual_seed(scfg.seed)
    noise = torch.stack([gumbel_noise(V, g0, dev) for _ in range(T + 1)][1:])  # 0: the prefill's
    temps, topps = [scfg.temperature] * T, [scfg.topp] * T
    via_plain = sample_rows(lp9, temps, topps, gumbel=noise).tolist()
    via_verify = sample_rows(lv9, temps, topps, gumbel=noise).tolist()
    ok_e = via_plain == plain_s[1:T + 1]
    log(f"  (e) tokens 1..{T} of the plain sampled stream recomputed through T = 1 steps with "
        f"the stream's own noise: equal to the stream: {ok_e}")
    if not ok_e:
        fail(f"sampled replay through T = 1 steps {via_plain} != the stream {plain_s[1:T + 1]}")
    # what differs on the verify route: the logits' low bits, the top-p
    # ranking they give, and the tokens the same noise then picks
    probs_p, idx_p = torch.sort(torch.softmax(lp9.float() / scfg.temperature, -1), dim=-1,
                                descending=True, stable=True)
    _, idx_v = torch.sort(torch.softmax(lv9.float() / scfg.temperature, -1), dim=-1,
                          descending=True, stable=True)
    nucleus = ((probs_p.cumsum(-1) - probs_p) < scfg.topp).sum(-1).tolist()
    first_swap = [int((idx_p[i] != idx_v[i]).nonzero()[0]) if bool((idx_p[i] != idx_v[i]).any())
                  else None for i in range(T)]
    d_logit = (lv9 - lp9).abs().max().item()
    routes = {"max_abs_dlogit": d_logit, "max_abs_logit": lp9.abs().max().item(),
              "tokens_differ": sum(a != b for a, b in zip(via_plain, via_verify)),
              "argmax_differ": int((lv9.argmax(-1) != lp9.argmax(-1)).sum()),
              "nucleus_size": nucleus, "first_rank_swap": first_swap,
              "via_plain": via_plain, "via_verify": via_verify}
    log(f"    the same noise on the T = {T} verify logits of those positions: max |dlogit| "
        f"{d_logit:.4e} (max |logit| {routes['max_abs_logit']:.4e}); tokens differ in "
        f"{routes['tokens_differ']}/{T} rows, argmax in {routes['argmax_differ']}/{T}; top-p "
        f"nucleus sizes {nucleus}; first rank where the sorted vocabularies differ {first_swap}")

    # (d) one sampled verify against row-by-row sample_dynamic, same seed
    gv = torch.Generator(device=dev).manual_seed(77)
    picks, states = verify_sampled(lv9, scfg, gv)
    gr = torch.Generator(device=dev).manual_seed(77)
    rowwise = [int(sample_dynamic(lv9[i], scfg.temperature, scfg.topp, gr)) for i in range(T)]
    ok_d = picks.tolist() == rowwise
    log(f"  (d) verify_sampled on the T = {T} verify logits vs row-by-row sample_dynamic (same "
        f"seed): equal: {ok_d}")
    if not ok_d:
        fail(f"verify_sampled {picks.tolist()} != row-by-row sample_dynamic {rowwise}")
    # (c) each noted state restores the CUDA generator to the next draw
    gf = torch.Generator(device=dev).manual_seed(77)
    fresh = [gumbel_noise(V, gf, dev) for _ in range(T)]
    bad = []
    for k in range(T - 1):
        gv.set_state(states[k])
        if not torch.equal(gumbel_noise(V, gv, dev), fresh[k + 1]):
            bad.append(k)
    log(f"  (c) CUDA generator: restoring the state noted after draw k gives draw k + 1 of a "
        f"fresh generator, k = 0..{T - 2}: {'all equal' if not bad else f'differs at {bad}'}")
    if bad:
        fail(f"CUDA generator restore: states {bad} do not replay the next draw")
    out["sampled_routes"] = routes

    groups = 0
    spec_s = []
    for t, st in engine.generate_spec(prompt, 17, sampler=scfg, history=prompt + plain_s):
        spec_s.append(t)
        groups += st.generation_ms > 0
    out["sampled"] = {"plain": plain_s, "spec": spec_s, "steps": groups,
                      "leading_tokens_equal": leading_equal(spec_s, plain_s)}
    log(f"  sampled, draft 8 from the plain sampled stream: {len(spec_s)} tokens in {groups} "
        f"steps (the prefill's included); tokens equal to plain sampled generate (leading, of "
        f"17): {out['sampled']['leading_tokens_equal']}")

    # batched generate_batch_spec at B = 8
    kernels.reset_launches()
    with rows_fed(llama, "forward_batched_verify", 1) as ts:
        rows, st = engine.generate_batch_spec(prompts, 32, draft_len=8)
    launches = dict(kernels.launches)
    if launches["rope_cache_update_verify"] != st["verify_steps"] * cfg.n_layers \
            or launches["q40_matmul"] == 0 or launches["flash_decode_batched"] \
            or launches["rope_cache_update_batched"]:
        fail(f"generate_batch_spec: {st} launched {launches}")
    ms = engine.decode_ms / st["verify_steps"]
    tps = st["emitted"] * 1e3 / engine.decode_ms
    ref = batched["B8"]
    r = {"stats": st, "ms_per_verify_step": ms, "tokens_per_s": tps,
         "generate_batch_tokens_per_s": ref["tokens_per_s"],
         "generate_batch_ms_per_step": ref["ms_per_step_median"], "launches": launches,
         "leading_tokens_equal_generate_batch": [leading_equal(rows[b], ref["tokens"][b])
                                                 for b in range(B)], "tokens": rows,
         "rows_fed": t_histogram(ts)}
    log(f"  generate_batch_spec B={B}, draft 8, 32 steps: {st}; steps by rows fed T: "
        f"{r['rows_fed']}; {ms:.3f} ms per verify step, "
        f"{tps:.1f} tokens/s against phase 4's B=8 generate_batch {ref['tokens_per_s']:.1f} "
        f"({ref['ms_per_step_median']:.3f} ms per step); launches {launches}")
    log(f"    greedy tokens equal to phase 4's generate_batch rows (leading, of 32): "
        f"{r['leading_tokens_equal_generate_batch']}")

    def run_b():
        for _ in range(3):
            logits, _ = llama.forward_batched_verify(cfg, engine.params, engine.rope, tokens,
                                                     cache, pos)
            torch.argmax(logits, dim=-1).tolist()
        return 3

    busy, wall, by_name, families, _ = profile_window(torch, run_b)
    r["profile"] = log_split(busy, wall, families, "B=8 T=9 verify step")
    r["profile_top"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    # the plain verify attention of one layer, CUDA events
    q = torch.randn((B, T, cfg.n_heads, cfg.head_size), device=dev).to(torch.bfloat16)
    att = time_ms(torch, lambda: gqa_attention_batched(q, cache["k"][1], cache["v"][1], pos))
    r["verify_attention_ms_per_layer"] = att
    log(f"    plain verify attention (gqa_attention_batched, [8, 9, 32, 128] over [8, 1024, 8, "
        f"128] bf16): {att:.4f} ms per layer, {att * cfg.n_layers:.3f} ms per verify step")
    out["batched"] = r
    del cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6: CUDA-graphed decode (StepGraph replays), against the eager steps
# ---------------------------------------------------------------------------

#: the runtime calls that put work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx")


def graph_window(torch, run) -> dict:
    """``run()`` (returns its step count) under the profiler: device busy
    and wall ms per step, the idle share, the split by kernel family, and
    the host's launch calls per step (one ``cudaGraphLaunch`` a replay)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / n
    by_name, families = device_time(prof, n)
    calls = {}
    for ev in prof.key_averages():
        if ev.key in LAUNCH_CALLS:
            calls[ev.key] = calls.get(ev.key, 0) + ev.count / n
    busy = sum(by_name.values())
    r = {"wall_ms": wall, "host_launch_calls": calls}
    if busy > 0:
        r.update(device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall),
                 cuda_launches=sum(v["launches"] for v in families.values()), kernels=families)
    else:
        r.update(device_busy_ms="not measured", idle_share="not measured")
    return r


def log_window(r: dict, what: str) -> None:
    calls = ", ".join(f"{v:.1f} {k}" for k, v in sorted(r["host_launch_calls"].items()))
    if r["device_busy_ms"] == "not measured":
        log(f"    profiler: device busy not measured; {r['wall_ms']:.3f} ms wall per {what}; "
            f"host calls per {what}: {calls}")
        return
    log(f"    profiler: device busy {r['device_busy_ms']:.3f} ms per {what} of {r['wall_ms']:.3f}"
        f" ms wall (idle share {r['idle_share']:.3f}); {r['cuda_launches']:.0f} kernels per "
        f"{what}; host calls per {what}: {calls}")
    for fam, v in r["kernels"].items():
        if v["launches"]:
            log(f"      {v['ms']:.4f} ms in {v['launches']:.0f} kernels  {fam}")


def k4_bound_cost(torch, dev, gen) -> dict:
    """K4 at B = 1 with the graphs' grid bound S against the solo launch
    (tight grid), at pos 116 and 1000, bf16 cache cold in L2: what the
    empty blocks of a fixed grid cost per decode token (32 layers)."""
    from dllama_tpu_torch.ops import flash_decode

    L, S, kv, group, hd = 64, 1024, 8, 4, 128
    kc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(torch.bfloat16)
    vc = torch.randn((L, S, kv, hd), device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn((1, kv * group, hd), device=dev, generator=gen).to(torch.bfloat16)
    out = {}
    for pos in (116, 1000):
        p_dev = torch.tensor([pos], dtype=torch.int32, device=dev)
        a = flash_decode.flash_decode_attention(q, kc, vc, pos, 3)
        b = flash_decode.flash_decode_attention_batched(q, kc[:, None], vc[:, None], p_dev, 3, S)
        if not torch.equal(a, b):
            fail(f"K4 at B = 1, bound S != the solo launch at pos {pos}")
        layers = itertools.count()
        tight = time_ms(torch, lambda: flash_decode.flash_decode_attention(
            q, kc, vc, pos, next(layers) % L))
        layers = itertools.count()
        fixed = time_ms(torch, lambda: flash_decode.flash_decode_attention_batched(
            q, kc[:, None], vc[:, None], p_dev, next(layers) % L, S))
        out[pos] = {"solo_ms": tight, "bound_S_ms": fixed,
                    "per_token_ms": 32 * (fixed - tight)}
        log(f"  K4 at pos {pos}: solo launch {tight:.4f} ms, B = 1 with bound S {fixed:.4f} ms "
            f"(bit-equal); {out[pos]['per_token_ms']:+.4f} ms per token over 32 layers")
    del kc, vc
    torch.cuda.empty_cache()
    return out


def phase6(torch, dev, kind: str, batches: tuple, sampled: bool, mixed: bool,
           then=None) -> dict:
    """Graphed decode on the Llama-3-8B shape with random ``kind`` weights
    (phase 2's model and prompt, phase 4's prompts and bf16 batch cache),
    one engine with ``cuda_graphs=True`` and one with False on the same
    parameters. Gates: (a) the first graphed decode step's logits and cache
    (all but slot S - 1, which a graph's warm-up step writes) are bit-equal
    to eager ``forward`` at T = 1, and a replay counts the
    launches it captured (129 matmuls, 32 batched K4 and K5); (b) 33 greedy
    tokens of graphed ``generate`` = eager, and a second call without a
    session captures nothing (the engine's resident cache); (c)
    ``generate_fused`` for 97 tokens (decode chunks of 64 and 32) =
    ``generate``'s, with no capture; (d) with ``sampled``: a sampled stream
    (temperature 0.8, top-p 0.9, seed 5) graphed = eager, solo and for the
    B = 8 rows of ``generate_batch``, and, with ``mixed``, a
    ``BatchSession`` of sampled and greedy requests admitted and released
    between chunks gives the eager session's tokens with one greedy and one
    sampled graph; (e) graphed batched chunks (4 of 8 steps) at each B give
    the eager chunks' tokens, flags and caches (but slot S - 1) bit for
    bit, and, with ``mixed``, phase 4's mid-flight admission holds through
    graphs; (f) under ``torch.cuda.set_sync_debug_mode("error")`` a graphed
    chunk (solo, and batched sampled) makes no host sync, and its replays
    allocate nothing. Logged: ms per token of graphed ``generate`` and
    ``generate_fused`` beside eager, whole-call ms of ``generate`` with and
    without a capture, ms per step and tokens/s batched, the profiler's
    device busy, idle share and host launch calls per token or step, capture
    ms and pool memory per graph, captures per admission, launches per
    replay. ``then(engine, out)`` runs last, on the graphed engine (the
    eager one freed first)."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig, row_seed

    cfg = ModelConfig(**LLAMA3_8B)
    params = llama.random_quant_params(cfg, dev, torch.Generator(device=dev).manual_seed(0), kind)
    greedy = SamplerConfig(temperature=0.0, seed=0)
    graphed = Engine(cfg, params, greedy, cache_dtype=torch.bfloat16, device=dev)
    eager = Engine(cfg, graphed.params, greedy, cache_dtype=torch.bfloat16, device=dev,
                   cuda_graphs=False)
    prompt = torch.randint(0, cfg.vocab_size, (100,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    prompts = batch_prompts(cfg, max(batches), 2)
    want_step = {f"{kind}_matmul": 4 * cfg.n_layers + 1, "flash_decode_batched": cfg.n_layers,
                 "rope_cache_update_batched": cfg.n_layers}
    out = {"kind": kind}
    S = cfg.seq_len

    def new_graph(cache, temps):
        """A graph made now, with its capture ms and pool memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        a0 = torch.cuda.memory_allocated(dev)
        g = graphed.step_graph(cache, any(t > 0.0 for t in temps), graphed.decode_chunk)
        mem = {"capture_ms": g.capture_ms,
               "peak_mb": (torch.cuda.max_memory_allocated(dev) - a0) / 2 ** 20,
               "held_mb": (torch.cuda.memory_allocated(dev) - a0) / 2 ** 20}
        return g, mem

    # (a) the first graphed step against eager forward at T = 1
    cache = eager.new_cache()
    last, cache = eager.prefill(cache, prompt)
    nxt = torch.argmax(last).reshape(1)
    pos = len(prompt)
    twin = {n: c.clone() for n, c in cache.items()}
    le, _ = llama.forward(cfg, eager.params, eager.rope, nxt, cache, pos)
    g, mem = new_graph(twin, [0.0])
    g.load(nxt, pos)
    kernels.reset_launches()
    g.run(1)
    replay_launches = {k: v for k, v in kernels.launches.items() if v}
    torch.cuda.synchronize()
    a_equal = bool(torch.equal(g.logits, le))
    # slot S - 1 is the graph's warm-up step's (see StepGraph): the rest
    cache_equal = all(torch.equal(twin[n][:, :S - 1], cache[n][:, :S - 1]) for n in ("k", "v"))
    log(f"  (a) first graphed step vs eager forward (T = 1): logits bit-equal {a_equal}, cache "
        f"bit-equal {cache_equal}; one replay counted {replay_launches} (want {want_step})")
    log(f"    solo graph: capture {mem['capture_ms']:.1f} ms (warm-up step + capture); pool "
        f"peak {mem['peak_mb']:.1f} MB, held {mem['held_mb']:.1f} MB")
    if not (a_equal and cache_equal and replay_launches == want_step and g.counts == want_step):
        fail(f"{kind} graphed step: logits equal {a_equal}, cache equal {cache_equal}, launches "
             f"{replay_launches}, captured {g.counts}")
    out.update(step_logits_bit_equal=True, solo_graph=mem, launches_per_replay=g.counts)
    del cache, twin, g, le
    torch.cuda.empty_cache()

    # (b) 33 greedy tokens, graphed and eager
    def timed(engine, steps, sampler=None):
        toks, ms = [], []
        for tok, st in engine.generate(prompt, steps, sampler=sampler):
            toks.append(tok)
            ms.append(st.generation_ms)
        return toks, ms[1:]

    def call(engine, steps=33, sampler=None):
        """timed(), with the whole call's wall ms and the graphs it made."""
        made = engine.graphs.made
        t0 = time.perf_counter()
        toks, ms = timed(engine, steps, sampler)
        return toks, ms, (time.perf_counter() - t0) * 1e3, engine.graphs.made - made

    kernels.reset_launches()
    tg, ms_g, call1, made1 = call(graphed)
    launches = dict(kernels.launches)
    tg2, ms_g2, call2, made2 = call(graphed)
    te, ms_e, call_e, _ = call(eager)
    log(f"  (b) 33 greedy tokens, graphed generate == eager: {tg == te} (second call: "
        f"{tg2 == te}); ms per token median graphed {statistics.median(ms_g):.3f} (min "
        f"{min(ms_g):.3f}), eager {statistics.median(ms_e):.3f} (min {min(ms_e):.3f}); launches "
        f"over the graphed run (prefill, warm-up, 32 replays) "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"    whole call (prefill + 32 decode tokens): first graphed call {call1:.1f} ms with "
        f"{made1} capture (first decode token {ms_g[0]:.1f} ms), second {call2:.1f} ms with "
        f"{made2} (first decode token {ms_g2[0]:.3f} ms; the resident cache's graph), eager "
        f"{call_e:.1f} ms")
    if tg != te or tg2 != te:
        fail(f"{kind} graphed generate {tg} / {tg2} != eager {te}")
    if made1 != 1 or made2 != 0:
        fail(f"{kind} graphed generate calls captured {made1} then {made2} graphs (want 1, 0)")
    if launches["flash_decode_batched"] != 33 * cfg.n_layers or launches["flash_decode"]:
        fail(f"{kind} graphed generate launches {launches}")
    out.update(tokens=tg, generate_ms_graphed=ms_g, generate_ms_eager=ms_e,
               generate_ms_per_token_graphed=statistics.median(ms_g),
               generate_ms_per_token_eager=statistics.median(ms_e), launches_graphed=launches,
               generate_call_ms={"graphed_first": call1, "graphed_second": call2,
                                 "eager": call_e, "first_decode_token_ms_capture": ms_g[0],
                                 "first_decode_token_ms_second": ms_g2[0]})

    # (c) generate_fused: prefill's token + 96 decode steps (chunks of 64 and 32)
    gt = [t for t, _ in graphed.generate(prompt, 97)]
    made = graphed.graphs.made
    fused, _, fused_ms = graphed.generate_fused(prompt, 97)
    made = graphed.graphs.made - made
    sess = graphed.final_session
    fg = graphed.step_graph(sess.cache, False, graphed.decode_chunk)
    fused_e, _, fused_ms_e = eager.generate_fused(prompt, 97)
    steady = fused_ms / 96
    log(f"  (c) generate_fused, 97 tokens == generate's: {fused == gt} (eager fused too: "
        f"{fused_e == gt}); decode {fused_ms:.1f} ms for 96 steps, {made} captures (the "
        f"resident cache's graph): {steady:.3f} ms per token (eager fused "
        f"{fused_ms_e / 96:.3f}); final pos {sess.pos} (want {len(prompt) + 96})")
    if fused != gt or fused_e != gt or sess.pos != len(prompt) + 96 or made:
        fail(f"{kind} generate_fused {fused} vs generate {gt} (eager fused {fused_e}), "
             f"{made} captures")
    out.update(fused_tokens_equal=True, fused_decode_ms=fused_ms, fused_ms_per_token=steady,
               fused_ms_per_token_eager=fused_ms_e / 96)

    # device time and host launch calls of graphed solo steps (8 replays)
    tok = torch.tensor(sess.pending_token, device=dev)

    def solo_chunk():
        graphed._decode_chunk_solo(sess.cache, tok, sess.pos, 8, greedy, None)
        return 8

    solo_chunk()
    r = graph_window(torch, solo_chunk)
    log_window(r, "graphed token")
    out["graphed_token_profile"] = r
    # (g) one rope launch a layer in place of q's rope, the table gathers and
    # the k/v copies: at least 15 kernels a layer fewer than before
    if r["device_busy_ms"] == "not measured":
        fail(f"{kind} graphed token: the profiler showed no device time, so gate (g) is "
             f"unchecked")
    rope = r["kernels"]["rope_cache_kernel"]["launches"]
    most = GRAPHED_KERNELS_BEFORE - 15 * cfg.n_layers
    log(f"  (g) graphed token: {r['cuda_launches']:.3f} kernels (before: "
        f"{GRAPHED_KERNELS_BEFORE}; at most {most}), {rope:.3f} rope launches, PyTorch's "
        f"{r['kernels']['other']['launches']:.3f} kernels in "
        f"{r['kernels']['other']['ms']:.3f} ms")
    if abs(rope - cfg.n_layers) > 1e-6 or (kind == "q40" and r["cuda_launches"] > most):
        fail(f"{kind} graphed token: {r['cuda_launches']} kernels, {rope} rope launches")

    # (f) solo: a chunk's replays make no host sync and allocate nothing
    torch.cuda.synchronize()
    n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fg.load(tok, sess.pos)
        fg.run(8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - n_alloc
    log(f"  (f) solo chunk of 8 replays under sync debug 'error': no sync; allocations {allocs}")
    if allocs:
        fail(f"{kind} a graphed chunk allocated {allocs} blocks")
    del sess, fg
    graphed.final_session = eager.final_session = None
    torch.cuda.empty_cache()

    if sampled:  # (d) sampled streams, solo and B = 8
        s = SamplerConfig(temperature=0.8, topp=0.9, seed=5)
        sg, ms_sg = timed(graphed, 33, s)
        se, ms_se = timed(eager, 33, s)
        first = leading_equal(sg, se)
        log(f"  (d) sampled solo (0.8 / 0.9, seed 5), graphed == eager: {sg == se} (leading "
            f"equal {first} of 33); ms per token graphed {statistics.median(ms_sg):.3f}, eager "
            f"{statistics.median(ms_se):.3f}")
        bg = graphed.generate_batch(prompts, 32, sampler=s)
        be = eager.generate_batch(prompts, 32, sampler=s)
        lead = [leading_equal(a, b) for a, b in zip(bg, be)]
        log(f"  (d) sampled B = {len(prompts)} rows, graphed == eager: {bg == be} (leading equal "
            f"{lead})")
        if sg != se or bg != be:
            fail(f"{kind} sampled graphed streams differ from eager: solo from token {first}, "
                 f"rows from {lead}")
        out.update(sampled_solo_equal=True, sampled_batch_equal=True,
                   sampled_ms_per_token_graphed=statistics.median(ms_sg),
                   sampled_ms_per_token_eager=statistics.median(ms_se))

    # (e) batched chunks, graphed against eager, timed
    for B in batches:
        cache, pend, poss = eager._prefill_batch_rows(prompts[:B])
        twin = {n: c.clone() for n, c in cache.items()}
        tok0 = torch.tensor(pend, dtype=torch.long, device=dev)
        pos0 = torch.tensor(poss, dtype=torch.int32, device=dev)
        temps, topps, gens = [0.0] * B, [1.0] * B, [None] * B
        g, mem = new_graph(twin, temps)
        runs = {}
        for name, engine, c in (("eager", eager, cache), ("graphed", graphed, twin)):
            tok, p, host, toks, oks, per_step = tok0, pos0, list(poss), [], [], []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chunk, ok, p = engine._decode_chunk_batch(c, tok, p, 8, temps, topps, gens, host)
                toks += chunk.tolist()  # the chunk's one host sync
                per_step.append((time.perf_counter() - t0) * 1e3 / 8)
                oks.append(ok.tolist())
                tok, host = chunk[-1], [min(h + 8, cfg.seq_len - 1) for h in host]
            runs[name] = {"tokens": toks, "ok": oks, "ms": per_step, "tok": tok, "pos": p,
                          "host": host}
        same = (runs["eager"]["tokens"] == runs["graphed"]["tokens"]
                and runs["eager"]["ok"] == runs["graphed"]["ok"]
                and all(torch.equal(cache[n][:, :, :S - 1], twin[n][:, :, :S - 1])
                        for n in ("k", "v")))
        ms_g, ms_e = (statistics.median(runs[n]["ms"]) for n in ("graphed", "eager"))
        log(f"  (e) B={B}: 4 graphed chunks of 8 == eager (tokens, flags, caches): {same}; ms "
            f"per step graphed {ms_g:.3f} ({B * 1e3 / ms_g:.1f} tokens/s), eager {ms_e:.3f} "
            f"({B * 1e3 / ms_e:.1f} tokens/s); graph capture {mem['capture_ms']:.1f} ms, pool "
            f"peak {mem['peak_mb']:.1f} MB, held {mem['held_mb']:.1f} MB")
        if not same:
            fail(f"{kind} B={B} graphed chunks differ from eager")
        rg = runs["graphed"]

        def batch_chunk(n=3):
            graphed._decode_chunk_batch(twin, rg["tok"], rg["pos"], n, temps, topps, gens,
                                        rg["host"])
            return n

        prof = graph_window(torch, batch_chunk)
        log_window(prof, "graphed step")
        row = {"B": B, "bit_equal": True, "ms_per_step_graphed": ms_g, "ms_per_step_eager": ms_e,
               "ms_graphed": rg["ms"], "ms_eager": runs["eager"]["ms"],
               "tokens_per_s_graphed": B * 1e3 / ms_g, "tokens_per_s_eager": B * 1e3 / ms_e,
               "graph": mem, "profile": prof}
        if B == max(batches) and sampled:
            # sampled chunks: ms per step, and (f) no host sync in a graphed chunk
            s_gens = [torch.Generator(device=dev).manual_seed(row_seed(0, b)) for b in range(B)]
            st = [0.8] * B
            gs, smem = new_graph(twin, st)
            per = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graphed._decode_chunk_batch(twin, rg["tok"], rg["pos"], 8, st, [0.9] * B, s_gens,
                                            rg["host"])
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3 / 8)
            torch.cuda.synchronize()
            n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                gs.load(rg["tok"], rg["pos"], st, [0.9] * B)
                gs.run(8, s_gens)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - n_alloc
            torch.cuda.set_sync_debug_mode("error")
            try:
                graphed._decode_chunk_batch(twin, rg["tok"], rg["pos"], 8, st, [0.9] * B, s_gens,
                                            rg["host"])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            log(f"    sampled (0.8 / 0.9): {statistics.median(per):.3f} ms per step graphed "
                f"(capture {smem['capture_ms']:.1f} ms); (f) a sampled chunk under sync debug "
                f"'error': no sync; its replays' allocations {allocs}")
            if allocs:
                fail(f"{kind} a graphed sampled B = {B} chunk allocated {allocs} blocks")
            row.update(sampled_ms_per_step_graphed=statistics.median(per), sampled_graph=smem)
        out[f"B{B}"] = row
        del cache, twin, g, runs, rg
        torch.cuda.empty_cache()

    if mixed:  # phase 4's gate (c) through graphs
        x = prompts[1]
        got = {}
        for name, engine in (("eager", eager), ("graphed", graphed)):
            sess = engine.batch_session(max_batch=4, chunk=8)
            h = sess.admit(x, steps=16)
            start = []
            while not sess.is_done(h):
                start += sess.step_chunk().get(h, [])
            sess.close()
            got[name] = start
        sess = graphed.batch_session(max_batch=4, chunk=8)
        for p in prompts[2:4]:
            sess.admit(p, steps=24)
        sess.step_chunk()
        h = sess.admit(x, steps=16)
        mid = []
        while not sess.is_done(h):
            mid += sess.step_chunk().get(h, [])
        sess.close()
        ok = mid == got["graphed"] == got["eager"] and len(mid) == 16
        log(f"  (e) BatchSession(max_batch=4) through graphs: admitted mid-flight == at the start "
            f"== eager: {ok}")
        if not ok:
            fail(f"{kind} graphed mid-flight admission: {mid} vs {got}")
        out["mid_flight_bit_equal"] = True

    if mixed and sampled:  # (d) sampled and greedy requests through one BatchSession
        reqs = [(prompts[i % len(prompts)], 0.8 if i % 2 else 0.0, 8 * (1 + i % 3))
                for i in range(12)]
        runs = {}
        for name, engine in (("eager", eager), ("graphed", graphed)):
            sess = engine.batch_session(max_batch=8, chunk=8)
            queue, rows, toks, captures = list(enumerate(reqs)), {}, {}, []
            while queue or sess.num_live:
                admitted = 0
                while queue and sess.free_slots:
                    i, (p, temp, steps) = queue.pop(0)
                    rows[sess.admit(p, steps, SamplerConfig(temperature=temp, topp=0.9,
                                                            seed=i))] = i
                    toks[i], admitted = [], admitted + 1
                made = engine.graphs.made
                for r, fresh in sess.step_chunk().items():
                    toks[rows[r]] += fresh
                captures.append((admitted, engine.graphs.made - made))
                for r in [r for r in rows if sess.is_done(r)]:
                    sess.release(r)
                    del rows[r]
            n_steps = 8 * len(captures)
            runs[name] = {"tokens": toks, "captures": captures, "chunks": len(captures),
                          "ms_per_step": sess.decode_ms / n_steps,
                          "tokens_per_s": sum(map(len, toks.values())) * 1e3 / sess.decode_ms}
            sess.close()
        rg, re_ = runs["graphed"], runs["eager"]
        made = sum(c for _, c in rg["captures"])
        same = rg["tokens"] == re_["tokens"]
        log(f"  (d) BatchSession(max_batch=8), 12 requests alternating greedy and sampled (0.8 / "
            f"0.9), budgets 8/16/24, released when done and replaced between chunks: graphed "
            f"== eager: {same}; (admissions, captures) per chunk {rg['captures']}: {made} "
            f"captures for 12 admissions; {rg['ms_per_step']:.3f} ms per step graphed "
            f"({rg['tokens_per_s']:.1f} tokens/s), eager {re_['ms_per_step']:.3f} "
            f"({re_['tokens_per_s']:.1f} tokens/s), {rg['chunks']} chunks of 8")
        if not same or made > 2:
            fail(f"{kind} mixed BatchSession: graphed tokens equal eager {same}, {made} captures")
        out["mixed_session"] = {"bit_equal": True, "captures": rg["captures"],
                                "ms_per_step_graphed": rg["ms_per_step"],
                                "ms_per_step_eager": re_["ms_per_step"],
                                "tokens_per_s_graphed": rg["tokens_per_s"],
                                "tokens_per_s_eager": re_["tokens_per_s"]}
    del eager
    torch.cuda.empty_cache()
    if then is not None:
        then(graphed, out)
    del graphed, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7: mixture-of-experts (Mixtral, Grok-1) and the expert-indexed GEMVs
# ---------------------------------------------------------------------------

#: the expert widths (K -> O) of the indexed launch: each arch's fused
#: up|gate and its down
MOE_WIDTHS = [("mixtral_upgate", 4096, 28672), ("mixtral_down", 14336, 4096),
              ("grok1_upgate", 6144, 65536), ("grok1_down", 32768, 6144)]
MIXTRAL_8X7B = dict(arch="mixtral", dim=4096, hidden_dim=14336, n_layers=32, n_heads=32,
                    n_kv_heads=8, vocab_size=32000, seq_len=1024, head_size=128, kv_dim=1024,
                    n_experts=8, n_active_experts=2, rope_theta=1e6, dtype="bfloat16")
#: Grok-1 at full width, 4 of its 64 layers
GROK1_CUT = dict(arch="grok1", dim=6144, hidden_dim=32768, n_layers=4, n_heads=48,
                 n_kv_heads=8, vocab_size=131072, seq_len=1024, head_size=128, kv_dim=1024,
                 n_experts=8, n_active_experts=2, hidden_act="gelu", dtype="bfloat16")


def stacked_launch(qmatmul, kind, x, planes, ids, base, n_ids, plain=False):
    """The expert-indexed launch of ``kind`` (or its plain version)."""
    if kind == "q40":
        fn = qmatmul.q40_matmul_stacked_ref if plain else qmatmul.q40_matmul_stacked
    else:
        fn = qmatmul.q80_matmul_stacked_ref if plain else qmatmul.q80_matmul_stacked
    return fn(x, *planes, ids, base, n_ids)


def phase7a(torch, dev, gen) -> list:
    """K1's and K3's expert-indexed GEMVs at the Mixtral and Grok-1 expert
    widths, over a 2-layer stack of 8 experts (the launch reads layer 1's,
    ``base`` 8), T = 1, 2, 3 and n_sel = 2 and 6: within 1e-5 * max|ref| of
    the plain version, output j bit-equal to the plain launch on the view
    ``w[8 + ids[j]]``, and two launches bit-equal. Timed (ids rotating over
    the stack, so no launch finds its planes in L2) beside the bound — the
    n_sel planes' bytes at 3.35 TB/s — and bf16 ``torch.matmul`` on the
    n_sel dequantized planes (one batched call); the plain version at T =
    1."""
    from dllama_tpu_torch.ops import qmatmul

    E = 8
    rows = []
    for kind in ("q40", "q80"):
        for name, K, O in MOE_WIDTHS:
            stack = [torch.stack(p) for p in zip(*(quant_planes(torch, dev, gen, kind, K, O)
                                                   for _ in range(2 * E)))]
            per_plane = plane_bytes([p[0] for p in stack])
            for n_sel in (2, 6):
                id_sets = [torch.tensor([(r * n_sel + j) % E for j in range(n_sel)],
                                        dtype=torch.int32, device=dev) for r in range(E)]
                for T in (1, 2, 3):
                    x = torch.randn((T, K), device=dev, generator=gen).to(torch.bfloat16)
                    xs = torch.randn((n_sel, T, K), device=dev, generator=gen).to(torch.bfloat16)
                    shared = name.endswith("upgate")  # up|gate shares x; each down its own
                    xin = x if shared else xs
                    ids = id_sets[1]
                    got = stacked_launch(qmatmul, kind, xin, stack, ids, E, E)
                    again = stacked_launch(qmatmul, kind, xin, stack, ids, E, E)
                    torch.cuda.synchronize()
                    ref = stacked_launch(qmatmul, kind, xin, stack, ids, E, E, plain=True)
                    err = (got - ref).abs().max().item()
                    tol = 1e-5 * ref.abs().max().item()
                    views = all(
                        torch.equal(got[j], (qmatmul.q40_matmul if kind == "q40"
                                             else qmatmul.q80_matmul)(
                            x if shared else xs[j], *(p[E + e] for p in stack)))
                        for j, e in enumerate(ids.tolist()))
                    repeat = bool(torch.equal(got, again))
                    row = {"kind": kind, "matrix": name, "K": K, "O": O, "T": T,
                           "n_sel": n_sel, "max_abs_err": err, "tol": tol,
                           "view_bit_equal": views, "repeat_bit_equal": repeat}
                    nxt = itertools.count()
                    row["ms"] = time_ms(torch, lambda: stacked_launch(
                        qmatmul, kind, xin, stack, id_sets[next(nxt) % E], E, E))
                    b, by = bound_ms(n_sel * per_plane + xin.numel() * 2 + n_sel * T * O * 4,
                                     2.0 * n_sel * T * K * O, BF16_FLOPS)
                    row["bound_ms"], row["bound_by"] = b, by
                    extra = ""
                    if T == 1:
                        wd = torch.stack([dequant_bf16(torch, kind, [p[E + e] for p in stack])
                                          for e in ids.tolist()])
                        copies = [wd] + [wd.clone() for _ in range(
                            math.ceil(200e6 / (wd.numel() * 2)) - 1)]
                        nw = rotating(copies)
                        row["library_ms"] = time_ms(torch, lambda: torch.matmul(xin, nw()))
                        del wd, copies
                        row["plain_ms"] = time_ms(torch, lambda: stacked_launch(
                            qmatmul, kind, xin, stack, ids, E, E, plain=True), 5)
                        extra = (f"; plain {row['plain_ms']:.3f} ms, bf16 torch.matmul "
                                 f"{row['library_ms']:.4f} ms")
                    log(f"  {kind} indexed GEMV {name:14s} {K:5d}->{O:5d} T={T} n_sel={n_sel}: "
                        f"err {err:.3e} (tol {tol:.3e}), views bit-equal {views}, repeat "
                        f"{repeat}; {row['ms']:.4f} ms (bound {b:.4f}, "
                        f"{b / row['ms']:.2f} of it){extra}")
                    if not (err <= tol and views and repeat):
                        fail(f"{kind} indexed GEMV {name} T={T} n_sel={n_sel}: err {err} > "
                             f"{tol}, views bit-equal {views} or repeat {repeat}")
                    rows.append(row)
            del stack
            torch.cuda.empty_cache()
    return rows


def moe_bound(cfg, params) -> tuple:
    """(bytes a decode token must read, ms at 3.35 TB/s): the attention
    planes, ``k`` experts' up|gate and down planes per layer, and wcls."""
    from dllama_tpu_torch.ops.qmatmul import QuantTensor

    lay = params["layers"]
    n = plane_bytes([params["wcls"].w, params["wcls"].s, params["wcls"].s2])
    for name in ("wqkv", "wo"):
        n += plane_bytes([lay[name].w, lay[name].s, lay[name].s2])
    for name in ("moe_upgate", "moe_down"):
        qt = lay[name]
        assert isinstance(qt, QuantTensor)
        n += plane_bytes([qt.w, qt.s, qt.s2]) * cfg.n_active_experts // cfg.n_experts
    return n, n / HBM_BYTES_PER_S * 1e3


def phase7_model(torch, dev, what: str, cfg_kw: dict, kind: str, batches: tuple,
                 steps: int = 32) -> dict:
    """A MoE model of ``cfg_kw`` with random ``kind`` params made on the
    card (expert stacks filled a layer at a time), one graphed and one eager
    engine on them. Gates: a 100-token prefill, finite; the first decode
    step within phase 2's tolerance of the plain versions (and the same
    argmax); the first graphed step's logits and cache ([:S - 1]) bit-equal
    to eager ``forward``; ``steps`` + 1 greedy tokens of graphed
    ``generate`` = eager, the run counting the expert-indexed launches; a
    graphed chunk with no host sync; and graphed ``generate_batch`` rows at
    each B = eager rows. Logged: ms per token eager and graphed, the
    profiler's device busy, idle share and kernels per graphed token, the
    bound (``moe_bound``), tokens/s per B."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    cfg = ModelConfig(**cfg_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = llama.random_quant_params(cfg, dev, torch.Generator(device=dev).manual_seed(0), kind)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q_bytes, bound = moe_bound(cfg, params)
    greedy = SamplerConfig(temperature=0.0, seed=0)
    graphed = Engine(cfg, params, greedy, cache_dtype=torch.bfloat16, device=dev)
    eager = Engine(cfg, graphed.params, greedy, cache_dtype=torch.bfloat16, device=dev,
                   cuda_graphs=False)
    out = {"what": what, "kind": kind, "build_s": build_s,
           "peak_gb_after_build": torch.cuda.max_memory_allocated(dev) / 1e9,
           "bytes_per_token": q_bytes, "bound_ms": bound}
    log(f"  {what}: random {kind.upper()} params built on the card in {build_s:.2f} s; peak "
        f"memory {out['peak_gb_after_build']:.2f} GB; a decode token reads {q_bytes / 1e9:.3f} "
        f"GB (attention, {cfg.n_active_experts} of {cfg.n_experts} experts a layer, wcls): "
        f"bound {bound:.3f} ms at 3.35 TB/s")
    prompt = torch.randint(0, cfg.vocab_size, (100,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    S = cfg.seq_len

    cache = eager.new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = eager.prefill(cache, prompt)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if last.shape != (cfg.vocab_size,) or not bool(torch.isfinite(last).all()):
        fail(f"{what} prefill logits: shape {tuple(last.shape)}, finite "
             f"{bool(torch.isfinite(last).all())}")
    log(f"  prefill of {len(prompt)} tokens (bucket 128, every expert through the tile): "
        f"{out['prefill_ms']:.1f} ms, logits finite")
    nxt = torch.argmax(last).reshape(1)
    pos = len(prompt)
    snap = {n: c.clone() for n, c in cache.items()}
    le, _ = llama.forward(cfg, eager.params, eager.rope, nxt, cache, pos)
    with plain_versions():
        lr, _ = llama.forward(cfg, eager.params, eager.rope, nxt,
                              {n: c.clone() for n, c in snap.items()}, pos)
    err = (le - lr).abs().max().item()
    tol = 5e-2 * lr.abs().max().item()
    log(f"  decode step vs plain versions: max |dlogit| {err:.4e} (tol 5e-2*max|logit| = "
        f"{tol:.4e}), argmax {int(le.argmax())} vs {int(lr.argmax())}")
    if not (bool(torch.isfinite(le).all()) and err <= tol
            and int(le.argmax()) == int(lr.argmax())):
        fail(f"{what} decode step vs plain versions: {err} > {tol} or argmax differs")
    out["decode_vs_plain_max_abs_err"] = err
    del lr

    # the first graphed step against eager forward at T = 1
    g = graphed.step_graph(snap, False, graphed.decode_chunk)
    g.load(nxt, pos)
    g.run(1)
    torch.cuda.synchronize()
    a_equal = bool(torch.equal(g.logits, le))
    cache_equal = all(torch.equal(snap[n][:, :S - 1], cache[n][:, :S - 1]) for n in ("k", "v"))
    want = {f"{kind}_matmul": 2 * cfg.n_layers + 1, f"{kind}_matmul_stacked": 2 * cfg.n_layers,
            "flash_decode_batched": cfg.n_layers, "rope_cache_update_batched": cfg.n_layers}
    log(f"  first graphed step vs eager forward: logits bit-equal {a_equal}, cache bit-equal "
        f"{cache_equal}; a replay launches {g.counts} (want {want})")
    if not (a_equal and cache_equal and g.counts == want):
        fail(f"{what} graphed step: logits {a_equal}, cache {cache_equal}, counts {g.counts}")
    del g, snap, cache, le
    torch.cuda.empty_cache()

    def stream(engine, n):
        toks, ms = [], []
        for tok, st in engine.generate(prompt, n):
            toks.append(tok)
            ms.append(st.generation_ms)
        return toks, ms[1:]

    stream(graphed, 2)  # the resident cache's graph, captured
    kernels.reset_launches()
    tg, ms_g = stream(graphed, steps + 1)
    launches = {k: v for k, v in kernels.launches.items() if v}
    te, ms_e = stream(eager, steps + 1)
    log(f"  {steps + 1} greedy tokens, graphed == eager: {tg == te}; ms per token graphed "
        f"{statistics.median(ms_g):.3f} (min {min(ms_g):.3f}), eager "
        f"{statistics.median(ms_e):.3f}; bound {bound:.3f}; the graphed run's launches "
        f"(prefill + {steps} replays): {launches}")
    if tg != te:
        fail(f"{what} graphed tokens {tg} != eager {te}")
    for k in (f"{kind}_matmul", f"{kind}_matmul_stacked", "flash_decode_batched",
              "rope_cache_update_batched"):
        if launches.get(k, 0) < steps * want[k]:
            fail(f"{what}: the graphed run launched {k} {launches.get(k, 0)} times")
    out.update(tokens_equal=True, ms_per_token_graphed=statistics.median(ms_g),
               ms_per_token_eager=statistics.median(ms_e), ms_graphed=ms_g, ms_eager=ms_e,
               launches=launches)

    # device time of graphed tokens, and a chunk with no host sync
    sess = graphed.final_session
    tok = torch.tensor(sess.pending_token, device=dev)

    def chunk():
        graphed._decode_chunk_solo(sess.cache, tok, sess.pos, 8, greedy, None)
        return 8

    r = graph_window(torch, chunk)
    log_window(r, "graphed token")
    out["graphed_token_profile"] = r
    fg = graphed.step_graph(sess.cache, False, graphed.decode_chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fg.load(tok, sess.pos)
        fg.run(8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  a graphed chunk of 8 replays under sync debug 'error': no host sync")
    del fg, sess
    graphed.final_session = eager.final_session = None
    torch.cuda.empty_cache()

    prompts = batch_prompts(cfg, max(batches or (1,)), 2)
    for B in batches:
        rows = {}
        for name, engine in (("eager", eager), ("graphed", graphed)):
            t0 = time.perf_counter()
            rows[name] = engine.generate_batch(prompts[:B], 16)
            rows[name + "_decode_ms"] = engine.decode_ms
            rows[name + "_s"] = time.perf_counter() - t0
        same = rows["graphed"] == rows["eager"]
        tps = {n: B * 16 * 1e3 / rows[n + "_decode_ms"] for n in ("graphed", "eager")}
        log(f"  generate_batch B={B} ({'selected' if B * cfg.n_active_experts < cfg.n_experts else 'dense combine'}): "
            f"graphed rows == eager: {same}; decode tokens/s graphed {tps['graphed']:.1f}, "
            f"eager {tps['eager']:.1f}")
        if not same:
            fail(f"{what} graphed generate_batch B={B} differs from eager")
        out[f"B{B}"] = {"bit_equal": True, "tokens_per_s_graphed": tps["graphed"],
                        "tokens_per_s_eager": tps["eager"]}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del graphed, eager, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the OpenAI-compatible server on the card
# ---------------------------------------------------------------------------

SERVE_TOKENS = 24  # greedy tokens of 8a's requests
WAVE_TOKENS = 32  # tokens of each of 8b's requests


def write_serving_tokenizer(path: Path, vocab_size: int) -> None:
    """A synthetic `.t` of ``vocab_size`` pieces: <unk>, <s>, </s>, the 256
    byte pieces, then every string of one, two and three ASCII letters (in
    order, scored by length) until the vocabulary is full. Every prefix of a
    letter piece is a piece, so a lone piece encodes back to itself: a
    one-token reply re-rendered into the next turn's prompt extends its
    conversation's cached history."""
    import string

    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer

    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    scores = [0.0] * len(vocab)
    for n in (1, 2, 3):
        for letters in itertools.product(string.ascii_letters, repeat=n):
            if len(vocab) == vocab_size:
                break
            vocab.append("".join(letters).encode())
            scores.append(float(n))
    write_tokenizer(str(path), TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2))


def http_chat(port: int, body: dict, timeout: float = 600) -> dict:
    """POST /v1/chat/completions: the status, the JSON (or, streamed, the
    SSE deltas) and the seconds to the first content and to the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = {"status": resp.status}
    if not body.get("stream") or resp.status != 200:
        out["json"] = json.loads(resp.read())
    else:
        deltas, times = [], []
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
                continue
            choice = json.loads(line[len(b"data: "):])["choices"][0]
            deltas.append(choice)
            if choice["delta"].get("content"):
                times.append(time.perf_counter() - t0)
        out.update(deltas=deltas, content_times=times,
                   text="".join(d["delta"].get("content", "") for d in deltas),
                   finish=deltas[-1]["finish_reason"])
    out["seconds"] = time.perf_counter() - t0
    conn.close()
    return out


def http_get(port: int, path: str) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def start_server(state):
    import threading

    from dllama_tpu_torch.serving.api_server import create_server

    srv = create_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True, name="phase8-http").start()
    return srv, srv.server_address[1]


def wave_prompts(n: int, seed: int) -> list:
    """``n`` user messages of random letters and spaces, whose rendered
    prompts run from about 30 to 85 tokens."""
    import random
    import string

    rng = random.Random(seed)
    return ["".join(rng.choice(string.ascii_letters + "  ")
                    for _ in range(rng.randint(10, 120))) for _ in range(n)]


def send_wave(port: int, bodies: list) -> tuple:
    """Every body at once, one thread each: (responses, wall seconds)."""
    import threading

    out = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def one(i):
        start.wait()
        out[i] = http_chat(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def gaps(times: list) -> list:
    return [b - a for a, b in zip(times, times[1:])]


def percentile(values: list, p: float) -> float:
    xs = sorted(values)
    return xs[min(len(xs) - 1, max(0, math.ceil(p / 100 * len(xs)) - 1))]


def phase8(torch, dev, engine, generate_ms: float) -> dict:
    """The OpenAI-compatible server (``serving.api_server``) in-process on
    phase 6's graphed Q40 engine (Llama-3-8B shape, seq_len 1024), over a
    synthetic 128,256-piece tokenizer. (a) ``--batch-window 0``: chat
    completions non-streamed and streamed (the same text), ``n = 2``, a stop
    sequence, ``max_tokens``, and a second turn that claims the first
    turn's prefix session; gates: each request's greedy ids equal
    ``engine.generate`` on the same rendered prompt ids bit for bit (the
    second turn: the same two turns run straight through the engine), the
    prefill and decode-step histograms count one observation per prefill
    and per decoded token, ``/health``, ``/ready`` and ``/metrics`` answer,
    and evicting a session returns at least one cache's bytes. (b)
    ``--batch-window 30 --batch-max 8 --kv-buckets 0`` (prefill chunk 64):
    eight greedy and sampled requests at once; each response's ids equal a
    direct ``BatchSession(max_batch=8, prefill_chunk=64)`` run of the same
    prompts and seeds bit for bit, and a second wave captures no graph.
    (c) the same wave under ``logits:nan:row=3``: exactly one request ends
    500 with the watchdog's error, the other seven return their ids of (b).
    K1, K4 and K5 must have launched on this path. Logged: solo time to
    first token and ms/token through HTTP against phase 6's ``generate``,
    the wave's tokens/s and p50/p99 request latency, prefill pieces per
    admission, each beside the card."""
    from dllama_tpu_torch import faults, kernels
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.serving.api_server import ServerState, drain_and_shutdown
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    cfg = engine.cfg
    card = gpu_line()
    out: dict = {"card": card}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        write_serving_tokenizer(Path(d) / "serve.t", cfg.vocab_size)
        tok = Tokenizer.from_file(str(Path(d) / "serve.t"))
    greedy = SamplerConfig(temperature=0.0, seed=0)
    cache_bytes = sum(t.numel() * t.element_size() for t in engine.new_cache().values())
    torch.cuda.empty_cache()
    m = (engine._m_prefill, engine._m_step, engine._m_chunk, engine._m_prefill_chunk)

    def counts():
        return [h.total_count() for h in m]

    def text_of(prompt, ids):
        """The reply text of ``ids``: up to the first stop token."""
        prev, b = prompt[-1], b""
        for t in ids:
            if t in state.stop_token_ids():
                break
            b += tok.decode_piece(prev, t)
            prev = t
        return b.decode("utf-8", "replace")

    # -- (a) solo ------------------------------------------------------------
    state = ServerState(engine, tok, cfg, model_name="llama3-8b-shape", template="llama3",
                        ts_interval=0.0)
    calls: list = []
    orig_open = state.open_stream

    def open_stream(prompt_tokens, feed_tokens, session, max_tokens, sampler):
        rec = {"prompt": list(prompt_tokens), "feed": len(feed_tokens),
               "claimed": session is not None, "ids": []}
        calls.append(rec)
        for t, st in orig_open(prompt_tokens, feed_tokens, session, max_tokens, sampler):
            rec["ids"].append(t)
            yield t, st

    state.open_stream = open_stream
    srv, port = start_server(state)
    kernels.reset_launches()
    c0, made0 = counts(), engine.graphs.made
    user_a = {"role": "user", "content": "Tell me about the ocean and its tides"}
    plain = {"messages": [user_a], "max_tokens": SERVE_TOKENS, "temperature": 0.0}
    r_plain = http_chat(port, plain)
    r_stream = http_chat(port, dict(plain, stream=True))
    r_stream2 = http_chat(port, dict(plain, stream=True))
    r_n = http_chat(port, dict(plain, n=2, max_tokens=16))
    text_a = r_plain["json"]["choices"][0]["message"]["content"]
    stop = text_a[3:5]
    r_stop = http_chat(port, dict(plain, stop=[stop]))
    r_max = http_chat(port, dict(plain, max_tokens=5))
    user_b = {"role": "user", "content": "Name a color"}
    r_b1 = http_chat(port, {"messages": [user_b], "max_tokens": 1, "temperature": 0.0})
    reply_b = r_b1["json"]["choices"][0]["message"]["content"]
    turn2 = [user_b, {"role": "assistant", "content": reply_b},
             {"role": "user", "content": "And another one please"}]
    r_b2 = http_chat(port, {"messages": turn2, "max_tokens": SERVE_TOKENS, "temperature": 0.0})
    c1, made1 = counts(), engine.graphs.made
    health = [http_get(port, p)[0] for p in ("/health", "/ready")]
    metrics_text = http_get(port, "/metrics")[1].decode()
    statuses = [r["status"] for r in (r_plain, r_stream, r_stream2, r_n, r_stop, r_max, r_b1,
                                      r_b2)]
    if statuses != [200] * 8 or health != [200, 200]:
        fail(f"phase 8a statuses {statuses}, /health and /ready {health}")
    (a_plain, a_stream, a_stream2, a_stop, a_max, a_b1, a_b2) = calls
    stops = state.stop_token_ids()

    def run(prompt, steps, session=None):
        return [t for t, _ in engine.generate(prompt, steps, session=session, stop_tokens=stops,
                                              sampler=greedy)]

    with state.lock:  # the same requests straight through the engine
        direct, direct_stop = run(a_plain["prompt"], SERVE_TOKENS), run(a_stop["prompt"],
                                                                         SERVE_TOKENS)
        first = run(a_b1["prompt"], 1)
        cont = run(a_b2["prompt"][len(a_b1["prompt"]) + 1:], SERVE_TOKENS,
                   session=engine.final_session)
        fresh2 = run(a_b2["prompt"], SERVE_TOKENS)
        n_rows = engine.generate_batch([a_plain["prompt"]] * 2, 16, stop_tokens=stops,
                                       row_steps=[16, 16], samplers=[greedy, greedy])
    n_texts = [c["message"]["content"] for c in r_n["json"]["choices"]]
    checks = {
        "plain ids = engine.generate": a_plain["ids"] == direct,
        "plain text = its ids' text": text_a == text_of(a_plain["prompt"], a_plain["ids"]),
        "streamed text = plain": r_stream["text"] == text_a == r_stream2["text"],
        "streamed ids = plain": a_stream["ids"] == a_stream2["ids"] == direct,
        "n=2 choices equal, = generate_batch": (n_texts[0] == n_texts[1]
                                                == text_of(a_plain["prompt"], n_rows[0])),
        "stop: finish stop, text cut": (r_stop["json"]["choices"][0]["finish_reason"] == "stop"
                                        and r_stop["json"]["choices"][0]["message"]["content"]
                                        == text_a[:text_a.find(stop)]
                                        and a_stop["ids"] == direct_stop[:len(a_stop["ids"])]),
        "max_tokens 5": (r_max["json"]["usage"]["completion_tokens"] == len(a_max["ids"]) <= 5
                         and a_max["ids"] == direct[:len(a_max["ids"])]),
        "turn 2 claims turn 1's session": a_b2["claimed"] and not a_b1["claimed"],
        "turn 2 = the two turns through the engine": (first == a_b1["ids"]
                                                       and cont == a_b2["ids"]),
    }
    solo_calls = len(calls)
    want_counts = [solo_calls + 1, sum(len(c["ids"]) - 1 for c in calls)]
    got_counts = [c1[0] - c0[0], c1[1] - c0[1]]
    checks["prefill / decode-step counts"] = got_counts == want_counts
    checks["/metrics lists the engine's"] = all(
        n in metrics_text for n in ("dllama_prefill_ms_count", "dllama_decode_step_ms_count",
                                    "dllama_decode_chunk_ms_count",
                                    "dllama_numeric_quarantines_total"))
    def stream_stats(r):
        """Time to the first token (the prefill's), the first decode token's
        gap (a new conversation's cache captures its decode graph there),
        and ms/token over the later gaps."""
        g = [d * 1e3 for d in gaps(r["content_times"])]
        return {"ttft_ms": r["content_times"][0] * 1e3, "first_gap_ms": g[0],
                "ms_per_token": sum(g[1:]) / len(g[1:]), "max_gap_ms": max(g[1:]),
                "tokens": len(r["content_times"])}

    streamed = stream_stats(r_stream2)
    # a diagnostic of the per-token cost of streaming: the same stream with
    # TCP_NODELAY on the accepted sockets (the server, as the JAX package's,
    # leaves Nagle's algorithm on)
    srv.RequestHandlerClass.disable_nagle_algorithm = True
    nodelay = stream_stats(http_chat(port, dict(plain, stream=True)))
    srv.RequestHandlerClass.disable_nagle_algorithm = False
    log(f"  {card}")
    log(f"  (a) solo, --batch-window 0: {solo_calls} solo requests + n=2; checks {checks}")
    log(f"    histogram counts over the HTTP requests: prefill {got_counts[0]} (want "
        f"{want_counts[0]}), decode step {got_counts[1]} (want {want_counts[1]}), decode "
        f"chunk {c1[2] - c0[2]}; graphs captured {made1 - made0}")
    log(f"    turn 2 fed {a_b2['feed']} new tokens after a {len(a_b1['prompt']) + 1}-token "
        f"cached history; a fresh single prefill of all {len(a_b2['prompt'])} tokens shares "
        f"{leading_equal(fresh2, a_b2['ids'])} of {len(fresh2)} leading greedy tokens with it")
    log(f"    streamed through HTTP ({streamed['tokens']} tokens): time to first token "
        f"{streamed['ttft_ms']:.1f} ms (first stream {r_stream['content_times'][0] * 1e3:.1f} "
        f"ms), the first decode token {streamed['first_gap_ms']:.1f} ms (its graph's capture), "
        f"then {streamed['ms_per_token']:.3f} ms/token (max gap {streamed['max_gap_ms']:.3f}) "
        f"against phase 6's graphed generate {generate_ms:.3f} ms/token; with TCP_NODELAY "
        f"{nodelay['ms_per_token']:.3f} ms/token (first token {nodelay['ttft_ms']:.1f} ms, "
        f"max gap {nodelay['max_gap_ms']:.3f}); non-streamed request "
        f"{r_plain['seconds'] * 1e3:.1f} ms")
    if not all(checks.values()):
        fail(f"phase 8a: {[k for k, v in checks.items() if not v]}")
    with state.lock:  # evict the oldest session: its cache and graphs go at once
        torch.cuda.synchronize()
        before, n_sess = torch.cuda.memory_allocated(dev), len(state._sessions)
        state._evict_oldest()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated(dev)
    log(f"    evicting the oldest of {n_sess} cached sessions returned {freed / 2 ** 20:.1f} MiB "
        f"(one cache is {cache_bytes / 2 ** 20:.1f} MiB)")
    if freed < cache_bytes:
        fail(f"phase 8a: evicting a session returned {freed} bytes, less than a cache "
             f"({cache_bytes})")
    drain_and_shutdown(state, srv, 10.0)
    srv.server_close()
    out["solo"] = {"checks": checks, "streamed": streamed, "ttft_first_stream_ms":
                   r_stream["content_times"][0] * 1e3, "generate_ms_per_token": generate_ms,
                   "token_gaps_ms": [d * 1e3 for d in gaps(r_stream2["content_times"])],
                   "streamed_nodelay": nodelay,
                   "request_ms": r_plain["seconds"] * 1e3, "evicted_bytes": freed,
                   "cache_bytes": cache_bytes, "captures": made1 - made0}

    # -- (b) batched, (c) the logits seam ---------------------------------------
    state = ServerState(engine, tok, cfg, model_name="llama3-8b-shape", template="llama3",
                        batch_window_ms=30.0, batch_max=8, kv_buckets=0, ts_interval=0.0)
    rows: dict = {}
    orig_submit = state.batcher.submit

    def submit(prompt_tokens, max_tokens, sampler, **kw):
        ids = orig_submit(prompt_tokens, max_tokens, sampler, **kw)
        rows[tuple(prompt_tokens)] = (sampler, max_tokens, list(ids))
        return ids

    state.batcher.submit = submit
    srv, port = start_server(state)
    bodies = [{"messages": [{"role": "user", "content": p}], "max_tokens": WAVE_TOKENS,
               "temperature": 0.8 if i % 2 else 0.0, "top_p": 0.9, "seed": 100 + i}
              for i, p in enumerate(wave_prompts(8, 3))]
    paths = state.batcher._m_path
    cont0, pf0 = paths.value(path="continuous"), engine._m_prefill_chunk.total_count()
    wave1, wall1 = send_wave(port, bodies)
    cont1, pf1 = paths.value(path="continuous"), engine._m_prefill_chunk.total_count()
    if [r["status"] for r in wave1] != [200] * 8 or cont1 - cont0 != 8:
        fail(f"phase 8b wave: statuses {[r['status'] for r in wave1]}, "
             f"{cont1 - cont0} of 8 on the continuous path")
    first_rows = dict(rows)
    rows.clear()
    made = engine.graphs.made
    wave2, wall2 = send_wave(port, bodies)
    made = engine.graphs.made - made
    with state.lock:  # the same prompts and seeds through a direct BatchSession
        sess = engine.batch_session(max_batch=8, chunk=8, prefill_chunk=64)
        handles = {sess.admit_begin(list(p), steps, sampler=s,
                                    stop_tokens=state.stop_token_ids()): p
                   for p, (s, steps, _) in first_rows.items()}
        got = {h: [] for h in handles}
        while any(not sess.is_done(h) for h in handles):
            sess.prefill_step()
            for h, burst in sess.step_chunk().items():
                got[h] += burst
        sess.close()
    direct_equal = all(got[h] == first_rows[p][2] for h, p in handles.items())
    lens = sorted(len(p) for p in first_rows)
    n_tok = sum(r["json"]["usage"]["completion_tokens"] for r in wave1)
    lat = [r["seconds"] * 1e3 for r in wave1]
    pieces = (pf1 - pf0) / 8
    b_checks = {"ids = direct BatchSession": direct_equal,
                "wave 2 = wave 1": rows == first_rows, "wave 2 captures": made == 0}
    log(f"  (b) --batch-window 30 --batch-max 8 --kv-buckets 0 (prefill chunk 64): 8 requests "
        f"(rendered prompts {lens[0]}-{lens[-1]} tokens, greedy and sampled 0.8/0.9), "
        f"{WAVE_TOKENS} tokens each; checks {b_checks}")
    log(f"    wave: {n_tok} tokens in {wall1 * 1e3:.1f} ms = {n_tok / wall1:.1f} tokens/s; "
        f"request latency p50 {percentile(lat, 50):.1f} ms, p99 {percentile(lat, 99):.1f} ms; "
        f"{pieces:.2f} prefill pieces per admission; second wave {wall2 * 1e3:.1f} ms")
    if not all(b_checks.values()):
        fail(f"phase 8b: {[k for k, v in b_checks.items() if not v]}")
    out["batched"] = {"checks": b_checks, "tokens": n_tok, "wall_ms": wall1 * 1e3,
                      "tokens_per_s": n_tok / wall1, "latency_ms": lat,
                      "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
                      "prefill_pieces_per_admission": pieces, "prompt_tokens": lens,
                      "second_wave_ms": wall2 * 1e3}

    q0 = engine._m_quarantine.total()
    rows.clear()
    faults.install("logits:nan:row=3")
    try:
        wave3, _ = send_wave(port, bodies)
    finally:
        faults.clear()
    bad = [r for r in wave3 if r["status"] != 200]
    good_equal = all(first_rows[p][2] == ids for p, (_, _, ids) in rows.items())
    c_checks = {"one 500": len(bad) == 1 and bad[0]["status"] == 500
                and "non-finite logits" in bad[0]["json"]["error"]["message"],
                "seven unchanged": len(rows) == 7 and good_equal,
                "one quarantine": engine._m_quarantine.total() - q0 == 1}
    log(f"  (c) the same wave under logits:nan:row=3 (graphs captured clean, replayed "
        f"poisoned): statuses {[r['status'] for r in wave3]}; checks {c_checks}")
    if not all(c_checks.values()):
        fail(f"phase 8c: {[k for k, v in c_checks.items() if not v]}: "
             f"{[r.get('json') for r in bad]}")
    out["poisoned"] = c_checks
    drain_and_shutdown(state, srv, 10.0)
    srv.server_close()
    launched = {k: v for k, v in kernels.launches.items() if v}
    log(f"  kernel launches over phase 8's requests: {launched}")
    need = ("q40_matmul", "flash_decode_batched", "rope_cache_update_batched")
    if any(not launched.get(k) for k in need):
        fail(f"phase 8: the server's path launched {launched}, want each of {need}")
    out["launches"] = launched
    return out


def phase8d() -> dict:
    """``cli verify`` (in this process) on phase 3's small Q40 model (exit
    0) and on a copy with one byte flipped (non-zero), and ``cli generate
    --profile DIR`` (a subprocess), whose trace must hold K1's decode GEMV
    among its kernel events."""
    from dllama_tpu_torch import cli

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        model, tok = write_small_model(Path(d), "q40")
        bad = Path(d) / "flipped.m"
        raw = bytearray(model.read_bytes())
        raw[len(raw) // 2] ^= 0x10
        bad.write_bytes(bytes(raw))
        rcs = []
        for p in (model, bad):
            try:
                cli.main(["verify", "--model", str(p)])
            except SystemExit as e:
                rcs.append(e.code)
        ids, _ = run_cli(model, tok, ["--profile", str(Path(d) / "prof")])
        events = json.loads((Path(d) / "prof" / "trace.json").read_text())["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    gemv = sum("q40_gemv_kernel" in n for n in kern)
    log(f"  (d) cli verify exit codes: {rcs} (the file, a copy with one byte flipped); cli "
        f"generate --profile: {len(ids)} tokens, {len(kern)} kernel events in the trace, "
        f"{gemv} of them q40_gemv_kernel")
    if rcs[0] != 0 or rcs[1] == 0 or not gemv:
        fail(f"phase 8d: verify exit codes {rcs}, trace kernels {sorted(set(kern))[:20]}")
    return {"verify_rcs": rcs, "kernel_events": len(kern), "q40_gemv_events": gemv}


def indexed_entry(kind: str, rows: list, launches: int) -> dict:
    """The summary entry of ``kind``'s expert-indexed GEMV: numbers for one
    Mixtral decode token's launches (32 x up|gate and down, T = 1, n_sel =
    2), ``launches`` from phase 7's main-path run."""
    mine = [r for r in rows if r["kind"] == kind]
    tok = [r for r in mine if r["T"] == 1 and r["n_sel"] == 2
           and r["matrix"].startswith("mixtral")]

    def per_tok(key):
        return 32 * sum(r[key] for r in tok)

    return {"name": f"{kind}_matmul_stacked", "route": "cuda",
            "source": f"dllama_tpu_torch/csrc/{kind}_matmul.cu",
            "replaces": ("dllama_tpu/ops/qmatmul.py:573 (q40_matmul_stacked, pallas_call :625) "
                         "-> :361 (_q40_kernel) + :412 (_q40_corr_kernel)" if kind == "q40" else
                         "dllama_tpu/ops/qmatmul.py:293 (q80_matmul_stacked, pallas_call :344) "
                         "-> :179 (_q80_kernel)"),
            "tpu_kernels": ["K1", "K2"] if kind == "q40" else ["K3"],
            "entry": f"dllama_{kind}_gemv_indexed ({kind}_gemv_kernel, indexed)",
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_tok("ms"), "plain_ms": per_tok("plain_ms"), "bound_ms": per_tok("bound_ms"),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in tok)
                         else "operations"),
            "library_ms": per_tok("library_ms"),
            "per_launch_ms": {f"{r['matrix']}@T{r['T']}x{r['n_sel']}": r["ms"] for r in mine},
            "per": ("one Mixtral decode token: 32 x (up|gate K 4096 -> O 28672, down K 14336 -> "
                    "O 4096), T=1, 2 experts a launch; launches: phase 7b's graphed run" if
                    kind == "q40" else
                    "one Mixtral decode token: 32 x (up|gate, down), T=1, 2 experts a launch; "
                    "launches: phase 7d's graphed run (8 layers)")}


def per_token(rows: list, key: str) -> float:
    """A per-launch number summed over one decode token's launches."""
    return sum(r[key] * r["launches_per_token"] for r in rows)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one NVIDIA GPU")
    if not (ROOT / "dllama_tpu_torch" / "__init__.py").exists():
        fail(f"{ROOT} is not a checkout of the repository (no dllama_tpu_torch/)")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def header(title: str) -> None:
        log(f"== {title} (at {time.perf_counter() - t_start:.0f} s)")

    log("== phase 0: card, versions, kernel build")
    card = gpu_line()
    log(f"  {card}")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}"
        f"  device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from dllama_tpu_torch import kernels

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    build_s = time.perf_counter() - t0
    log(f"  kernels built and loaded in {build_s:.1f} s: {so.relative_to(ROOT)}")
    ptxas = ptxas_report(kernels.build_log().read_text()) if kernels.build_log().exists() else []
    for r in ptxas:
        if (any(n in r["kernel"] for n in ("gemv_kernel", "rope_cache_kernel", "int8_kernel"))
                or r.get("spill_stores") or r.get("spill_loads")):
            log(f"  ptxas: {r['registers']:3d} registers, {r['static_smem']} B static shared "
                f"memory, {r.get('stack')} B stack, {r.get('spill_stores')} B spill stores, "
                f"{r.get('spill_loads')} B spill loads  {r['kernel'].split('(')[0]}")

    header("phase 1: kernels vs plain versions (Llama-3-8B shapes)")
    gen = torch.Generator(device=dev).manual_seed(0)
    q40 = phase1_matmul(torch, dev, gen, "q40")
    q80 = phase1_matmul(torch, dev, gen, "q80")
    variants = phase1_variants(torch, dev, gen)
    flash = phase1_flash(torch, dev, gen)
    rope = phase1_rope(torch, dev, gen)
    flash_b = phase1_flash_batched(torch, dev, gen)
    rope_b = phase1_rope_batched(torch, dev, gen)
    rope_v = phase1_rope_verify(torch, dev, gen)

    header("phase 2: Engine.generate, Llama-3-8B shape, random Q40, 100 + 32 tokens")
    e2e = phase2(torch, dev, "q40")
    header("phase 2: Engine.generate, Llama-3-8B shape, random Q80, 100 + 32 tokens")
    e2e80 = phase2(torch, dev, "q80")

    header("phase 2c: python -m dllama_tpu_torch.qkernel_experiments all (K 4096, O 11008)")
    exp = phase_experiments(torch)

    header("phase 3: python -m dllama_tpu_torch.cli generate on small Q40 and Q80 models")
    cli = phase3()

    spec = {}

    def run_phase5(engine, prompts, batch_out):
        header("phase 5: generate_spec and generate_batch_spec, phase 4's Q40 model, draft 8")
        spec.update(phase5(torch, dev, engine, prompts, e2e, batch_out))

    header("phase 4: Engine.generate_batch, Llama-3-8B shape, random Q40, B = 1, 4, 8")
    batch = phase4(torch, dev, "q40", (1, 4, 8), e2e["decode_ms_median"], then=run_phase5)
    header("phase 4: Engine.generate_batch, Llama-3-8B shape, random Q80, B = 8")
    batch80 = phase4(torch, dev, "q80", (8,), e2e80["decode_ms_median"])

    # phase 8 serves from phase 6's graphed Q40 engine, kept for it, and
    # runs after every profiled phase: once its server threads have run,
    # each later torch.profiler window of this process loses its first
    # kernel records (seen on the H100: the first replay's first ~17)
    kept = []
    header("phase 6: CUDA-graphed decode, Llama-3-8B shape, random Q40, solo and B = 1, 4, 8")
    k4_fixed = k4_bound_cost(torch, dev, gen)
    graphs = phase6(torch, dev, "q40", (1, 4, 8), sampled=True, mixed=True,
                    then=lambda engine, out: kept.append(engine))
    header("phase 6: CUDA-graphed decode, Llama-3-8B shape, random Q80, solo and B = 8")
    graphs80 = phase6(torch, dev, "q80", (8,), sampled=True, mixed=False)

    header("phase 7a: K1's and K3's expert-indexed GEMVs at the Mixtral and Grok-1 expert "
           "widths")
    log(f"  card memory allocated before phase 7: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    moe_k = phase7a(torch, dev, gen)
    header("phase 7b: Mixtral-8x7B shape, random Q40, 100 + 32 tokens, graphed and eager, "
           "B = 2 and 8")
    mix = phase7_model(torch, dev, "Mixtral-8x7B", MIXTRAL_8X7B, "q40", (2, 8))
    header("phase 7c: Grok-1 at full width, 4 of its 64 layers, random Q40, 100 + 32 tokens")
    grok = phase7_model(torch, dev, "Grok-1 (4 layers)", GROK1_CUT, "q40", ())
    header("phase 7d: Mixtral-8x7B shape at 8 of its 32 layers, random Q80, 100 + 8 tokens")
    mix80 = phase7_model(torch, dev, "Mixtral-8x7B Q80 (8 layers)",
                         {**MIXTRAL_8X7B, "n_layers": 8}, "q80", (), steps=8)

    header("phase 8: the OpenAI-compatible server on phase 6's graphed Q40 engine")
    serving = phase8(torch, dev, kept.pop(), graphs["generate_ms_per_token_graphed"])
    torch.cuda.empty_cache()
    header("phase 8d: cli verify and cli generate --profile on phase 3's small Q40 model")
    serving["cli"] = phase8d()

    # one entry per kernel; a dequant-matmul's numbers are for one decode
    # token's launches (32 x wqkv, wo, w13, w2 + wcls at T=1)
    def at_t(rows, T):
        return {r["matrix"]: {k: r.get(k) for k in ("ms", "fused_ms", "library_ms", "bound_ms",
                                                   "bound_by", "ksplit")}
                for r in rows if r["T"] == T and "ms" in r}

    def matmul_entry(name, rows, source, replaces, tpu, launches, decode_entry, tile_entry):
        dec = [r for r in rows if r["T"] == 1 and "ms" in r]
        fused = [r for r in dec if r["matrix"] in FUSED]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "tpu_kernels": tpu, "launches": launches,
                "max_abs_err": max(max(r["max_abs_err"], r["fused_max_abs_err"]) for r in rows),
                "ms": per_token(dec, "ms"), "plain_ms": per_token(dec, "plain_ms"),
                "bound_ms": per_token(dec, "bound_ms"),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                             else "operations"),
                "library_ms": per_token(dec, "library_ms"),
                "fused_norm": {"ms": per_token(fused, "fused_ms"),
                               "unfused_ms": per_token(fused, "ms"),
                               "plain_ms": per_token(fused, "fused_plain_ms"),
                               "per": "one decode token's wqkv + w13 launches (64)"},
                "per_width_ms": {r["matrix"]: r["ms"] for r in dec},
                "decode_entry": decode_entry, "tile_entry": tile_entry,
                "tile_source": "dllama_tpu_torch/csrc/dq_tile.cuh",
                "decode_T4": at_t(rows, 4), "decode_T8": at_t(rows, 8),
                "prefill_T128": at_t(rows, 128), "tile_T512": at_t(rows, 512),
                **{f"verify_T{T}": at_t(rows, T) for T in VERIFY_T},
                "worst_err_over_tol": {r["matrix"]: max(v["err_over_tol"] for v in rows
                                                        if v["matrix"] == r["matrix"])
                                       for r in dec},
                "per": "one decode token: 32 x (wqkv, wo, w13, w2) + wcls, T=1"}

    def variant_entry(name, source, replaces, tpu, entry):
        r = next(v for v in variants if v["name"] == name and v["matrix"] == "exp")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "entry": entry, "tpu_kernels": tpu, "launches": exp["launches"][name],
                "max_abs_err": max(v["max_abs_err"] for v in variants if v["name"] == name),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "per": "one launch: K=4096, O=11008, T=1"}

    fl_row = next(r for r in flash if "timed" in r)
    fl = next(t for t in fl_row["timed"] if t["pos"] == 1000)
    rp = next(r for r in rope if "ms" in r)
    flb = next(r for r in flash_b if "ms" in r)
    rpb = next(r for r in rope_b if "ms" in r)
    rpv = next(r for r in rope_v if "ms" in r)
    launches, launches80 = e2e["launches"], e2e80["launches"]
    launches_b = batch["B8"]["launches"]
    summary = {"kernels": [
        matmul_entry("q40_matmul", q40, "dllama_tpu_torch/csrc/q40_matmul.cu",
                     "dllama_tpu/ops/qmatmul.py:361 (_q40_kernel) + :412 (_q40_corr_kernel)",
                     ["K1", "K2"], launches["q40_matmul"],
                     "dllama_q40_gemv (q40_gemv_kernel)", "dllama_q40_tile"),
        matmul_entry("q80_matmul", q80, "dllama_tpu_torch/csrc/q80_matmul.cu",
                     "dllama_tpu/ops/qmatmul.py:179 (_q80_kernel)", ["K3"],
                     launches80["q80_matmul"], "dllama_q80_gemv (q80_gemv_kernel)",
                     "dllama_q80_tile"),
        {"name": "flash_decode", "route": "cuda", "source": "dllama_tpu_torch/csrc/flash_decode.cu",
         "replaces": "dllama_tpu/ops/flash_decode.py:102 (_kernel)", "tpu_kernels": ["K4"],
         "launches": launches["flash_decode"],
         "launches_q80_decode": launches80["flash_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in flash),
         "ms": fl["ms"], "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"], "grid": fl["grid"],
         "at_pos_116": {k: v for k, v in next(t for t in fl_row["timed"] if t["pos"] == 116)
                        .items() if k not in ("before_ms", "change")},
         "per": "one launch: S=1024 bf16 cache, kv=8, group 4, hd=128, pos 1000, T=1"},
        {"name": "rope_cache_update", "route": "cuda",
         "source": "dllama_tpu_torch/csrc/rope_cache.cu",
         "replaces": "dllama_tpu/ops/fused_rope_cache.py:86 (_kernel)", "tpu_kernels": ["K5"],
         "entry": "dllama_rope_cache_update (rope_cache_kernel: q's rope, K's rope, K/V write)",
         "launches": launches["rope_cache_update"],
         "launches_q80_decode": launches80["rope_cache_update"],
         "max_abs_err": max(r["max_abs_err"] for r in rope),
         "ms": rp["ms"], "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
         "bound_by": rp["bound_by"], "library_ms": None,
         "per": "one launch: T=1, 32 q heads, 8 kv heads, hd=128, bf16 activations and cache"},
        {"name": "flash_decode_batched", "route": "cuda",
         "source": "dllama_tpu_torch/csrc/flash_decode.cu",
         "replaces": "dllama_tpu/ops/flash_decode.py:263 (flash_decode_attention_batched) via "
                     "_launch :172", "tpu_kernels": ["K4"],
         "launches": launches_b["flash_decode_batched"],
         "launches_q80_decode": batch80["B8"]["launches"]["flash_decode_batched"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_b),
         "ms": flb["ms"], "plain_ms": flb["plain_ms"], "bound_ms": flb["bound_ms"],
         "bound_by": flb["bound_by"], "library_ms": flb["library_ms"], "grid": flb["grid_tight"],
         "per": f"one launch: B=8 rows at pos {flb['pos']}, S=1024 bf16 cache, kv=8, group 4, "
                "hd=128; launches: phase 4's B=8 generate_batch (32 steps)"},
        {"name": "rope_cache_update_batched", "route": "cuda",
         "source": "dllama_tpu_torch/csrc/rope_cache.cu",
         "replaces": "dllama_tpu/ops/fused_rope_cache.py:235 (rope_cache_update_batched) via "
                     "_launch :132", "tpu_kernels": ["K5"],
         "entry": "dllama_rope_cache_update (rope_cache_kernel)",
         "launches": launches_b["rope_cache_update_batched"],
         "launches_q80_decode": batch80["B8"]["launches"]["rope_cache_update_batched"],
         "max_abs_err": max(r["max_abs_err"] for r in rope_b),
         "ms": rpb["ms"], "plain_ms": rpb["plain_ms"], "bound_ms": rpb["bound_ms"],
         "bound_by": rpb["bound_by"], "library_ms": None,
         "per": "one launch: B=8 rows, 32 q heads, 8 kv heads, hd=128, bf16 activations and "
                "cache; launches: phase 4's B=8 generate_batch (32 steps)"},
        {"name": "rope_cache_update_verify", "route": "cuda",
         "source": "dllama_tpu_torch/csrc/rope_cache.cu",
         "replaces": "dllama_tpu/ops/fused_rope_cache.py:209 (rope_cache_update_verify) -> "
                     "_launch :132", "tpu_kernels": ["K5"],
         "entry": "dllama_rope_cache_update (rope_cache_kernel)",
         "launches": spec["batched"]["launches"]["rope_cache_update_verify"],
         "max_abs_err": max(r["max_abs_err"] for r in rope_v),
         "ms": rpv["ms"], "plain_ms": rpv["plain_ms"], "bound_ms": rpv["bound_ms"],
         "bound_by": rpv["bound_by"], "library_ms": None,
         "per": "one launch: B=8 sequences of T=9 rows, 32 q heads, 8 kv heads, hd=128, bf16 "
                "activations and cache; launches: phase 5's B=8 generate_batch_spec (32 tokens "
                "a row)"},
        variant_entry("q40_nosub_matmul", "dllama_tpu_torch/csrc/q40_matmul.cu",
                      "scripts/qkernel_experiments.py:60 (_q40_nosub_kernel)", ["K6"],
                      "dllama_q40_gemv mode 2 (q40_gemv_kernel)"),
        variant_entry("q40_int8_matmul", "dllama_tpu_torch/csrc/q40_int8_matmul.cu",
                      "scripts/qkernel_experiments.py:138 (_q40_int8_kernel)", ["K7"],
                      "dllama_q40_int8_matmul (q40_int8_kernel)"),
        indexed_entry("q40", moe_k, mix["launches"]["q40_matmul_stacked"]),
        indexed_entry("q80", moe_k, mix80["launches"]["q80_matmul_stacked"]),
    ]}
    # phase 6's graphed solo run (prefill, the graph's warm-up step, 32
    # replays): the kernels a replay launches
    for entry in summary["kernels"]:
        run = graphs80 if entry["name"] == "q80_matmul" else graphs
        if entry["name"] in ("q40_matmul", "q80_matmul", "flash_decode_batched",
                             "rope_cache_update_batched"):
            entry["launches_graphed_decode"] = run["launches_graphed"][entry["name"]]
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "ptxas": ptxas, "q40": q40, "q80": q80, "variants": variants,
               "flash_decode": flash, "rope_cache": rope, "flash_decode_batched": flash_b,
               "rope_cache_batched": rope_b, "rope_cache_verify": rope_v, "e2e": e2e,
               "e2e_q80": e2e80, "batch_q40": batch, "batch_q80": batch80, "spec": spec,
               "graphs_q40": graphs, "graphs_q80": graphs80, "k4_bound_S": k4_fixed,
               "experiments": exp, "cli": cli, "moe_indexed": moe_k, "mixtral_q40": mix,
               "grok1_q40": grok, "mixtral_q80": mix80, "serving": serving, "summary": summary,
               "seconds": time.perf_counter() - t_start}
    (ROOT / "build" / "chip_smoke.json").write_text(json.dumps(details, indent=1, default=str))
    log(f"== done in {details['seconds']:.1f} s; details in build/chip_smoke.json")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
