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
   least one cache's bytes. (b) batched (``--batch-window 250 --batch-max 8
   --kv-buckets 0``, prefill chunk 64): eight greedy and sampled requests
   at once = a direct ``BatchSession`` of the same prompts and seeds bit
   for bit, and a second wave captures no graph. (c) that wave under
   ``logits:nan:row=3``: one request 500s, seven return (b)'s ids. K1, K4
   and K5 must have launched. (d) ``cli verify`` on phase 3's small model
   and on a copy with one byte flipped; ``cli generate --profile`` writes a
   trace holding ``q40_gemv_kernel``. Logged beside the card: solo time to
   first token and ms/token through HTTP against phase 6's ``generate``,
   the wave's tokens/s and p50/p99 latency, prefill pieces per admission.

   (e) ``--batch-window 250 --batch-max 8`` with the default ``--kv-buckets
   1``: (b)'s wave; every session the server opened, replayed call by call
   on a direct bucketed ``BatchSession`` with the same seeds, returns the
   same tokens bit for bit, and a second wave captures no graph; tokens/s
   and p50/p99 beside (b)'s. (f) ``--kv-pages 16``: two waves sharing a
   system prompt (the prefix hit rate on ``/ready``, time to first token
   per wave); then a 1-row paged pool where an interactive prompt that
   does not fit preempts a batch-class row, which resumes with the ids of
   an unpreempted run. (g) a ``--role prefill`` and a ``--role decode``
   server (the second engine shares the first's weight tensors): one
   streamed request through ``/v1/prefill`` then ``/v1/kv/import`` gives
   the colocated server's ids and text, and a checkpoint frame of the
   colocated stream resumed through ``/v1/kv/resume`` on the decode server
   splices to it byte for byte.

9. Bucketed KV slot pools and paged KV (run after phase 7 and before
   phase 8) on phase 6's graphed Q40 engine, full width and depth, seq_len
   1024. (a) ``batch_session(max_batch=8, chunk=8, bucket_kv=True,
   prefill_chunk=64)``: eight 60-token prompts admitted before the first
   chunk, 200 greedy tokens each (every row migrates twice, all in one
   tick, so every pool decodes at capacity 8): every token, every chunk's
   last-step logits and each row's KV equal the uniform pool of 8's bit
   for bit, and every migrated slab prefix equals its source; then 16
   requests (phase 4's eight prompts and eight of 8-40 tokens, 8-200
   tokens each) admitted as the budget allows: greedy tokens equal solo
   ``generate_fused`` (a row may part from it only at a near-tie, where
   the solo logits of the two picks are within the decode-step tolerance,
   logged), each row's first full chunk's logits within 5e-2 of max of a
   solo prefill of the same tokens, and more rows resident than the
   uniform pool's 8, tokens/s beside the uniform pool's. (b) paged
   (``kv_pages=16``): (a)'s exact gate with regroups; the B = 8 step
   beside the uniform pool's and the profiler's gather and scatter time
   beside their bytes over 3.35 TB/s; ``page_stats()`` holds no page after
   ``close()``; two waves of 4 requests sharing a 64-token prefix: the
   second wave aliases at least 48 prefix tokens an admission, its greedy
   tokens equal cold admissions' (a bucketed pool of the same capacity;
   near-ties logged) with logits within tolerance, and its admissions'
   prefill time beside the cold one's. (c) a live paged row exported after
   two chunks, greedy and sampled, through ``kv_transfer``'s f32 wire into
   a second paged session: the continued stream and its logits equal the
   row kept in the first session bit for bit; over the q80 wire the import
   completes with logits within tolerance. Wire bytes, export and import
   ms logged. Graphs made per shape with their capture ms and pool bytes.

10. Tensor parallelism (``dllama_tpu_torch.parallel``, after phase 8d). K1's and
   K3's decode GEMVs at the shard widths a tp 2 and a tp 4 rank of the
   Llama-3-8B shape launches (wqkv O 3072 / 1536, wo and w2 2048 / 1024,
   w13 14336 / 7168, wcls 64128 / 32128), and at the same widths K1's and
   K3's launches of a verify step, T = 5 (the GEMV) and 9, 16 and 72 (the
   tile), each against its plain version within 1e-5 * max|ref|,
   timed beside its byte bound, the plain version and bf16 ``torch.matmul``,
   with its grid's blocks against the card's block slots. Then a random Q40
   `.m` file of the Llama-3-8B widths (32 layers) written once, and the
   eager solo engine on it. (a) A one-rank NCCL world on this card runs the
   whole TP path (shard load, gathers through NCCL): its first decode
   step's logits and 32 greedy tokens bit-equal to the solo engine's. (b)
   Ranks over gloo, every rank on this card (NCCL refuses two ranks on one
   device; gloo takes CUDA tensors), at tp 2 and 4, each loading its shard
   of the file: every rank's 32 greedy tokens (tp 4: 8) equal and equal to
   the solo engine's, the first decode step within 5e-2 * max|logit|, no token from
   the padded vocab, the kB sent a token the analytic count; at tp 2
   ``generate_batch`` at B = 4 equal to the solo batch. (c) The Q80 wire at
   tp 2: one teacher-forced step within 0.05 * max|logit| of plain gathers
   (correlation > 0.999), its bytes the analytic count. (d) Mixtral widths
   at 4 layers, tp 2 (``random_quant_params(tp=)``): the first step within
   5e-2 of the solo engine, the expert-indexed GEMVs launched. Each run's
   launches are counted from 0 and K1, K4, K5 (and their batched forms, and
   the indexed GEMV in d) must have launched. Logged beside the card: ms
   per token a rank (gloo over one card: not tensor-parallel speed), kB sent
   a token, load seconds and peak memory a rank. (e) ``chat`` and
   ``serve`` under TP (:func:`phase10e`). (f) Speculative decoding and row
   moves under TP (:func:`phase10f`), rank 0 driving a ``TPEngine``: at one
   NCCL rank, ``generate_spec`` and ``generate_batch_spec`` (draft 8, B = 4),
   a paged row's snapshot and its continuations bit-equal to one device's;
   at gloo tp 2, every rank in step, the streams equal one device's or
   parting at a near tie, a row exported at tp 2 continuing exactly when
   imported at tp 2 (and equal or at a near tie on one device); K5's verify
   form at a tp 2 and a tp 4 rank's heads bit-equal to its plain version.
   (g) ``--tp-reduce`` and ``--tp-overlap`` (:func:`phase10g`, run after
   (b), before (e)): K1/K3 on the wo/w2 row shards at tp 2 and 4 against
   their plain versions, K4/K5 launched on half a batch bit-equal to the
   whole launch, ``cli generate --tp-reduce q80 --tp-overlap`` at one NCCL
   rank, and at gloo tp 2 the four modes (row plain, row q80, overlap, row
   plain with overlap) through solo, batched, batched-spec and paged runs:
   ranks in step, streams equal to one device's or parting at a near tie,
   the counters and seams fired, the kB a decode token the port's count.
   The `.m` file stays for phase 11c, and the solo engine answers 11c's
   greedy request.

11. The fleet's front door (``serving.router``, ``serving.fleet``, the CLI
   modes ``fleet``, ``top``, ``snapshot`` and ``explain``), run last. (a)
   The router in process (``create_router_server``) in front of two
   in-process replicas: phase 6's graphed Q40 engine, kept for it, and a
   twin sharing its weights, each ``--kv-pages 16 --batch-window 5
   --batch-max 8 --ckpt-interval 8``; the two engines' sessions take turns
   on the card under one lock, as two processes' contexts would. Each
   replica first serves a checkpointing stream of its own, so the chat
   template's first page is in its radix cache and no admission depends
   on the order it comes in. A wave of 8 streamed requests (4 greedy, 4
   sampled with seeds), 16 tokens each, through the router: every text
   equals the same request sent straight to a fresh, warmed replica of
   the engine that served it, together with the rest of that replica's
   share, both replicas serve, K1, K4 and K5 launch; a conversation's next
   turn goes to the replica holding the first turn's pages (an affinity
   pick, and that replica's ``/ready`` prefix hit rate rises). Logged: time
   to first token and ms/token straight to a replica, through a router
   that only relays, and through one that checkpoints. (b) Failover:
   a greedy and a sampled 64-token stream through a router on the f32 and
   on the q80 checkpoint wire; once the router has stored a checkpoint the
   serving replica's server is stopped (its connections cut, its listener
   closed) and the router resumes the stream on the sibling: on the f32
   wire the client's bytes equal an uninterrupted run's (the per-request
   ``id`` and ``created`` fields aside), on both wires the streams end
   cleanly and ``dllama_stream_resume_total{outcome="ok"}`` counts 2.
   Logged: the checkpoint bytes the router stored. (c) ``python -m
   dllama_tpu_torch.cli fleet --replicas 2`` on phase 10's file with
   ``--replica-arg "--kv-pages 16 --batch-window 5 --batch-max 4
   --ckpt-interval 8 --chat-template llama3"`` and ``DLLAMA_TRACE`` set:
   both replica pids are on the card (nvidia-smi), a greedy request through
   the fleet answers what phase 10's solo engine answers, ``cli top``,
   ``cli snapshot`` and ``cli explain`` exit 0 on the live fleet, and
   SIGTERM drains it to exit 0 within 90 s. Logged: each replica's startup
   seconds and memory, the supervisor's (the router's) RSS, time to first
   token and ms/token straight to a replica and through the router, and
   the spans of a routed stream (``cli explain``).

12. Training (``models.llama.forward_train``, ``runtime.train``,
   ``runtime.checkpoint``, ``parallel.{grad_collectives,pipeline}``,
   ``ops.ring_attention``; ``dllama_tpu_torch.train_tiny_e2e``). (d) runs
   inside phase 10, on its worlds, after 10h: one SGD step at tp 1 on the
   one NCCL rank bit-equal to the one-device step; on the 4 gloo ranks (all
   on this card) tp 2 and dp 2 x tp 2 SGD steps (loss within 1e-5, leaves
   1e-4 of one device), dp 2 x sp 2 loss and gradients through ring
   attention (1e-4), the pipeline at pp 2 with 2 and 4 microbatches
   (logits 2e-5, gradients 2e-4), an ep 2 x tp 2 Mixtral step; a checkpoint
   saved at dp 2 x tp 2 after two Adam steps, restored at dp 2 x tp 2, tp 2
   and one rank (the saved leaves and Adam's moments and counts bit for
   bit; the next two losses, the second one reading the restored Adam
   state, bit-equal to the uninterrupted run's at dp 2 x tp 2 and within
   1e-6 elsewhere; the one rank's next loss bit-equal to one device's loss
   of the saved leaves). The
   rest runs after phase 11: (a) one SGD step of a tiny f32 Llama and
   Mixtral (dim 128, 2 layers) on the card against the port on the CPU
   (loss 1e-5, each gradient leaf 1e-4·max|g|, the updated leaves 1e-4);
   (b) the Llama-3-8B widths at 2 of 32 layers and (c) the Mixtral-8x7B
   widths at 1 layer, f32 params from ``device_random_params``,
   ``torch.optim.Adam(lr=1e-4)``, B = 2, T = 512, 8 (c: 4) steps on one
   fixed batch: the loss finite and falling, no host sync inside a step
   (``set_sync_debug_mode("error")``) but the loss read; logged ms a step
   (CUDA events, median of steps 2 on), tokens/s, peak memory and the
   step's FLOPs beside ``F32_FLOPS``; (e) ``python -m
   dllama_tpu_torch.train_tiny_e2e`` as a subprocess: trains the byte-level
   model (at most ``P12_TINY_STEPS`` steps and ``P12_TINY_S`` seconds),
   writes it as Q40 and serves it in process and through ``cli generate``,
   exit 0 (both 95 % gates); K1 and K4/K5 must have launched serving it.

13. Native export (``dllama_tpu_torch.export_native``, ``native_launch``,
   the C++ runner under ``dllama_tpu_torch/native``), run last: triton's
   version (or its absence) logged; one layer at the Llama-3-8B widths,
   dense f32 random params made on the card, an f32 cache: the step, loop
   and prefill programs traced and compiled by AOTInductor for the card
   while the runner's g++ build runs beside them; ``python -m
   dllama_tpu_torch.native_launch generate --temperature 0`` on a prompt of
   one prefill dispatch for 40 tokens (a 32-step loop chunk and a tail).
   Gates: the runner's ids equal ``Engine.generate_fused``'s on the same
   params or part only at a near tie (logged); the prefill program's logits
   within 1e-3 * max|logit| of the engine's prefill; the export and the
   traced programs launch no hand-written kernel; the loop sampler's hash
   bits on the card equal the CPU's. Logged: export and compile seconds
   per program, the runner's build seconds, its ms a token (the loop chunk,
   the tail steps) beside the engine's graphed ``generate_fused`` and the
   weights-bytes bound.
   Each phase's seconds are logged at the end.

The last lines are the card's name and power limit, one JSON object with
each kernel's numbers, and ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
from concurrent.futures import ThreadPoolExecutor
import math
import os
import shutil
import signal
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
                    per_sm = (0 if T > qmatmul.GEMV_MAX_T  # the tile's plan takes none
                              else qmatmul.q40_gemv_blocks_per_sm(T) if kind == "q40"
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


def rope_launches(torch, dev, gen, form: str, cases: list, timed_case: int,
                  heads: tuple = ROPE_HEADS) -> list:
    """One K5 launch form against its plain version at Llama-3-8B widths
    (``heads``: (q heads, kv heads, head size), a tensor-parallel rank's
    share of them where given): q,
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
    H, kv, hd = heads
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
                log(f"  {name} {style:11s} heads {H}/{kv} rows {lead} pos={pos_l} "
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
                    was = K5_MS_BEFORE[name] if heads == ROPE_HEADS else None
                    if was is not None:
                        row["k_only_ms_from_perf_md"] = was
                    log(f"    rows {lead}: time {row['ms']:.4f} ms per launch"
                        + (f" (the K-only kernel before, from PERF.md, not this run: {was} ms)"
                           if was is not None else "")
                        + f"  bound {b_ms:.6f} ms ({by}, {nbytes} bytes with q's)  plain "
                        f"{row['plain_ms']:.4f} ms  (no single PyTorch call)")
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
        def rows(ref):  # a batched form's plain version on rows [row0, row0 + B)
            return (lambda q, k, v, cos, sin, kc, vc, pos, layer, style, row0=0:
                    ref(q, k, v, cos, sin, kc[:, row0:row0 + q.shape[0]],
                        vc[:, row0:row0 + q.shape[0]], pos, layer, style))

        llama.rope_cache_update = fused_rope_cache.rope_cache_update_ref
        llama.rope_cache_update_batched = rows(fused_rope_cache.rope_cache_update_batched_ref)
        llama.rope_cache_update_verify = rows(fused_rope_cache.rope_cache_update_verify_ref)
        flash_decode.flash_decode_attention = flash_decode.flash_decode_attention_ref
        flash_decode.flash_decode_attention_batched = (
            lambda q, kc, vc, pos, layer, bound=None, row0=0:
            flash_decode.flash_decode_attention_batched_ref(
                q, kc[:, row0:row0 + q.shape[0]], vc[:, row0:row0 + q.shape[0]], pos, layer))
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


#: device records that are not kernels: the profiler's step annotations
NOT_WORK = ("ProfilerStep",)
#: the profiler's resolution on the card's clock, ms (CUPTI stamps in ns; the
#: profiler keeps µs with three decimals)
PROFILER_RES_MS = 1e-6


def launch_records(prof) -> tuple:
    """(the host's kernel-launch calls, the device's kernel records) of an
    eager profiler window: fewer records than calls means records were
    lost, not launches (every launch call starts one kernel)."""
    calls = records = 0
    for ev in prof.key_averages():
        if ev.key in LAUNCH_CALLS and ev.key != "cudaGraphLaunch":
            calls += ev.count
        elif (str(ev.device_type).endswith("CUDA")
              and (getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0))
              and not ev.key.startswith(("Memcpy", "Memset", *NOT_WORK))
              and not getattr(ev, "is_user_annotation", False)):
            records += ev.count
    return calls, records


def check_window(busy: float, wall: float, what: str) -> None:
    """Fail the run when a profiler window's device busy time exceeds its
    wall by more than the profiler's resolution: one stream cannot be busier
    than the clock that ran around it."""
    if busy > wall + PROFILER_RES_MS:
        fail(f"{what}: device busy {busy:.6f} ms exceeds the window's wall {wall:.6f} ms")


def device_time(prof, n: int) -> tuple:
    """(ms per kernel name, ms and launches per kernel family) of a profiler
    run, divided by ``n`` (the tokens or calls it covered). User annotations
    and records named in :data:`NOT_WORK` are left out."""
    by_name, calls = {}, {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0)
        if ev.key.startswith(NOT_WORK) or getattr(ev, "is_user_annotation", False):
            continue
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

    # where a decode token's device time goes: one warm-up token under the
    # profiler's schedule, whose records are dropped, then the 3 measured.
    # The first records a window profiles can be lost on the H100 (windows
    # without the warm-up counted 31.67 flash decode launches a Q40 token
    # and 128.67 GEMV launches a Q80 one), which the exact gate below
    # cannot take; graph_window does the same. A window can still come back
    # with fewer kernel records than the host's launch calls (seen on the
    # H100: 31.67 flash decode launches a Q80 token): such a window lost
    # records, and is measured again, at most three times in all
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(3):
        with side_stopped(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                                     acc_events=True) as prof:
            for _ in engine.generate([], 1, session=engine.final_session):
                pass
            torch.cuda.synchronize()
            prof.step()
            t1 = time.perf_counter()
            for _ in engine.generate([], 3, session=engine.final_session):
                pass
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / 3
            prof.step()
        host_calls, records = launch_records(prof)
        if records >= host_calls:
            break
        log(f"  profiler window {attempt + 1}: {records} kernel records for {host_calls} "
            f"launch calls (records lost); measured again")
    out["profile_attempts"] = attempt + 1
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


def run_clis(runs: list) -> list:
    """(token ids, stdout) of ``cli generate`` for each (model, tokenizer,
    extra flags) of ``runs``: all started at once (each is a process of its
    own; the card takes them side by side), then read in order."""
    cmds = [[sys.executable, "-m", "dllama_tpu_torch.cli", "generate", "--model", str(model),
             "--tokenizer", str(tok), "--steps", "8", "--temperature", "0", "--seed", "0",
             "--prompt", "Hello world", *extra] for model, tok, extra in runs]
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    out = []
    for cmd, proc in zip(cmds, procs):
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            fail(f"{' '.join(cmd[2:])} exited {proc.returncode}:\n{stdout[-2000:]}"
                 f"\n{stderr[-3000:]}")
        ids = [ln for ln in stdout.splitlines() if ln.startswith("Token ids:")]
        if not ids or not ids[0].split(":", 1)[1].split():
            fail(f"{' '.join(cmd[2:])} printed no tokens:\n{stdout[-2000:]}")
        out.append(([int(t) for t in ids[0].split(":", 1)[1].split()], stdout))
    return out


def phase3() -> dict:
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        files = {kind: write_small_model(Path(d), kind) for kind in ("q40", "q80")}
        flags = [[], ["--dtype", "float32"], ["--dtype", "float32", "--device", "cpu"],
                 ["--dtype", "float32", "--spec-draft", "8"]]
        done = iter(run_clis([(*files[kind], f + (["--weights-float-type", kind]
                                                  if "cpu" in f else []))
                              for kind in files for f in flags]))
        for kind in ("q40", "q80"):
            (card, card_out), (card32, _), (cpu32, _), (spec32, _) = [next(done)
                                                                     for _ in flags]
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

    with side_stopped(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / n
    by_name, families = device_time(prof, n)
    check_window(sum(by_name.values()), wall, "profiler window")
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


def records_per_replay(prof) -> list:
    """The device records of each ``cudaGraphLaunch`` in a profiler window,
    sorted: CUPTI gives a replay's kernel records the correlation id of the
    launch call that made them. Replays of one graph make the same records,
    so unequal counts mean records were lost."""
    events = prof.events()
    counts = {ev.id: 0 for ev in events if ev.name == "cudaGraphLaunch"}
    for ev in events:
        if (str(ev.device_type).endswith("CUDA") and ev.id in counts
                and not getattr(ev, "is_user_annotation", False)):
            counts[ev.id] += 1
    return sorted(counts.values())


def graph_window(torch, run) -> dict:
    """``run()`` (returns its step count) under the profiler: device busy
    and wall ms per step, the idle share, the split by kernel family, and
    the host's launch calls per step (one ``cudaGraphLaunch`` a replay).
    ``run()`` runs twice under the profiler's schedule: its warm-up step,
    whose records are dropped, then the measured one. The first replay a
    window profiles loses kernel records on the H100 (a window without the
    warm-up step counted 31.875 rope launches a graphed Q40 token), which an
    exact launch-count gate cannot take. A window can still lose records
    (one beside phase 13's compiles counted 30.375 rope launches a graphed
    Q80 token): where :func:`records_per_replay` finds replays that differ,
    the window is measured again, at most three times in all, as phase 2's
    is. The side processes are stopped while it runs (:func:`side_stopped`).
    The schedule marks each step with a ``ProfilerStep`` annotation that the
    profiler also reports as a device record spanning the whole step:
    :func:`device_time` leaves it out (counted in, it made every graphed
    window busier than its wall). :func:`log_window` logs the result and
    gates it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(3):
        with side_stopped(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            t1 = time.perf_counter()
            n = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / n
            prof.step()
        per_replay = records_per_replay(prof)
        if not per_replay or per_replay[0] == per_replay[-1]:
            break
        log(f"    profiler window {attempt + 1}: {per_replay[0]} to {per_replay[-1]} records a "
            f"graph launch (records lost); measured again")
    by_name, families = device_time(prof, n)
    calls = {}
    for ev in prof.key_averages():
        if ev.key in LAUNCH_CALLS:
            calls[ev.key] = calls.get(ev.key, 0) + ev.count / n
    busy = sum(by_name.values())
    r = {"wall_ms": wall, "host_launch_calls": calls, "attempts": attempt + 1,
         "records_per_replay": per_replay[:1] + per_replay[-1:],
         "top_other": sorted(((ms, name) for name, ms in by_name.items()
                              if not name.startswith(KERNEL_FAMILIES)), reverse=True)[:5]}
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
        f"{what}; host calls per {what}: {calls}; records a graph launch "
        f"{r['records_per_replay']} (attempt {r['attempts']})")
    for fam, v in r["kernels"].items():
        if v["launches"]:
            log(f"      {v['ms']:.4f} ms in {v['launches']:.0f} kernels  {fam}")
    log("      largest others: " + "; ".join(f"{ms:.4f} ms {name}"
                                             for ms, name in r["top_other"]))
    check_window(r["device_busy_ms"], r["wall_ms"], what)


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


def http_chat(port: int, body: dict, timeout: float = 600, headers: dict = None) -> dict:
    """POST /v1/chat/completions: the status, the JSON (or, streamed, the
    SSE deltas) and the seconds to the first content and to the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
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


#: 8b's and 8e's batch window: a wave sent at once is one window even on a
#: slow host. A request that misses it joins the running session mid-flight,
#: which changes a bucketed session's growth and the graphs it captures, so
#: that a second identical wave would capture one (seen at a 30 ms window)
P8_WINDOW_MS = 250.0


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
    ``--batch-window 250 --batch-max 8 --kv-buckets 0`` (prefill chunk 64):
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
                        batch_window_ms=P8_WINDOW_MS, batch_max=8, kv_buckets=0,
                        ts_interval=0.0)
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
    log(f"  (b) --batch-window {P8_WINDOW_MS:.0f} --batch-max 8 --kv-buckets 0 (prefill chunk "
        f"64): 8 requests "
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
    out["modes"] = phase8_modes(torch, dev, engine, tok, out["batched"])
    launched = {k: v for k, v in kernels.launches.items() if v}
    log(f"  kernel launches over phase 8's requests: {launched}")
    need = ("q40_matmul", "flash_decode_batched", "rope_cache_update_batched")
    if any(not launched.get(k) for k in need):
        fail(f"phase 8: the server's path launched {launched}, want each of {need}")
    out["launches"] = launched
    return out


P9_CHUNK = 8  # decode steps per step_chunk in phase 9
P9_TOL = 5e-2  # phase 2's decode-step tolerance, of max |logit|
P9_STEPS = 200  # tokens of each row of the exact gates
P9_PROMPT = 60  # tokens of each prompt of the exact gates


def graph_of(eng, sess, h, sampled: bool):
    """The step graph row ``h``'s decode shape replayed last (looked up,
    never made) and the row's index in it."""
    shape, r = sess._where[h]
    ring = max(P9_CHUNK, eng.decode_chunk)
    if sess.paged:
        owner = sess._arena
        key = (owner["v"].data_ptr(), ("paged", shape.nb, shape.cap), sampled, ring)
    else:
        owner = shape.cache
        key = (owner["v"].data_ptr(), tuple(owner["k"].shape), sampled, ring)
    g = eng.graphs._graphs.get((owner["k"].data_ptr(), *key))
    if g is None:
        fail(f"phase 9: no graph for row {h}'s shape {key}")
    return g, r


def row_kv(torch, sess, h, n: int):
    """Row ``h``'s KV at positions [0, n): [2, L, n, kv, hd]."""
    shape, r = sess._where[h]
    if sess.paged:
        idx = torch.tensor(sess._rowpages[h].blocks, dtype=torch.long,
                           device=sess._arena["k"].device)
        return torch.stack([sess._arena[nm].index_select(1, idx).flatten(1, 2)[:, :n]
                            for nm in ("k", "v")])
    return torch.stack([shape.cache[nm][:, r, :n] for nm in ("k", "v")])


def graphs_made(eng, before: set, peaks: dict) -> list:
    """The graphs made since the key set ``before``: shape key, capture ms
    and the peak memory allocated above the start of the chunk that made
    it (``peaks``: graph key -> MiB; the capture's pool at its fullest,
    with any other graph the chunk made)."""
    return [{"key": str(k[2:]), "capture_ms": round(g.capture_ms, 1),
             "chunk_peak_MiB": peaks.get(k)}
            for k, g in eng.graphs._graphs.items() if k not in before]


def near_tie(eng, prompt: list, want: list, got: list) -> dict:
    """Where a batched greedy stream ``got`` leaves the solo one ``want``:
    the solo prefill's logits at that position, and whether the two picks
    there are within the decode-step tolerance of each other (a near-tie
    that the kernels' summation order may break either way)."""
    i = leading_equal(want, got)
    if i >= min(len(want), len(got)):
        return {"equal": len(want) == len(got)}
    logits, _ = eng.prefill(eng.new_cache(), prompt + want[:i])
    logits = logits.float()
    gap, scale = float((logits[want[i]] - logits[got[i]]).abs()), float(logits.abs().max())
    return {"equal": False, "at": i, "gap": gap, "scale": scale,
            "near_tie": gap <= P9_TOL * scale}


def p9_run(torch, eng, sess, reqs: list, all_first: bool = False, profile_at: int = -1,
           logits_rows: bool = False) -> dict:
    """Drive ``sess`` with ``reqs`` [(prompt, steps)] (greedy): admit in
    order while ``can_admit`` (``all_first``: every request before the
    first chunk), one chunk a tick, release finished rows. Returns each
    request's tokens, rows resident at peak, wall ms, each chunk's wall
    ms, ms per admission, the profiler's window of chunk ``profile_at``,
    and (``logits_rows``) every chunk's last-step logits of each row live
    through it, with the tokens it had then."""
    pending, live, got = list(enumerate(reqs)), {}, {i: [] for i in range(len(reqs))}
    out = {"chunk_ms": [], "admit_ms": {}, "logits": {i: [] for i in range(len(reqs))},
           "profile": None, "peak": 0, "handles": {}, "graph_peaks": {}}
    box: dict = {}

    def one():
        box["fresh"] = sess.step_chunk()
        return P9_CHUNK

    t_start = time.perf_counter()
    k = 0
    while pending or live:
        while pending and sess.can_admit(len(pending[0][1][0]), pending[0][1][1]):
            i, (p, steps) = pending.pop(0)
            t0 = time.perf_counter()
            h = sess.admit(p, steps)
            out["admit_ms"][i] = (time.perf_counter() - t0) * 1e3
            live[h], out["handles"][i] = i, h
        if all_first and pending:
            fail(f"phase 9: {len(pending)} requests did not fit before the first chunk")
        out["peak"] = max(out["peak"], len(sess.occupied))
        if k == profile_at:
            h0 = next(iter(live))
            shape, r = sess._where[h0]
            window = shape.nb * sess.page if sess.paged else shape.ctx
            busy, wall, by_name, fams, _ = profile_window(torch, one)
            out["profile"] = {"busy_ms": busy, "wall_ms": wall, "by_name": by_name,
                              "families": fams, "window": window, "rows": shape.cap,
                              "pos": shape.pos[r]}
            out["chunk_ms"].append(wall * P9_CHUNK)
        else:
            keys = set(eng.graphs._graphs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            one()
            out["chunk_ms"].append((time.perf_counter() - t0) * 1e3)
            peak = round((torch.cuda.max_memory_allocated() - a0) / 2 ** 20, 1)
            for key in set(eng.graphs._graphs) - keys:
                out["graph_peaks"][key] = peak
        k += 1
        if k == 1:  # every row admitted so far has its first token now
            out["first_token_ms"] = (time.perf_counter() - t_start) * 1e3
        for h, burst in box["fresh"].items():
            got[live[h]] += burst
            if logits_rows and len(burst) == P9_CHUNK:
                g, r = graph_of(eng, sess, h, False)
                out["logits"][live[h]].append((len(got[live[h]]), g.logits[r].clone()))
        for h in [h for h in live if sess.is_done(h)]:
            if not all_first:
                sess.release(h)
                del live[h]
        if all_first and all(sess.is_done(h) for h in live):
            break
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t_start) * 1e3
    out["tokens"] = [got[i] for i in range(len(reqs))]
    return out


def p9_exact(torch, eng, sess, prompts: list, uniform: dict, what: str,
             profile_at: int = -1) -> dict:
    """9a's and 9b's exact gate: ``prompts`` (equal lengths), all admitted
    before the first chunk, greedy, ``P9_STEPS`` tokens each; every
    chunk's last-step logits, every token and each row's KV must equal
    ``uniform``'s (the same run on the uniform pool of 8) bit for bit."""
    before = set(eng.graphs._graphs)
    r = p9_run(torch, eng, sess, [(p, P9_STEPS) for p in prompts], all_first=True,
               profile_at=profile_at, logits_rows=True)
    n = P9_PROMPT - 1 + P9_STEPS
    hs = [r["handles"][i] for i in range(len(prompts))]
    r["kv"] = [row_kv(torch, sess, h, n) for h in hs]
    r["graphs"] = graphs_made(eng, before, r["graph_peaks"])
    if uniform is not None:
        checks = {
            "tokens": r["tokens"] == uniform["tokens"],
            "chunk logits": all(
                len(a) == len(b) and all(x[0] == y[0] and torch.equal(x[1], y[1])
                                         for x, y in zip(a, b))
                for a, b in zip(r["logits"].values(), uniform["logits"].values())),
            "KV": all(torch.equal(a, b) for a, b in zip(r["kv"], uniform["kv"])),
        }
        r["checks"] = checks
        log(f"    {what} exact gate (8 x {P9_PROMPT}-token prompts, {P9_STEPS} tokens, all "
            f"admitted before the first chunk) against the uniform pool of 8: {checks}")
        if not all(checks.values()):
            fail(f"phase 9 {what}: not bit-equal to the uniform pool: "
                 f"{[k for k, v in checks.items() if not v]}")
    return r


def p9_mixed(torch, eng, sess, reqs: list, solo: list, what: str) -> dict:
    """9a's mixed gate: ``reqs`` [(prompt, steps)] admitted as the budget
    allows; every row's greedy tokens equal its solo ``generate`` (or part
    from it only at a near-tie, logged), and each row's first full chunk's
    last-step logits are within the decode-step tolerance of a solo
    prefill of the same tokens."""
    before = set(eng.graphs._graphs)
    r = p9_run(torch, eng, sess, reqs, logits_rows=True)
    r["graphs"] = graphs_made(eng, before, r["graph_peaks"])
    ties, errs = [], []
    for i, ((p, _), want) in enumerate(zip(reqs, solo)):
        got = r["tokens"][i]
        if got != want:
            t = near_tie(eng, p, want, got)
            t["request"] = i
            ties.append(t)
        if r["logits"][i]:
            n, lg = r["logits"][i][0]
            ref, _ = eng.prefill(eng.new_cache(), p + got[:n - 1])
            ref = ref.float()
            errs.append(float((lg.float() - ref).abs().max()) / float(ref.abs().max()))
    r["near_ties"], r["logit_err_over_max"] = ties, max(errs) if errs else 0.0
    n_tok = sum(len(t) for t in r["tokens"])
    r["tokens_per_s"] = n_tok / r["wall_ms"] * 1e3
    checks = {"tokens = solo (or a logged near-tie)": all(t.get("near_tie") for t in ties),
              f"logits within {P9_TOL} of max": r["logit_err_over_max"] <= P9_TOL}
    r["checks"] = checks
    log(f"    {what} mixed ({len(reqs)} requests): {n_tok} tokens in {r['wall_ms']:.1f} ms = "
        f"{r['tokens_per_s']:.1f} tokens/s; rows resident at peak {r['peak']}; "
        f"{len(ties)} rows part from solo ({ties}); worst first-chunk logit error "
        f"{r['logit_err_over_max']:.2e} of max; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 9 {what} mixed: {[k for k, v in checks.items() if not v]}")
    return r


def index_ms(by_name: dict) -> float:
    """Device ms of the gather and scatter kernels (index_select,
    index_copy, advanced indexing) in a profiler split."""
    return sum(ms for name, ms in by_name.items()
               if any(w in name.lower() for w in ("index", "gather", "scatter")))


def phase9(torch, dev, engine) -> dict:
    """Bucketed KV slot pools and paged KV on phase 6's graphed Q40 engine
    (Llama-3-8B shape, full depth, seq_len 1024); see the module docstring."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.serving import kv_transfer

    cfg, card = engine.cfg, gpu_line()
    out: dict = {"card": card}
    log(f"  {card}")
    g = torch.Generator().manual_seed(9)
    exact = [torch.randint(0, cfg.vocab_size, (P9_PROMPT,), generator=g).tolist()
             for _ in range(8)]
    kw = dict(max_batch=8, chunk=P9_CHUNK, prefill_chunk=64)

    # -- 9a, bucketed ----------------------------------------------------------
    kernels.reset_launches()
    sess = engine.batch_session(**kw)
    uni = p9_exact(torch, engine, sess, exact, None, "uniform", profile_at=12)
    sess.close()
    launches_uniform = {k: v for k, v in kernels.launches.items() if v}
    copies = []
    orig = engine._bucket_cache_migrate

    def spy(dst, src, sb, db):
        orig(dst, src, sb, db)
        copies.append(all(torch.equal(dst[n][:, db, :src[n].shape[2]], src[n][:, sb])
                          for n in ("k", "v")))

    engine._bucket_cache_migrate = spy
    kernels.reset_launches()
    sess = engine.batch_session(bucket_kv=True, **kw)
    bkt = p9_exact(torch, engine, sess, exact, uni, "9a bucketed")
    bkt["migrations"] = sess.migrations
    sess.close()
    del engine._bucket_cache_migrate
    launches_bucketed = {k: v for k, v in kernels.launches.items() if v}
    if not (copies and all(copies) and bkt["migrations"] >= 16):
        fail(f"phase 9a: {bkt['migrations']} migrations, slab copies exact {copies}")
    log(f"    9a: {bkt['migrations']} migrations (each migrated slab prefix = its source, bit "
        f"for bit); graphs made {bkt['graphs']}")
    short = [torch.randint(0, cfg.vocab_size, (int(n),), generator=g).tolist()
             for n in torch.randint(8, 41, (8,), generator=g)]
    reqs = list(zip(batch_prompts(cfg, 8, 2) + short,
                    [int(n) for n in torch.randint(8, 201, (16,), generator=g)]))
    greedy = SamplerConfig(temperature=0.0, seed=0)
    solo = [engine.generate_fused(p, n, sampler=greedy)[0] for p, n in reqs]
    sess = engine.batch_session(bucket_kv=True, **kw)
    mixed_b = p9_mixed(torch, engine, sess, reqs, solo, "9a bucketed")
    mixed_b["migrations"] = sess.migrations
    sess.close()
    sess = engine.batch_session(**kw)
    mixed_u = p9_mixed(torch, engine, sess, reqs, solo, "uniform")
    sess.close()
    if mixed_b["peak"] <= mixed_u["peak"]:
        fail(f"phase 9a: {mixed_b['peak']} rows resident bucketed, {mixed_u['peak']} uniform")
    log(f"    9a mixed: bucketed {mixed_b['tokens_per_s']:.1f} tokens/s with {mixed_b['peak']} "
        f"rows at peak ({mixed_b['migrations']} migrations) against the uniform pool's "
        f"{mixed_u['tokens_per_s']:.1f} with {mixed_u['peak']}; graphs made bucketed "
        f"{mixed_b['graphs']}; uniform {mixed_u['graphs']}")
    out["bucketed"] = {"exact": {k: bkt[k] for k in ("checks", "migrations", "graphs",
                                                     "chunk_ms", "wall_ms")},
                       "uniform_exact": {k: uni[k] for k in ("chunk_ms", "wall_ms", "graphs")},
                       "mixed": {k: mixed_b[k] for k in ("checks", "peak", "tokens_per_s",
                                                         "wall_ms", "near_ties", "graphs",
                                                         "migrations", "logit_err_over_max")},
                       "mixed_uniform": {k: mixed_u[k] for k in (
                           "peak", "tokens_per_s", "wall_ms", "near_ties",
                           "logit_err_over_max")},
                       "launches": launches_bucketed, "launches_uniform": launches_uniform}

    # -- 9b, paged -------------------------------------------------------------
    kernels.reset_launches()
    sess = engine.batch_session(kv_pages=16, **kw)
    pgd = p9_exact(torch, engine, sess, exact, uni, "9b paged", profile_at=12)
    pgd["regroups"] = sess.regroups
    sess.close()
    launches_paged = {k: v for k, v in kernels.launches.items() if v}
    stats = sess.page_stats()
    if pgd["regroups"] < 16:
        fail(f"phase 9b: {pgd['regroups']} regroups")
    up, pp = uni["profile"], pgd["profile"]
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_size
    W = pp["window"]
    # a step gathers each row's window (read + write) and scatters one page
    # per row (read + write), for K and V, bf16
    gather_bytes = 2 * 2 * L * 8 * W * kvh * hd * 2
    scatter_bytes = 2 * 2 * L * 8 * 16 * kvh * hd * 2
    idx_ms = index_ms(pp["by_name"]) if pp["busy_ms"] > 0 else None
    step = {"uniform_ms": statistics.median(uni["chunk_ms"]) / P9_CHUNK,
            "paged_ms": statistics.median(pgd["chunk_ms"]) / P9_CHUNK,
            "profiled_uniform_busy_ms": up["busy_ms"], "profiled_paged_busy_ms": pp["busy_ms"],
            "profiled_window": W, "profiled_pos": pp["pos"],
            "gather_scatter_ms": idx_ms,
            "gather_scatter_bound_ms": (gather_bytes + scatter_bytes) / HBM_BYTES_PER_S * 1e3}
    log(f"    9b: {pgd['regroups']} regroups; page_stats after close {stats}; graphs made "
        f"{pgd['graphs']}")
    log(f"    9b B = 8 step, median over the run's chunks: paged {step['paged_ms']:.3f} ms "
        f"against the uniform pool's graphed {step['uniform_ms']:.3f} ms (the same positions); "
        f"profiled chunk at pos {pp['pos']} (window {W}): device busy paged "
        f"{pp['busy_ms']:.3f} ms a step, uniform {up['busy_ms']:.3f}; gather + scatter "
        f"{idx_ms if idx_ms is None else round(idx_ms, 4)} ms a step against "
        f"{gather_bytes + scatter_bytes} bytes over 3.35 TB/s = "
        f"{step['gather_scatter_bound_ms']:.4f} ms")
    extra = sorted(((ms - up["by_name"].get(name, 0.0), name)
                    for name, ms in pp["by_name"].items()), reverse=True)[:6]
    step["paged_minus_uniform_by_kernel"] = {name: round(ms, 4) for ms, name in extra}
    step["paged_by_name"], step["uniform_by_name"] = pp["by_name"], up["by_name"]
    log(f"    9b the profiled paged step's largest excess over the uniform step, ms by kernel: "
        f"{step['paged_minus_uniform_by_kernel']}")
    if stats["pages_free"] != stats["pages_total"] or stats.get("pages_cached"):
        fail(f"phase 9b: pages leaked after close: {stats}")

    prefix = torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist()
    waves = [[prefix + torch.randint(0, cfg.vocab_size, (int(n),), generator=g).tolist()
              for n in torch.randint(10, 21, (4,), generator=g)] for _ in range(2)]
    sess = engine.batch_session(kv_pages=16, **kw)
    got_w, matched = [], []
    for w in waves:
        m0, h0 = sess.prefix_tokens_matched, sess.prefix_hits
        matched.append([])
        orig_admit = sess.admit

        def admit(p, steps, **k):
            m = sess.prefix_tokens_matched
            h = orig_admit(p, steps, **k)
            matched[-1].append(sess.prefix_tokens_matched - m)
            return h

        sess.admit = admit
        got_w.append(p9_run(torch, engine, sess, [(p, 24) for p in w], logits_rows=True))
        del sess.admit
    hit_rate = sess.prefix_hit_rate
    sess.close()
    # cold: a bucketed pool (no prefix cache) of the same capacity
    cold_sess = engine.batch_session(bucket_kv=True, **kw)
    cold = p9_run(torch, engine, cold_sess, [(p, 24) for p in waves[1]], logits_rows=True)
    cold_sess.close()
    ties = [near_tie(engine, p, c, w) for p, c, w in zip(waves[1], cold["tokens"],
                                                        got_w[1]["tokens"])]
    errs = [float((a[0][1].float() - b[0][1].float()).abs().max())
            / float(b[0][1].float().abs().max())
            for a, b in zip(got_w[1]["logits"].values(), cold["logits"].values()) if a and b]
    p_checks = {"hit rate > 0": hit_rate > 0, "wave 2 matched >= 48 each":
                min(matched[1]) >= 48,
                "warm tokens = cold (or a logged near-tie)":
                    all(t.get("equal") or t.get("near_tie") for t in ties),
                f"warm logits within {P9_TOL} of cold": max(errs) <= P9_TOL}
    ttft = {"cold_ms": [round(v, 1) for v in cold["admit_ms"].values()],
            "wave1_ms": [round(v, 1) for v in got_w[0]["admit_ms"].values()],
            "wave2_ms": [round(v, 1) for v in got_w[1]["admit_ms"].values()],
            "first_token_ms": {"cold": round(cold["first_token_ms"], 1),
                               "wave1": round(got_w[0]["first_token_ms"], 1),
                               "wave2": round(got_w[1]["first_token_ms"], 1)}}
    log(f"    9b prefix: 64-token system prefix, two waves of 4: hit rate {hit_rate:.3f}, "
        f"matched tokens per admission {matched}; admission prefill ms each, and the wave's "
        f"time to first token (4 admissions and the first chunk) {ttft}; warm/cold logit error {max(errs):.2e} of max; "
        f"near-ties {[t for t in ties if not t.get('equal')]}; checks {p_checks}")
    if not all(p_checks.values()):
        fail(f"phase 9b prefix: {[k for k, v in p_checks.items() if not v]}")
    out["paged"] = {"exact": {k: pgd[k] for k in ("checks", "regroups", "graphs", "chunk_ms",
                                                  "wall_ms")},
                    "stats_after_close": stats, "step": step, "prefix": {
                        "checks": p_checks, "hit_rate": hit_rate, "matched": matched,
                        "admit_ms": ttft, "logit_err": max(errs)},
                    "launches": launches_paged}

    # -- 9c, migration ---------------------------------------------------------
    mig = {}
    for name, scfg, mode in (("greedy f32", greedy, "f32"),
                             ("sampled f32", SamplerConfig(temperature=0.8, topp=0.9, seed=5),
                              "f32"),
                             ("greedy q80", greedy, "q80")):
        src = engine.batch_session(kv_pages=16, **kw)
        h = src.admit(exact[0], 48, sampler=scfg)
        first = src.step_chunk()[h] + src.step_chunk()[h]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = src.export_row(h)
        export_ms = (time.perf_counter() - t0) * 1e3
        wire = kv_transfer.encode_snapshot(snap, exact[0], mode=mode)
        kept, kept_logits = list(first), []
        while not src.is_done(h):
            kept += src.step_chunk()[h]
            g_, r_ = graph_of(engine, src, h, scfg.temperature > 0)
            kept_logits.append(g_.logits[r_].clone())
        src.close()
        dst = engine.batch_session(kv_pages=16, **kw)
        t0 = time.perf_counter()
        back = kv_transfer.decode_snapshot(wire)
        h2 = dst.admit_from_export(back["prompt"], back)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        cont, cont_logits = list(first), []
        while not dst.is_done(h2):
            cont += dst.step_chunk()[h2]
            g_, r_ = graph_of(engine, dst, h2, scfg.temperature > 0)
            cont_logits.append(g_.logits[r_].clone())
        dst.close()
        # the chunks whose inputs are still the kept row's (the q80 wire's
        # rounding may flip a later greedy pick)
        same = [i for i in range(len(cont_logits))
                if cont[:len(first) + P9_CHUNK * (i + 1) - 1]
                == kept[:len(first) + P9_CHUNK * (i + 1) - 1]]
        err = max(float((cont_logits[i].float() - kept_logits[i].float()).abs().max())
                  / float(kept_logits[i].float().abs().max()) for i in same) if same else None
        ok = (cont == kept and all(torch.equal(a, b) for a, b in zip(cont_logits, kept_logits))
              if mode == "f32" else (len(cont) == len(kept) and err is not None
                                     and err <= P9_TOL))
        mig[name] = {"ok": ok, "wire_bytes": len(wire), "export_ms": export_ms,
                     "import_ms": import_ms, "logit_err_over_max": err,
                     "tokens_equal": leading_equal(cont, kept), "tokens": len(kept)}
        log(f"    9c {name}: exported after 2 chunks ({len(snap['keys'])} state words), "
            f"{len(wire)} wire bytes, export {export_ms:.1f} ms, decode + import "
            f"{import_ms:.1f} ms; continued stream {'=' if cont == kept else '!='} the kept "
            f"row ({leading_equal(cont, kept)} of {len(kept)} leading tokens equal), logit "
            f"error {err} of max over {len(same)} chunks; {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"phase 9c {name}: the migrated row does not continue the kept one")
    out["migration"] = mig
    torch.cuda.empty_cache()
    return out


def traced_sessions(engine) -> list:
    """Record every BatchSession the engine opens from now on: its options
    and each admit_begin / prefill_step / step_chunk / release / cancel /
    export_row / admit_from_export call with its arguments and result, in
    order. ``del engine.batch_session`` stops it."""
    orig = type(engine).batch_session.__get__(engine)
    traces: list = []

    def traced(max_batch, chunk=None, **kw):
        sess = orig(max_batch, chunk, **kw)
        rec = {"kw": dict(kw, max_batch=max_batch, chunk=chunk, kv_budget=None), "calls": []}
        traces.append(rec)
        for name in ("admit_begin", "prefill_step", "step_chunk", "release", "cancel",
                     "export_row", "admit_from_export"):
            def wrap(*a, _fn=getattr(sess, name), _name=name, **k):
                r = _fn(*a, **k)
                rec["calls"].append((_name, a, k, r))
                return r

            setattr(sess, name, wrap)
        return sess

    engine.batch_session = traced
    return traces


def replay(engine, rec: dict) -> bool:
    """Replay one traced session's calls on a direct session of the same
    options: True when every call returns what the server's did (handles,
    prefill progress, every chunk's tokens)."""
    sess = type(engine).batch_session(engine, **rec["kw"])
    same = True
    for name, a, k, r in rec["calls"]:
        if name == "export_row":
            continue
        got = getattr(sess, name)(*a, **k)
        if name != "admit_from_export":
            same = same and got == r
    sess.close()
    return same


def phase8_modes(torch, dev, engine, tok, batched: dict) -> dict:
    """8e-8g: the server's bucketed, paged and role modes on phase 6's
    graphed Q40 engine (see the module docstring)."""
    import threading

    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.serving import kv_transfer
    from dllama_tpu_torch.serving.api_server import ServerState, drain_and_shutdown

    cfg, card = engine.cfg, gpu_line()
    out: dict = {}

    def serve(**kw):
        state = ServerState(engine if "engine" not in kw else kw.pop("engine"), tok, cfg,
                            model_name="llama3-8b-shape", template="llama3", ts_interval=0.0,
                            **kw)
        srv, port = start_server(state)
        return state, srv, port

    def stop(state, srv):
        drain_and_shutdown(state, srv, 10.0)
        srv.server_close()

    # -- (e) (b)'s window and pool size, the default --kv-buckets 1 -----------
    bodies = [{"messages": [{"role": "user", "content": p}], "max_tokens": WAVE_TOKENS,
               "temperature": 0.8 if i % 2 else 0.0, "top_p": 0.9, "seed": 100 + i}
              for i, p in enumerate(wave_prompts(8, 3))]
    traces = traced_sessions(engine)
    state, srv, port = serve(batch_window_ms=P8_WINDOW_MS, batch_max=8)
    try:
        made1 = engine.graphs.made
        wave1, wall1 = send_wave(port, bodies)
        made = engine.graphs.made
        made1 = made - made1
        wave2, wall2 = send_wave(port, bodies)
        made = engine.graphs.made - made
    finally:
        stop(state, srv)
        del engine.batch_session
    with state.lock:
        direct = [replay(engine, rec) for rec in traces]
    n_tok = sum(r["json"]["usage"]["completion_tokens"] for r in wave1)
    lat = [r["seconds"] * 1e3 for r in wave1]
    texts = [[c["message"]["content"] for c in r["json"]["choices"]] for r in wave1]
    e_checks = {"statuses": [r["status"] for r in wave1 + wave2] == [200] * 16,
                "bucketed sessions": all(rec["kw"].get("bucket_kv") for rec in traces),
                "ids = a direct bucketed BatchSession": bool(direct) and all(direct),
                "wave 2 = wave 1": texts == [[c["message"]["content"]
                                              for c in r["json"]["choices"]] for r in wave2],
                "wave 2 captures": made == 0}
    out["bucketed"] = {"checks": e_checks, "tokens_per_s": n_tok / wall1, "wall_ms": wall1 * 1e3,
                       "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
                       "second_wave_ms": wall2 * 1e3, "sessions": len(traces),
                       "captures": [made1, made]}
    log(f"  (e) --batch-window {P8_WINDOW_MS:.0f} --batch-max 8 (--kv-buckets 1, the default): "
        f"8b's wave; "
        f"checks {e_checks}")
    log(f"    wave: {n_tok} tokens in {wall1 * 1e3:.1f} ms = {n_tok / wall1:.1f} tokens/s "
        f"(8b uniform: {batched['tokens_per_s']:.1f}); p50 {percentile(lat, 50):.1f} ms, p99 "
        f"{percentile(lat, 99):.1f} ms (8b: {batched['p50_ms']:.1f} / {batched['p99_ms']:.1f}); "
        f"second wave {wall2 * 1e3:.1f} ms; graphs made by wave 1 {made1}, wave 2 {made}; "
        f"{len(traces)} sessions replayed")
    if not all(e_checks.values()):
        fail(f"phase 8e: {[k for k, v in e_checks.items() if not v]}")

    # -- (f) --kv-pages 16: a shared system prompt, then preemption -------------
    system = {"role": "system", "content": " ".join(wave_prompts(6, 11))}
    state, srv, port = serve(batch_window_ms=30.0, batch_max=8, kv_pages=16)
    try:
        ttft, hit = [], []
        for w, seed in ((0, 21), (1, 22)):
            wb = [{"messages": [system, {"role": "user", "content": p}], "max_tokens": 16,
                   "temperature": 0.0, "stream": True} for p in wave_prompts(4, seed)]
            rs, _ = send_wave(port, wb)
            if [r["status"] for r in rs] != [200] * 4:
                fail(f"phase 8f wave {w}: {[r['status'] for r in rs]}")
            ttft.append(statistics.median(r["content_times"][0] * 1e3 for r in rs))
            hit.append(json.loads(http_get(port, "/ready")[1])["prefix_hit_rate"])
    finally:
        stop(state, srv)
    log(f"  (f) --kv-pages 16, two waves of 4 sharing a system prompt: /ready prefix hit rate "
        f"after each wave {hit}; median time to first token per wave {ttft} ms")
    out["paged"] = {"hit_rate": hit, "ttft_ms": ttft}

    state, srv, port = serve(batch_window_ms=5.0, batch_max=1, kv_pages=16,
                             slo_classes="interactive:depth=8;batch:depth=4")
    ids: list = []
    orig_ss = state.batcher.submit_stream

    def submit_stream(prompt_tokens, max_tokens, sampler, **kw):
        rec = []
        ids.append(rec)
        for burst in orig_ss(prompt_tokens, max_tokens, sampler, **kw):
            if isinstance(burst, list):
                rec.extend(burst)
            yield burst

    state.batcher.submit_stream = submit_stream
    pre = state.batcher._m_preemptions
    batch_body = {"messages": [{"role": "user", "content": "Tell me a long story"}],
                  "max_tokens": 300, "temperature": 0.0, "stream": True}
    # the interactive prompt takes more pages than the batch row leaves free
    # (the pool is one row's context, 1,024 tokens)
    words = wave_prompts(60, 5)
    content = ""
    while len(tok.encode(state.build_prompt([{"role": "user", "content": content}]),
                         add_bos=True)) < 800:
        content += " " + words.pop()
    inter_body = {"messages": [{"role": "user", "content": content}], "max_tokens": 4,
                  "temperature": 0.0}
    try:
        import http.client

        def post(body, cls):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                         headers={"Content-Type": "application/json", "X-Dllama-Class": cls})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, data

        control = post(batch_body, "batch")
        ok0 = pre.value(outcome="ok")
        res: dict = {}
        t = threading.Thread(target=lambda: res.setdefault("batch", post(batch_body, "batch")))
        t.start()
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline
               and state.batcher.class_stats()["batch"]["resident"] < 1):
            time.sleep(0.002)
        res["inter"] = post(inter_body, "interactive")
        t.join(timeout=600)
        n_pre = pre.value(outcome="ok") - ok0
    finally:
        stop(state, srv)
    f_checks = {"statuses": control[0] == res["batch"][0] == res["inter"][0] == 200,
                "preempted": n_pre >= 1,
                "resumed ids = unpreempted": len(ids) >= 2 and ids[0] == ids[1]
                and len(ids[0]) == 300}
    log(f"    preemption (1-row paged pool, batch row of 300 tokens, an interactive prompt "
        f"that does not fit beside it): {n_pre} preemptions; checks {f_checks}")
    if not all(f_checks.values()):
        fail(f"phase 8f: {[k for k, v in f_checks.items() if not v]}")
    out["preemption"] = {"checks": f_checks, "preemptions": n_pre}

    # -- (g) --role prefill and --role decode, checkpoints ---------------------
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated(dev)
    twin = Engine(cfg, engine.params, engine.sampler_cfg, cache_dtype=engine.cache_dtype,
                  device=dev)
    torch.cuda.synchronize()
    twin_bytes = torch.cuda.memory_allocated(dev) - a0
    shared = twin_bytes < 2 ** 28  # the weights are ~4.5 GB; the twin adds its rope tables
    kw = dict(batch_window_ms=5.0, batch_max=8, kv_pages=16, ckpt_interval=8)
    colo, pre_s, dec_s = (serve(**kw), serve(role="prefill", **kw),
                          serve(engine=twin, role="decode", **kw))
    rec: dict = {}
    for name, (state, _, _) in (("colocated", colo), ("prefill", pre_s), ("decode", dec_s)):
        rec[name] = []
        for meth in ("submit_stream", "submit_import_stream"):
            orig_m = getattr(state.batcher, meth)

            def wrapped(*a, _orig=orig_m, _rec=rec[name], **k):
                got = []
                _rec.append(got)
                for burst in _orig(*a, **k):
                    if isinstance(burst, list):
                        got.extend(burst)
                    yield burst

            setattr(state.batcher, meth, wrapped)
    body = {"messages": [{"role": "user", "content": "Describe the moon"}], "max_tokens": 40,
            "temperature": 0.0, "stream": True}
    try:
        import http.client

        def raw(port, path, payload, headers):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            hdrs = dict(resp.getheaders())
            conn.close()
            return resp.status, hdrs, data

        js = {"Content-Type": "application/json"}
        st_c, _, colo_data = raw(colo[2], "/v1/chat/completions", json.dumps(body),
                                 dict(js, **{"X-Dllama-Ckpt": "8"}))
        t0 = time.perf_counter()
        st_p, _, wire = raw(pre_s[2], "/v1/prefill", json.dumps(body), js)
        t1 = time.perf_counter()
        carried = kv_transfer.decode_snapshot(wire)["extra"]["emitted_tokens"]
        st_d, _, dec_data = raw(dec_s[2], "/v1/kv/import", wire,
                                {"Content-Type": kv_transfer.CONTENT_TYPE})
        t2 = time.perf_counter()
        visible, frames = [], []
        for ev in colo_data.split(b"\n\n"):
            if ev.startswith(b"event: dllama-ckpt"):
                line = next(ln for ln in ev.split(b"\n") if ln.startswith(b"data: "))
                off, _, b64 = line[6:].partition(b" ")
                frames.append((int(off), __import__("base64").b64decode(b64)))
            elif ev:
                visible.append(ev + b"\n\n")
        visible = b"".join(visible)
        off, payload = frames[len(frames) // 2]
        st_r, _, cont = raw(dec_s[2], "/v1/kv/resume", payload,
                            {"Content-Type": kv_transfer.CONTENT_TYPE})
    finally:
        for state, srv, _ in (colo, pre_s, dec_s):
            stop(state, srv)

    def text(data):
        parts = []
        for line in data.split(b"\n"):
            if line.startswith(b"data: {"):
                for ch in json.loads(line[6:]).get("choices", []):
                    parts.append((ch.get("delta") or {}).get("content") or "")
        return "".join(parts)

    colo_ids = rec["colocated"][0] if rec["colocated"] else []
    dec_ids = carried + (rec["decode"][0] if rec["decode"] else [])
    g_checks = {"statuses": [st_c, st_p, st_d, st_r] == [200] * 4,
                "weights shared": shared,
                "prefill -> import ids = colocated": dec_ids == colo_ids and len(colo_ids) == 40,
                "prefill -> import text = colocated": text(dec_data) == text(visible),
                "resume splices byte for byte": cont == visible[off:]}
    log(f"  (g) --role prefill + --role decode (the decode engine shares the prefill engine's "
        f"weight tensors: {shared}, it added {twin_bytes / 2 ** 20:.1f} MiB), one streamed request of 40 tokens: {len(wire)} wire bytes, "
        f"/v1/prefill {(t1 - t0) * 1e3:.1f} ms, /v1/kv/import {(t2 - t1) * 1e3:.1f} ms; "
        f"{len(frames)} checkpoint frames, resumed frame at byte {off}; checks {g_checks}")
    if not all(g_checks.values()):
        fail(f"phase 8g: {[k for k, v in g_checks.items() if not v]}")
    out["roles"] = {"checks": g_checks, "wire_bytes": len(wire),
                    "prefill_ms": (t1 - t0) * 1e3, "import_ms": (t2 - t1) * 1e3}
    del twin
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
        [(ids, _)] = run_clis([(model, tok, ["--profile", str(Path(d) / "prof")])])
        events = json.loads((Path(d) / "prof" / "trace.json").read_text())["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    gemv = sum("q40_gemv_kernel" in n for n in kern)
    log(f"  (d) cli verify exit codes: {rcs} (the file, a copy with one byte flipped); cli "
        f"generate --profile: {len(ids)} tokens, {len(kern)} kernel events in the trace, "
        f"{gemv} of them q40_gemv_kernel")
    if rcs[0] != 0 or rcs[1] == 0 or not gemv:
        fail(f"phase 8d: verify exit codes {rcs}, trace kernels {sorted(set(kern))[:20]}")
    return {"verify_rcs": rcs, "kernel_events": len(kern), "q40_gemv_events": gemv}


# ---------------------------------------------------------------------------
# Phase 10: tensor parallelism
# ---------------------------------------------------------------------------

#: K1's and K3's decode GEMVs at the shard widths a rank of the Llama-3-8B
#: shape launches: (matrix, K, O at tp 2, O at tp 4, launches per token)
TP_WIDTHS = [("wqkv", 4096, 3072, 1536, 32), ("wo", 4096, 2048, 1024, 32),
             ("w13", 4096, 14336, 7168, 32), ("w2", 14336, 2048, 1024, 32),
             ("wcls", 4096, 64128, 32128, 1)]
#: rows of K1's and K3's launches at the shard widths: a decode step (1),
#: and phase 10f's verify steps, the GEMV at 5, the tile at 9, 16 and 72
TP_WIDTH_T = (1, 5, 9, 16, 72)
#: greedy decode tokens of phase 10's runs (after the prefill's token)
TP_STEPS = 32
#: phase 10b's batched run: B = 4 rows, this many steps
TP_BATCH_STEPS = 8
#: phase 10d: Mixtral widths at 4 of its 32 layers
TP_MIXTRAL = {**MIXTRAL_8X7B, "n_layers": 4}


def time_width(torch, dev, gen, kind: str, name: str, tp: int, K: int, O: int, ts: tuple,
               per_token: int) -> list:
    """K1 (``kind`` q40) or K3 (q80) on one [K, O] shard at each row count
    of ``ts``: against its plain version within 1e-5 * max|ref|, timed
    (weights rotating past L2) beside its byte bound, its plain version and
    bf16 ``torch.matmul``; the route's plan and how many of the card's
    block slots its grid fills."""
    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.ops import qmatmul

    n_sm = kernels.sm_count(dev)
    kern = qmatmul.q40_matmul if kind == "q40" else qmatmul.q80_matmul
    plain = qmatmul.q40_matmul_ref if kind == "q40" else qmatmul.q80_matmul_ref
    cols = qmatmul.q40_gemv_cols() if kind == "q40" else qmatmul._GEMV_COLS
    planes = [quant_planes(torch, dev, gen, kind, K, O)]
    planes += [quant_planes(torch, dev, gen, kind, K, O)
               for _ in range(math.ceil(200e6 / plane_bytes(planes[0])) - 1)]
    rows = []
    for T in ts:
        x = torch.randn((T, K), device=dev, generator=gen).to(torch.bfloat16)
        got = kern(x, *planes[0])
        ref = plain(x, *planes[0])
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"{kind}_matmul {name} at tp {tp} (K {K}, O {O}, T {T}): {err} > {tol}")
        per_sm = (0 if T > qmatmul.GEMV_MAX_T  # the tile's plan takes none
                  else qmatmul.q40_gemv_blocks_per_sm(T) if kind == "q40"
                  else qmatmul.gemv_blocks_per_sm(T, False))
        route, ksplit, split_rows = (qmatmul.q40_plan if kind == "q40"
                                     else qmatmul.q80_plan)(T, K, O, n_sm, per_sm)
        if route == "gemv":
            blocks_, slots = math.ceil(O / cols) * ksplit, n_sm * per_sm
        else:
            blocks_ = math.prod(qmatmul.tile_plan(T, K, O, n_sm)[:3])
            slots = n_sm * qmatmul.TILE_BLOCKS_PER_SM
        nxt = rotating(planes)
        ms = time_ms(torch, lambda: kern(x, *nxt()))
        b, by = bound_ms(plane_bytes(planes[0]) + T * K * 2 + T * O * 4, 2.0 * T * K * O,
                         BF16_FLOPS)
        row = {"kind": kind, "matrix": name, "tp": tp, "T": T, "K": K, "O": O, "ms": ms,
               "bound_ms": b, "bound_by": by, "max_abs_err": err, "tol": tol,
               "plain_ms": time_ms(torch, lambda: plain(x, *planes[0]), 10),
               "library_ms": library_ms(torch, kind, planes, x), "route": route,
               "ksplit": ksplit, "rows_per_split": split_rows, "blocks": blocks_,
               "block_slots": slots, "launches_per_token": per_token,
               "gb_per_s": plane_bytes(planes[0]) / ms / 1e6}
        rows.append(row)
        log(f"  {kind}_matmul {name:4s} tp {tp} T {T:2d}: K {K:5d} -> O {O:5d}  "
            f"{ms:.4f} ms (bound {b:.4f} ms, {by}; {row['gb_per_s']:.0f} GB/s) "
            f"plain {row['plain_ms']:.3f} ms, bf16 torch.matmul "
            f"{row['library_ms']:.4f} ms; {route} ksplit={ksplit}: {blocks_} "
            f"blocks for {slots} slots; err {err:.2e} (tol {tol:.2e})")
    del planes
    return rows


def phase10_widths(torch, dev, gen) -> list:
    """K1 (q40) and K3 (q80) at the tp 2 and tp 4 output-shard widths
    (:func:`time_width`), at each row count of TP_WIDTH_T: the decode GEMV
    at T = 1 (a decode step) and T = 5 (a verify step of 5 rows), the
    tensor-core tile at T = 9, 16 and 72 (solo verify steps at draft 8 and
    at the kernels' most rows, B = 8 sequences of 9)."""
    rows = []
    for kind in ("q40", "q80"):
        for name, K, o2, o4, per_token in TP_WIDTHS:
            for tp, O in ((2, o2), (4, o4)):
                rows += time_width(torch, dev, gen, kind, name, tp, K, O, TP_WIDTH_T, per_token)
        torch.cuda.empty_cache()
    return rows


def write_tp_model(path: Path, cfg_kw: dict, seed: int) -> float:
    """A random Q40 `.m` file of ``cfg_kw``'s widths written straight in the
    file's bytes (scales U[0, 0.004) as f16, random nibbles; the embedding
    N(0, 0.02)), never held in f32. Returns its size in GB."""
    import numpy as np

    from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
    from dllama_tpu_torch.formats.weights import ModelWriter
    from dllama_tpu_torch.quants import blocks

    spec = ModelSpec(arch=ArchType.LLAMA, dim=cfg_kw["dim"], hidden_dim=cfg_kw["hidden_dim"],
                     n_layers=cfg_kw["n_layers"], n_heads=cfg_kw["n_heads"],
                     n_kv_heads=cfg_kw["n_kv_heads"], vocab_size=cfg_kw["vocab_size"],
                     seq_len=cfg_kw["seq_len"], weights_float_type=blocks.Q40,
                     rope_theta=cfg_kw["rope_theta"])
    rng = np.random.default_rng(seed)
    with ModelWriter(str(path), spec, checksums=False) as w:  # a throwaway file
        for e in w.plan:
            if e.float_type == blocks.F32:
                x = (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                     else rng.standard_normal(e.d * e.n, dtype=np.float32) * 0.02)
                w.write_next(e.name, x)
                continue
            nb = e.d * e.n // 32
            raw = np.frombuffer(rng.bytes(nb * blocks.Q40_BLOCK_BYTES), np.uint8)
            raw = raw.reshape(nb, blocks.Q40_BLOCK_BYTES).copy()
            raw[:, :2] = (rng.random(nb, dtype=np.float32) * 0.004).astype(np.float16).view(
                np.uint8).reshape(nb, 2)
            w.write_next_raw(e.name, raw)
    return path.stat().st_size / 1e9


#: phase 10's `.m` file (:func:`start_tp_file` writes it while phases 1-9 run)
TP_FILE = ROOT / "build" / "tp" / "llama_q40.m"


def start_tp_file(cfg_kw: dict = LLAMA3_8B):
    """Start writing phase 10's `.m` file (:func:`write_tp_model`, seed 3) in
    a process of its own and return it: the write takes ~35 s of one host
    core, which the phases before phase 10 (on the card) leave idle."""
    import multiprocessing as mp

    TP_FILE.parent.mkdir(parents=True, exist_ok=True)
    proc = mp.get_context("spawn").Process(target=write_tp_model, args=(TP_FILE, cfg_kw, 3),
                                           daemon=True)
    proc.start()
    return proc


def first_step(torch, eng, prompt: list, tok=None) -> tuple:
    """(f32 logits [vocab] of the first decode step after ``prompt``, the
    token fed: ``tok``, or the prefill's greedy pick), on a fresh cache."""
    from dllama_tpu_torch.models import llama

    cache = eng.new_cache()
    logits, cache = eng.prefill(cache, prompt)
    tok = int(logits.argmax()) if tok is None else tok
    step, _ = llama.forward(eng.cfg, eng.params, eng.rope,
                            torch.tensor([tok], device=eng.device), cache, len(prompt),
                            **eng._tp_kw)
    return step[0].float(), tok


def decode_run(torch, eng, prompt: list, steps: int) -> dict:
    """``steps`` greedy tokens of ``generate`` (after the prefill's),
    counted: tokens, ms and kB sent per decode token (median), launches."""
    from dllama_tpu_torch import kernels

    dev = eng.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kernels.reset_launches()
    toks, ms, kb = [], [], []
    for tok, st in eng.generate(prompt, steps + 1):
        toks.append(tok)
        ms.append(st.generation_ms)
        kb.append(st.sent_kb)
    return {"tokens": toks, "ms_per_token": statistics.median(ms[1:]),
            "kb_per_token": statistics.median(kb[1:]), "launches": dict(kernels.launches)}


#: a rank process's loaded shards of phase 10's `.m` file, kept for 10g:
#: (path, tp, row-packed) -> (cfg, params); :func:`p10_release` empties it
RANK_PARAMS: dict = {}


def rank_params(group, path: str, row: bool) -> tuple:
    """(cfg, this rank's Q40 shard of the `.m` file at ``path``): wo/w2 as
    row shards with ``row`` (``--tp-reduce``), else output shards; loaded
    once a process (at one rank the two packs are the same params)."""
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig

    key = (path, group.size, row and group.size > 1)
    if key not in RANK_PARAMS:
        with WeightFileReader(path) as reader:
            cfg = ModelConfig.from_spec(reader.spec, dtype="bfloat16")
            RANK_PARAMS[key] = (cfg, llama.quant_params_from_reader(
                reader, cfg, group.device, "q40", tp=group, tp_reduce=key[2]))
    return RANK_PARAMS[key]


def p10_release(group, size: int = 0) -> None:
    """Free this rank's kept shards of a ``size``-way world (0: all of them)
    and the memory its allocator holds."""
    for key in [k for k in RANK_PARAMS if size in (0, k[1])]:
        del RANK_PARAMS[key]
    import torch

    if group.device.type == "cuda":
        torch.cuda.empty_cache()


def tp_rank_llama(group, path: str, prompt: list, batch_prompts: list, q80_wire: bool) -> dict:
    """One rank of phase 10b (and 10c with ``q80_wire``): its shard of the
    `.m` file at ``path`` (load time, peak memory), the first decode step's
    logits (rank 0 returns them), 32 greedy tokens, ``generate_batch`` at
    B = 4; with ``q80_wire`` one teacher-forced step over the Q80 wire on
    the same shards and the bytes that step sent."""
    import torch

    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = rank_params(group, path, False)
    if cuda:
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    eng = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                 cache_dtype=torch.bfloat16, tp=group, metrics=None)
    del params
    logits, tok = first_step(torch, eng, prompt)
    out = {"rank": group.rank, "load_s": load_s,
           "shapes": {n: list(v.w.shape) for n, v in eng.params["layers"].items()
                      if hasattr(v, "kind")} | {"wcls": list(eng.params["wcls"].w.shape)},
           "logits": logits.cpu().numpy() if group.rank == 0 else None,
           **decode_run(torch, eng, prompt, TP_STEPS)}
    if batch_prompts:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out["batch"] = eng.generate_batch(batch_prompts, TP_BATCH_STEPS)
        out["batch_s"] = time.perf_counter() - t0
        out["batch_launches"] = dict(kernels.launches)
    if q80_wire:
        wire = Engine(cfg, eng.params, SamplerConfig(temperature=0.0, seed=0),
                      cache_dtype=torch.bfloat16, tp=group, tp_compress=True, metrics=None)
        cache = wire.new_cache()
        wire.prefill(cache, prompt)
        before = group.sent_bytes
        step, _ = llama.forward(cfg, wire.params, wire.rope, torch.tensor([tok], device=dev),
                                cache, len(prompt), tp=group, tp_compress=True)
        out["q80_step_bytes"] = group.sent_bytes - before
        out["q80_logits"] = step[0].float().cpu().numpy() if group.rank == 0 else None
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    return out


def tp_rank_moe(group, cfg_kw: dict, prompt: list, steps: int) -> dict:
    """One rank of phase 10d: its shard of a random Q40 MoE model made from
    seed 0 on its device (``random_quant_params(tp=)``), the first decode
    step's logits (rank 0), ``steps`` greedy tokens and their launches."""
    import torch

    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    dev = group.device
    cfg = ModelConfig(**cfg_kw)
    params = llama.random_quant_params(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                                       "q40", tp=group)
    eng = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                 cache_dtype=torch.bfloat16, tp=group, metrics=None)
    logits, _ = first_step(torch, eng, prompt)
    return {"logits": logits.cpu().numpy() if group.rank == 0 else None,
            **decode_run(torch, eng, prompt, steps),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None}


def tp_wire_bytes(cfg, tp: int, per_feat: float, hidden: int, vocab_padded: int) -> float:
    """The bytes one rank's gathers send in a decode step (one row): four
    gathers a layer (heads, wo out, the padded hidden, w2 out) at
    ``per_feat`` bytes a feature, then the f32 logits, each (tp - 1)/tp of
    the whole vector — the JAX package's ``Engine._wire_bytes`` count."""
    return (cfg.n_layers * (3 * cfg.dim + hidden) * per_feat + vocab_padded * 4.0) * (tp - 1) / tp


#: phase 10e: the flags of the TP server (``--port`` added), and of its chat
P10E_SERVE = ["--dtype", "bfloat16", "--weights-float-type", "q40", "--temperature", "0",
              "--seed", "0", "--chat-template", "llama3", "--batch-window", "500",
              "--batch-max", "4", "--batch-chunk", "8", "--kv-buckets", "0",
              "--prefill-chunk", "0", "--ts-interval", "0", "--host", "127.0.0.1"]
P10E_CHAT = ["--dtype", "bfloat16", "--weights-float-type", "q40", "--temperature", "0",
             "--seed", "0", "--chat-template", "llama3", "--system-prompt", "",
             "--steps", "8"]
P10E_TURNS = "Tell me about the ocean\nAnd the tides\n"
#: tokens of each request of 10e's wave, and of its other requests
P10E_TOKENS = 32
P10E_SHORT = 16
#: the continuous pool of P10E_SERVE: 4 uniform rows, chunks of 8, monolithic admission
P10E_POOL = dict(max_batch=4, chunk=8)


def tp_serve_rank(group, argv: list, turns: str = None) -> dict:
    """One rank of phase 10e: ``cli.run_tp_rank`` on ``argv`` (a ``serve``
    or ``chat`` command line), this rank's kernel launches counted from 0,
    and with ``turns`` (chat) rank 0's stdin those lines and its stdout
    kept. Returns the rank's control-plane report, its launches, and rank
    0's chat transcript."""
    import contextlib
    import io

    from dllama_tpu_torch import cli, kernels

    args = cli.build_parser().parse_args(argv)
    out = io.StringIO()
    keep = turns is not None and group.rank == 0
    if keep:
        sys.stdin = io.StringIO(turns)
    kernels.reset_launches()
    with contextlib.redirect_stdout(out) if keep else contextlib.nullcontext():
        report = cli.run_tp_rank(group, args, 0, group.size)
    return {"report": report, "launches": dict(kernels.launches), "stdout": out.getvalue()}


def tail_streams(tail: list) -> dict:
    """Rank 0's control-plane tail read back into what the requests got:
    "windows", one per pool session, {prompt length: token ids} of its rows
    (each handle's bursts from its admission on); "batches", each
    ``generate_batch``'s rows; "solo", each ``generate`` stream's tokens."""
    windows, batches, solo = [], [], []
    rows, live = None, {}
    for method, res in tail:
        if method == "batch_session":
            rows, live = {}, {}
        elif method in ("admit", "admit_begin") and isinstance(res, tuple):
            live[res[0]] = res[1]
            rows[res[1]] = []
        elif method == "step_chunk" and isinstance(res, list):
            for h, burst in res:
                rows[live[h]].extend(burst)
        elif method == "close" and rows is not None:
            windows.append(rows)
            rows = None
        elif method == "generate_batch" and isinstance(res, list):
            batches.append(res)
        elif method == "generate":
            solo.append([])
        elif method == "__next__" and isinstance(res, int):
            solo[-1].append(res)
    return {"windows": windows, "batches": batches, "solo": solo}


def p10e_reference(eng, prompts: list, stop: tuple) -> dict:
    """What one device answers 10e's wave: each prompt's rows through the
    server's pool (P10E_POOL, every row admitted, then stepped), by prompt
    length."""
    sess = eng.batch_session(P10E_POOL["max_batch"], chunk=P10E_POOL["chunk"])
    plen = {sess.admit(p, P10E_TOKENS, stop_tokens=stop): len(p) for p in prompts}
    rows = {n: [] for n in plen.values()}
    while not all(sess.is_done(h) for h in plen):
        for h, burst in sess.step_chunk().items():
            rows[plen[h]].extend(burst)
    sess.close()
    return rows


def p10e_client(port: int, wave: list, n2: dict, cancel: dict, companion: dict, last: dict,
                stop) -> dict:
    """10e's requests, once the server is ready: the wave at once, the n = 2
    request, and unless ``cancel`` is None a stream cancelled after two
    content events beside a companion in one window, then one more request
    (solo). ``stop``: an Event set when the server's ranks returned."""
    import http.client
    import threading

    t0 = time.perf_counter()
    while http_get_safe(port, "/ready") != 200:
        if stop.is_set() or time.perf_counter() - t0 > 600:
            raise RuntimeError("the TP server never became ready")
        time.sleep(0.5)
    out = {"ready_s": time.perf_counter() - t0}
    out["wave"], out["wave_s"] = send_wave(port, wave)
    out["n2"] = http_chat(port, n2)
    if cancel is None:
        return out
    seen = {}

    def cancelled():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(cancel),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        seen["status"], events = resp.status, 0
        while events < 2:
            line = resp.readline()
            if not line:
                break
            events += line.startswith(b"data: {") and b'"content"' in line
        seen["events"] = events
        conn.close()  # the client goes away mid-stream

    side = {}
    threads = [threading.Thread(target=cancelled),
               threading.Thread(target=lambda: side.update(http_chat(port, companion)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["cancelled"], out["companion"] = seen, side
    t1 = time.perf_counter()
    while True:  # the cancelled row's pool drains: the next request goes solo
        info = json.loads(http_get(port, "/ready")[1])
        if info["slots_occupied"] == 0 and info["inflight"] == 0:
            break
        if time.perf_counter() - t1 > 300:
            raise RuntimeError(f"the pool never drained after the cancel: {info}")
        time.sleep(0.2)
    out["last"] = http_chat(port, last)
    return out


def http_get_safe(port: int, path: str) -> int:
    try:
        return http_get(port, path)[0]
    except OSError:
        return 0


def serve_on(world, argv: list, client) -> tuple:
    """``tp_serve_rank`` on every rank of ``world`` while ``client(port)``
    sends requests from a thread of this process; SIGTERM to rank 0 ends the
    server. Returns (the ranks' results, the client's)."""
    import signal
    import threading

    done, got = threading.Event(), {}

    def run_client():
        try:
            got["out"] = client(done)
        except BaseException as e:  # noqa: BLE001 — reported below
            got["error"] = repr(e)
        finally:
            try:
                os.kill(world.pids[0], signal.SIGTERM)
            except ProcessLookupError:
                pass

    th = threading.Thread(target=run_client, daemon=True)
    th.start()
    try:
        ranks = world.run(tp_serve_rank, argv)
    finally:
        done.set()
        th.join(600)
    if "error" in got:
        fail(f"10e: the client failed: {got['error']}")
    return ranks, got["out"]


def op_share(times: dict, method: str) -> dict:
    """ms per call of ``method`` on rank 0 and the op channel's share of it."""
    n, sent, total = times.get(method, (0, 0.0, 0.0))
    return {"calls": n, "ms": total * 1e3 / n if n else None,
            "channel_ms": sent * 1e3 / n if n else None,
            "channel_share": sent / total if total else None}


def p10e_worlds(dev, nccl: bool) -> dict:
    """10e's worlds, started early so that their ranks boot while phase 10
    runs: "a" one NCCL rank (None without ``nccl``), "b" two gloo ranks."""
    from dllama_tpu_torch.parallel.group import LocalWorld

    return {"a": LocalWorld(1, backend="nccl", devices=[dev], timeout_s=900) if nccl else None,
            "b": LocalWorld(2, backend="gloo", devices=[dev] * 2, timeout_s=900)}


def phase10e(torch, dev, path: Path, tok_path: Path, solo, worlds: dict) -> dict:
    """``serve`` and ``chat`` under TP through the rank function
    ``cli.run_tp_rank`` calls (``LocalWorld``: the card takes no second NCCL
    rank), on phase 10's Llama-3-8B-width Q40 file and the serving
    tokenizer. Rank 0 binds a port; this process sends the requests. (a) A
    one-rank NCCL world: a wave of 4 greedy requests of 32 tokens and an n
    = 2 request, bit-equal to one device (``solo``: the uniform pool of
    P10E_POOL and ``generate_batch``). (b) gloo tp 2, both ranks on this
    card: the same, each row equal to one device's or parting at a near
    tie; every rank's results equal rank 0's (the control plane's digests);
    a stream cancelled mid-way, and a request after it answered (solo: per
    token ops); the kernels of the path launched. (c) A two-turn chat at
    gloo tp 2: one device's transcript. Figures are gloo over one card, not
    TP speed. ``worlds``: :func:`p10e_worlds`'s, which phase 10f uses next
    and :func:`phase10` closes."""
    from dllama_tpu_torch.serving import api_server
    from dllama_tpu_torch.serving.templates import render_llama3_chat
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    out: dict = {"card": gpu_line(), "note": "gloo over one card, not TP speed"}
    tok = Tokenizer.from_file(str(tok_path))
    stop = (tok.eos_id,)
    msgs = wave_prompts(12, seed=10)
    prompts, texts = [], []
    for m in msgs:  # four prompts of distinct lengths: the tail keys rows by length
        p = tok.encode(render_llama3_chat([{"role": "user", "content": m}]), add_bos=True)
        if len(p) not in {len(q) for q in prompts} and len(prompts) < 4:
            prompts.append(p)
            texts.append(m)
    want = p10e_reference(solo, prompts, stop)
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    n2_prompts, n2_steps = api_server.padded_batch([prompts[0]] * 2, [P10E_SHORT] * 2)
    greedy = [SamplerConfig(temperature=0.0, seed=0)] * len(n2_prompts)
    want_n2 = solo.generate_batch(n2_prompts, P10E_SHORT, samplers=greedy, stop_tokens=stop,
                                  row_steps=n2_steps)

    def body(text, tokens=P10E_SHORT, **kw):
        return {"messages": [{"role": "user", "content": text}], "max_tokens": tokens,
                "temperature": 0.0, **kw}

    def client_for(port, cancel: bool):
        return lambda done: p10e_client(
            port, [body(t, P10E_TOKENS) for t in texts], body(texts[0], n=2),
            body(texts[1], 2 * P10E_TOKENS, stream=True) if cancel else None, body(texts[2]),
            body(texts[3]), done)

    def check(what, ranks, http, exact) -> dict:
        r0 = ranks[0]["report"]
        got = tail_streams(r0["tail"])
        wave = {}  # each wave prompt's rows: the first window that held it
        for w in got["windows"]:
            wave = {**w, **wave}
        res = {"in_step": r0["in_step"] and all(r["report"]["in_step"] for r in ranks),
               "digests": r0["ranks"], "statuses": [w["status"] for w in http["wave"]],
               "wave_s": http["wave_s"], "rows": {}, "launches": ranks[0]["launches"],
               "per_token": op_share(r0["times"], "__next__"),
               "per_chunk": op_share(r0["times"], "step_chunk"),
               "per_batch": op_share(r0["times"], "generate_batch"),
               "ops": {m: v[0] for m, v in r0["times"].items()}}
        ok = res["in_step"] and res["statuses"] == [200] * 4
        for p in prompts:
            g, w = wave.get(len(p), []), want[len(p)]
            tie = near_tie(solo, p, w, g) if g != w else {"equal": True}
            res["rows"][len(p)] = tie
            ok &= tie["equal"] or (not exact and tie.get("near_tie", False))
        for resp, p in zip(http["wave"], prompts):  # the text is the rows' text
            text, _, _ = api_server.decode_token_row(tok, p[-1], wave.get(len(p), []), stop, [])
            ok &= resp["json"]["choices"][0]["message"]["content"] == text
        n2 = got["batches"][0] if got["batches"] else None
        res["n2"] = {"status": http["n2"]["status"], "equal": n2 == want_n2}
        if n2 != want_n2 and n2 is not None:
            res["n2"]["tie"] = near_tie(solo, n2_prompts[0], want_n2[0], n2[0])
        ok &= http["n2"]["status"] == 200 and (n2 == want_n2 or (
            not exact and res["n2"].get("tie", {}).get("near_tie", False)))
        log(f"  10e{what}: ranks in step: {res['in_step']} (digests {res['digests']}); wave of 4 "
            f"x {P10E_TOKENS} tokens in {http['wave_s']:.2f} s, statuses {res['statuses']}, rows "
            f"= one device's: {[v['equal'] for v in res['rows'].values()]} "
            f"{'' if exact else '(or near ties: ' + str(res['rows']) + ')'}; n = 2 through "
            f"generate_batch = one device's: {res['n2']}; ops {res['ops']}")
        for k in ("per_chunk", "per_batch", "per_token"):
            v = res[k]
            if v["calls"]:
                log(f"    {k.replace('_', ' ')}: {v['ms']:.3f} ms, of which the op channel "
                    f"{v['channel_ms']:.4f} ms ({v['channel_share']:.5f}) over {v['calls']} "
                    f"calls ({out['note']}; {out['card']})")
        if not ok:
            fail(f"10e{what}: the TP server's answers part from one device's or the ranks "
                 f"parted: {res}")
        return res

    base = ["--model", str(path), "--tokenizer", str(tok_path)]
    if worlds["a"] is not None:  # (a) one rank, NCCL
        port = free_ports(1)
        ranks, http = serve_on(worlds["a"], ["serve", *base, *P10E_SERVE, "--port", str(port)],
                               client_for(port, cancel=False))
        out["a"] = check("a one-rank NCCL", ranks, http, exact=True)
        torch.cuda.empty_cache()
    # (b), (c) gloo, two ranks on this card
    world = worlds["b"]
    port = free_ports(1)
    ranks, http = serve_on(world, ["serve", *base, *P10E_SERVE, "--port", str(port)],
                           client_for(port, cancel=True))
    res = check("b gloo tp 2", ranks, http, exact=False)
    got = tail_streams(ranks[0]["report"]["tail"])
    cancel_ops = res["ops"].get("cancel", 0)
    res["cancel"] = {"events_read": http["cancelled"].get("events"), "cancel_ops": cancel_ops,
                     "companion": http["companion"]["status"],
                     "after": http["last"]["status"], "solo_tokens": got["solo"]}
    log(f"  10e b: a stream cancelled after {res['cancel']['events_read']} content events "
        f"({cancel_ops} cancel ops), its companion {http['companion']['status']}, the next "
        f"request {http['last']['status']} (solo, {len(got['solo'][-1]) if got['solo'] else 0}"
        f" tokens); launches {res['launches']}")
    if not (cancel_ops >= 1 and http["companion"]["status"] == 200
            and http["last"]["status"] == 200 and got["solo"]):
        fail(f"10e b: the cancel or the request after it went wrong: {res['cancel']}")
    for k in ("q40_matmul", "flash_decode", "rope_cache_update", "flash_decode_batched",
              "rope_cache_update_batched"):
        if not res["launches"].get(k):
            fail(f"10e b: {k} never launched in the TP server's run")
    out["b"] = res

    # (c) chat, against one device's transcript of the same turns
    import contextlib
    import io

    from dllama_tpu_torch import cli as tcli

    argv = ["chat", *base, *P10E_CHAT]
    ranks = world.run(tp_serve_rank, argv, P10E_TURNS)
    args = tcli.build_parser().parse_args(argv)
    saved, buf = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO(P10E_TURNS)
    try:
        with contextlib.redirect_stdout(buf):
            tcli._chat(args, solo, tok, solo.cfg)
    finally:
        sys.stdin = saved

    def replies(text):  # the transcript from the first turn to the end of input
        text = text[text.find("👱 User:"):].split("🔗 control plane")[0]
        return text.splitlines()

    r0 = ranks[0]["report"]
    out["c"] = {"replies": replies(ranks[0]["stdout"]), "want": replies(buf.getvalue()),
                "in_step": r0["in_step"], "per_token": op_share(r0["times"], "__next__"),
                "launches": ranks[0]["launches"]}
    pt = out["c"]["per_token"]
    log(f"  10e c: two-turn chat at gloo tp 2 = one device's: "
        f"{out['c']['replies'] == out['c']['want']}; "
        f"ranks in step: {r0['in_step']}; {pt['ms']:.3f} ms a token, of which the op channel "
        f"{pt['channel_ms']:.4f} ms ({pt['channel_share']:.5f}) ({out['note']}; "
        f"{out['card']})")
    if not (sum("Assistant:" in ln for ln in out["c"]["replies"]) == 2
            and out["c"]["replies"] == out["c"]["want"]
            and r0["in_step"]):
        fail(f"10e c: the TP chat parts from one device's: {out['c']}")
    return out


#: phase 10f: greedy tokens of its solo generate_spec (after the prefill's),
#: of its paged row, and the draft length
P10F_STEPS = 32
P10F_ROW_STEPS = 24
P10F_DRAFT = 8
#: phase 10f's paged sessions: 16-token pages, chunks of 8
P10F_POOL = dict(max_batch=2, chunk=8, kv_pages=16)


def p10f_drive(eng, prompt: list, batch_prompts: list) -> dict:
    """Phase 10f's calls on ``eng`` (rank 0's ``TPEngine``, or the solo
    engine): greedy ``generate_spec`` of P10F_STEPS tokens at draft 8 and
    ``generate_batch_spec`` of the B = 4 ``batch_prompts`` (TP_BATCH_STEPS
    tokens a row), their kernel launches counted from 0; then a paged row
    of P10F_ROW_STEPS tokens exported after one chunk and decoded to its end
    in place ("kept"), and its snapshot imported into a fresh session and
    decoded to its end ("rest")."""
    from dllama_tpu_torch import kernels

    def drain(sess, h) -> list:
        toks = []
        while not sess.is_done(h):
            toks.extend(sess.step_chunk().get(h, []))
        return toks

    kernels.reset_launches()
    t0 = time.perf_counter()
    solo = [t for t, _ in eng.generate_spec(prompt, P10F_STEPS, draft_len=P10F_DRAFT)]
    t1 = time.perf_counter()
    rows, stats = eng.generate_batch_spec(batch_prompts, TP_BATCH_STEPS, draft_len=P10F_DRAFT)
    t2 = time.perf_counter()
    launches = dict(kernels.launches)
    sess = eng.batch_session(**P10F_POOL)
    h = sess.admit(prompt, P10F_ROW_STEPS)
    first = sess.step_chunk().get(h, [])
    t3 = time.perf_counter()
    snap = sess.export_row(h)
    export_s = time.perf_counter() - t3
    kept = first + drain(sess, h)
    sess.close()
    sess = eng.batch_session(**P10F_POOL)
    t4 = time.perf_counter()
    h = sess.admit_from_export(prompt, snap)
    import_s = time.perf_counter() - t4
    rest = drain(sess, h)
    sess.close()
    return {"solo": solo, "solo_s": t1 - t0, "rows": rows, "stats": stats, "batch_s": t2 - t1,
            "launches": launches, "first": first, "snap": snap, "kept": kept, "rest": rest,
            "export_s": export_s, "import_s": import_s}


def p10f_rank(group, path: str, prompt: list, batch_prompts: list) -> dict:
    """One rank of phase 10f: its shard of the `.m` file at ``path`` (bf16
    cache, eager); rank 0 runs :func:`p10f_drive` over the control plane and
    every other rank follows (``control.lead``). Returns the rank's
    control-plane report, and rank 0's drive."""
    import torch

    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.parallel import control
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    with WeightFileReader(path) as reader:
        cfg = ModelConfig.from_spec(reader.spec, dtype="bfloat16")
        params = llama.quant_params_from_reader(reader, cfg, group.device, "q40", tp=group)
    eng = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                 cache_dtype=torch.bfloat16, tp=group, metrics=None)
    del params
    box: dict = {}
    report = control.lead(eng, group, lambda plane: box.update(
        p10f_drive(plane, prompt, batch_prompts)))
    return {"report": report, **box}


def phase10f_rope(torch, dev, gen) -> list:
    """K5's verify form at a tensor-parallel rank's heads (tp 2: 16 q heads
    and 4 kv heads; tp 4: 8 and 2), B = 4 sequences of T = 9 rows (draft 8,
    timed) and 16, against its plain version bit for bit."""
    from dllama_tpu_torch.ops import fused_rope_cache

    H, kv, hd = ROPE_HEADS
    L, S = 8, 1024
    rows = []
    for tp in (2, 4):
        heads = (H // tp, kv // tp, hd)
        cases = [((4, T), [0, 116, S - T, S + 5], (L, 4, S, kv // tp, hd))
                 for T in (9, fused_rope_cache.MAX_T)]
        for r in rope_launches(torch, dev, gen, "verify", cases, 0, heads=heads):
            rows.append({**r, "tp": tp, "heads": list(heads)})
    return rows


def phase10f(torch, dev, path: Path, solo, worlds: dict, prompt: list,
             batch_prompts: list) -> dict:
    """Speculative decoding and row moves under TP on phase 10's
    Llama-3-8B-width Q40 file, through :func:`p10e_worlds`'s worlds and the
    control plane (:func:`p10f_rank`). (a) One NCCL rank: solo
    ``generate_spec`` and ``generate_batch_spec`` (draft 8, B = 4), the
    exported snapshot and both continuations bit-equal to one device's. (b)
    gloo tp 2 on this card: every rank in step (the control plane's
    digests); the streams equal one device's or part at a near tie; a row
    exported at tp 2 continues exactly when imported at tp 2, and equal or
    parting at a near tie when imported on one device. The kernels of the
    path launched. Times are gloo over one card, not TP speed."""
    import numpy as np

    out: dict = {"card": gpu_line() if dev.type == "cuda" else "cpu",
                 "note": "gloo over one card, not TP speed"}
    want = p10f_drive(solo, prompt, batch_prompts)
    out["one"] = {k: want[k] for k in ("solo", "rows", "stats", "kept", "solo_s", "batch_s")}

    def verdict(got, ref, p, exact) -> dict:
        if got == ref:
            return {"equal": True}
        tie = near_tie(solo, p, ref, got)
        tie["ok"] = not exact and tie.get("near_tie", False)
        return tie

    for name, exact in (("a", True), ("b", False)):
        world = worlds.get(name)
        if world is None:
            continue
        what = "one-rank NCCL" if name == "a" else "gloo tp 2"
        ranks = world.run(p10f_rank, str(path), prompt, batch_prompts)
        r0 = ranks[0]
        snap = r0["snap"]
        sess = solo.batch_session(**P10F_POOL)  # the row imported on one device
        h = sess.admit_from_export(prompt, snap)
        on_one = []
        while not sess.is_done(h):
            on_one.extend(sess.step_chunk().get(h, []))
        sess.close()
        res = {"in_step": r0["report"]["in_step"] and all(
                   r["report"]["in_step"] for r in ranks),
               "digests": r0["report"]["ranks"], "launches": r0["launches"],
               "stats": r0["stats"], "solo_s": r0["solo_s"], "batch_s": r0["batch_s"],
               "export_s": r0["export_s"], "import_s": r0["import_s"],
               "ops": {m: v[0] for m, v in r0["report"]["times"].items()},
               "spec": verdict(r0["solo"], want["solo"], prompt, exact),
               "batch": [verdict(g, w, p, exact)
                         for g, w, p in zip(r0["rows"], want["rows"], batch_prompts)],
               "kept": verdict(r0["kept"], want["kept"], prompt, exact),
               "import_here": r0["first"] + r0["rest"] == r0["kept"],
               "import_one": verdict(r0["first"] + on_one, r0["kept"], prompt, exact),
               "snap_err": max(float(np.abs(a - b).max())
                               for a, b in zip(snap["leaves"], want["snap"]["leaves"]))}
        if exact:
            res["snap_bit_equal"] = all(np.array_equal(a, b) for a, b in
                                        zip(snap["leaves"], want["snap"]["leaves"]))
        ok = (res["in_step"] and res["import_here"] and res.get("snap_bit_equal", True)
              and all(v["equal"] or v["ok"] for v in
                      (res["spec"], *res["batch"], res["kept"], res["import_one"])))
        log(f"  10f{name} {what}: ranks in step: {res['in_step']} (digests {res['digests']}); "
            f"generate_spec = one device's: {res['spec']}; generate_batch_spec rows: "
            f"{res['batch']}; paged row: {res['kept']}; its export imported at the same tp "
            f"continues exactly: {res['import_here']}, on one device: {res['import_one']}; "
            f"snapshot max |diff| from one device's {res['snap_err']:.3g}"
            + (f" (bit-equal: {res['snap_bit_equal']})" if exact else "")
            + f"; ops {res['ops']}; launches {res['launches']}")
        log(f"    generate_spec {P10F_STEPS + 1} tokens in {res['solo_s']:.2f} s, "
            f"generate_batch_spec B = 4 in {res['batch_s']:.2f} s ({res['stats']}), export "
            f"{res['export_s'] * 1e3:.1f} ms, import {res['import_s'] * 1e3:.1f} ms "
            f"({out['note']}; {out['card']})")
        if not ok:
            fail(f"10f{name} {what}: speculative decoding or a row move under TP parts from "
                 f"one device, or the ranks parted: {res}")
        for k in ("q40_matmul", "flash_decode", "rope_cache_update", "rope_cache_update_verify"):
            if not res["launches"].get(k):
                fail(f"10f{name}: {k} never launched in the speculative run")
        out[name] = res
    return out


#: phase 10g: K1's and K3's row shards of wo and w2 (``--tp-reduce``): (matrix,
#: K at tp 2, K at tp 4, O, launches per token) of the Llama-3-8B shape
ROW_WIDTHS = [("wo", 2048, 1024, 4096, 32), ("w2", 7168, 3584, 4096, 32)]
#: their row counts: decode steps at B = 1, 4 and 8, verify steps of 9, 16, 72
ROW_WIDTH_T = (1, 4, 8, 9, 16, 72)
#: phase 10g's modes: (name, --tp-reduce, --tp-overlap)
P10G_MODES = [("row plain", "plain", False), ("row q80", "q80", False),
              ("overlap", "off", True), ("row plain + overlap", "plain", True)]
#: 10g(a)'s modes at the one NCCL rank: the overlap's interleave over NCCL's
#: asynchronous all-gathers, alone and with the row programs
P10G_NCCL_MODES = [("overlap", "off", True), ("row q80 + overlap", "q80", True)]
#: 10g: solo greedy tokens, the paged wave's pool, the one-rank CLI's prompt
P10G_STEPS = 16
P10G_POOL = dict(max_batch=4, chunk=8, kv_pages=32)
P10G_TEXT = "Tell me about the ocean and the tides"


def phase10g_widths(torch, dev, gen) -> list:
    """K1 and K3 on the row shards a ``--tp-reduce`` rank launches (wo: K
    2048 / 1024, w2: K 7168 / 3584, O 4096 at tp 2 / 4), at the decode rows
    1, 4, 8 and the verify rows 9, 16, 72 (:func:`time_width`)."""
    rows = []
    for kind in ("q40", "q80"):
        for name, k2, k4, O, per_token in ROW_WIDTHS:
            for tp, K in ((2, k2), (4, k4)):
                rows += time_width(torch, dev, gen, kind, name, tp, K, O, ROW_WIDTH_T,
                                   per_token)
        torch.cuda.empty_cache()
    return rows


def phase10g_halves(torch, dev, gen) -> list:
    """K4 and K5 launched on half a batch (``row0``): a tp 2 rank's heads (16
    q, 4 kv, hd 128), B = 4 rows of a [4, 4, 1024, 4, 128] cache, bf16 and
    f8. K5's batched form over rows [0, 2) and [2, 4) must write the caches
    and rotate q as its one launch over all four rows does, bit for bit, and
    K4 over each half must give the full launch's rows, bit for bit; the
    verify form (T = 9) likewise. Each half launch timed beside the full
    one."""
    from dllama_tpu_torch.ops import flash_decode, fused_rope_cache
    from dllama_tpu_torch.ops.rope import rope_table

    H, kv, hd, B, L, S, T = 16, 4, 128, 4, 4, 1024, 9
    cos, sin = (torch.from_numpy(t).to(dev) for t in rope_table(S, hd, 500000.0))
    pos = torch.tensor([0, 116, 1000, S - 1], dtype=torch.int32, device=dev)
    halves = ((0, 2), (2, 4))
    rows = []
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        base = (torch.randn((L, B, S, kv, hd), device=dev, generator=gen) * 0.5)
        caches = [(base.to(dtype), (base * 0.7).to(dtype)) for _ in range(2)]
        q, k, v = (torch.randn((B, n, hd), device=dev, generator=gen).to(torch.bfloat16)
                   for n in (H, kv, kv))
        (fk, fv), (hk, hv) = caches
        q_full = fused_rope_cache.rope_cache_update_batched(q, k, v, cos, sin, fk, fv, pos, 1)
        q_half = torch.cat([fused_rope_cache.rope_cache_update_batched(
            q[a:b], k[a:b], v[a:b], cos, sin, hk, hv, pos[a:b], 1, row0=a) for a, b in halves])
        o_full = flash_decode.flash_decode_attention_batched(q_full, fk, fv, pos, 1)
        o_half = torch.cat([flash_decode.flash_decode_attention_batched(
            q_full[a:b], hk, hv, pos[a:b], 1, row0=a) for a, b in halves])
        qv, kv_, vv = (torch.randn((B, T, n, hd), device=dev, generator=gen).to(torch.bfloat16)
                       for n in (H, kv, kv))
        vpos = torch.tensor([0, 116, 900, S - T], dtype=torch.int32, device=dev)
        qv_full = fused_rope_cache.rope_cache_update_verify(qv, kv_, vv, cos, sin, fk, fv, vpos,
                                                            2)
        qv_half = torch.cat([fused_rope_cache.rope_cache_update_verify(
            qv[a:b], kv_[a:b], vv[a:b], cos, sin, hk, hv, vpos[a:b], 2, row0=a)
            for a, b in halves])
        torch.cuda.synchronize(dev)
        equal = {"k5_batched_q": torch.equal(q_half, q_full),
                 "k4_batched": torch.equal(o_half, o_full),
                 "k5_verify_q": torch.equal(qv_half, qv_full),
                 "caches": all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                               for a, b in ((fk, hk), (fv, hv)))}
        r = {"cache": str(dtype), "bit_equal": equal,
             "k4_full_ms": time_ms(torch, lambda: flash_decode.flash_decode_attention_batched(
                 q_full, fk, fv, pos, 1)),
             "k4_half_ms": time_ms(torch, lambda: flash_decode.flash_decode_attention_batched(
                 q_full[2:], fk, fv, pos[2:], 1, row0=2)),
             "k5_full_ms": time_ms(torch, lambda: fused_rope_cache.rope_cache_update_batched(
                 q, k, v, cos, sin, fk, fv, pos, 1)),
             "k5_half_ms": time_ms(torch, lambda: fused_rope_cache.rope_cache_update_batched(
                 q[2:], k[2:], v[2:], cos, sin, fk, fv, pos[2:], 1, row0=2))}
        rows.append(r)
        log(f"  10g K4/K5 half-batch launches ({dtype} cache, B = 4 as 2 + 2, tp 2 heads): "
            f"bit-equal to the full launch: {equal}; K4 {r['k4_half_ms']:.4f} ms a half "
            f"({r['k4_full_ms']:.4f} whole), K5 {r['k5_half_ms']:.4f} ({r['k5_full_ms']:.4f})")
        if not all(equal.values()):
            fail(f"10g: a half-batch K4/K5 launch differs from the full launch: {equal}")
    return rows


def p10g_drive(eng, prompt: list, batch_prompts: list, spec: bool = True) -> dict:
    """10g's calls on one engine (greedy): ``generate`` of P10G_STEPS tokens
    (and the kB sent each), ``generate_batch`` (TP_BATCH_STEPS), one
    ``generate_batch_spec`` (draft 8; with ``spec`` False the error it
    raises instead) and a paged wave (every prompt admitted, then stepped to
    its end), each's kernel launches counted."""
    from dllama_tpu_torch import kernels

    out: dict = {"launches": {}}
    kernels.reset_launches()
    t0 = time.perf_counter()
    stream = list(eng.generate(prompt, P10G_STEPS))
    out["solo_s"] = time.perf_counter() - t0
    out["solo"] = [t for t, _ in stream]
    out["kb_per_token"] = statistics.median(st.sent_kb for _, st in stream[1:])
    out["ms_per_token"] = statistics.median(st.generation_ms for _, st in stream[1:])
    out["launches"]["solo"] = dict(kernels.launches)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out["batch"] = eng.generate_batch(batch_prompts, TP_BATCH_STEPS)
    out["batch_s"] = time.perf_counter() - t0
    out["launches"]["batch"] = dict(kernels.launches)
    kernels.reset_launches()
    if spec:
        out["spec"] = eng.generate_batch_spec(batch_prompts, TP_BATCH_STEPS,
                                              draft_len=P10F_DRAFT)[0]
    else:
        try:
            eng.generate_batch_spec(batch_prompts, TP_BATCH_STEPS, draft_len=P10F_DRAFT)
            out["spec"] = "ran"
        except ValueError as e:
            out["spec"] = str(e)
    out["launches"]["spec"] = dict(kernels.launches)
    kernels.reset_launches()
    sess = eng.batch_session(**P10G_POOL)
    hs = [sess.admit(p, TP_BATCH_STEPS) for p in batch_prompts]
    rows = {h: [] for h in hs}
    while not all(sess.is_done(h) for h in hs):
        for h, toks in sess.step_chunk().items():
            rows[h].extend(toks)
    sess.close()
    out["paged"] = [rows[h] for h in hs]
    out["launches"]["paged"] = dict(kernels.launches)
    return out


def p10g_rank(group, path: str, prompt: list, batch_prompts: list, modes: list) -> dict:
    """One rank of phase 10g: for each (name, tp_reduce, tp_overlap) of
    ``modes`` an engine on this rank's shard (row-packed for the row modes;
    kept between engines, :func:`rank_params`) runs :func:`p10g_drive`; the
    two counters and the ``tp_reduce``/``overlap_split`` seams (armed with a
    zero delay, so they only count) say what served it."""
    import torch

    from dllama_tpu_torch import faults
    from dllama_tpu_torch.observability import MetricsRegistry
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    out = {}
    for name, reduce_, overlap in modes:
        cfg, params = rank_params(group, path, reduce_ != "off")
        reg = MetricsRegistry()
        eng = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                     cache_dtype=torch.bfloat16, tp=group, metrics=reg, tp_reduce=reduce_,
                     tp_overlap=overlap)
        plan = faults.install("tp_reduce:slow:delay_ms=0;overlap_split:slow:delay_ms=0")
        try:
            res = p10g_drive(eng, prompt, batch_prompts)
        finally:
            faults.clear()
        counts = {ln.split()[0]: float(ln.split()[-1]) for ln in reg.render().splitlines()
                  if ln.startswith(("dllama_tp_overlap_chunks_total",
                                    "dllama_tp_reduce_chunks_total"))}
        res.update(resolved=[eng.tp_reduce, eng.tp_reduce_active, eng.tp_overlap_active],
                   counts=counts, seams={k: v[1] for k, v in plan.counters().items()})
        out[name] = res
        del eng
    return out


def phase10g(torch, dev, path: Path, tok_path: Path, solo, world, worlds: dict,
             prompt: list, batch_in: list, gather_kb: float) -> dict:
    """``--tp-reduce`` and ``--tp-overlap`` under TP on phase 10's
    Llama-3-8B-width Q40 file (all 32 layers). (a) One NCCL rank: ``cli
    generate --tp-reduce q80 --tp-overlap`` through ``cli.run_tp_rank``
    (its 🔗 line names both modes; its tokens against one device's: at one
    rank the reduce-scatter is the identity, so q80 runs plain's programs,
    and a solo stream never splits); then :func:`p10g_drive` at that rank
    for the overlap alone and with the q80 row programs (P10G_NCCL_MODES:
    the batched, speculative and paged paths, whose halves wait on NCCL's
    asynchronous all-gathers), each against one device. (b) gloo tp 2 on this
    card, the four modes: every rank's streams equal (in step), each equal
    to one device's or parting at a near tie (:func:`near_tie`); the
    counters and seams fired; the kB sent a decode token beside the
    gather-only figure and the JAX package's analytic count. Not bit-equal
    to one device, and why: the row modes' norm epilogue rounds x·inv to
    bf16 before the gather (JAX's order) where rmsnorm rounds once; q80 hops
    quantize; the overlap's halves run K1 at half the rows, another split
    plan. Times are gloo over one card, not TP speed."""
    from dllama_tpu_torch.ops.qmatmul import _pad_up
    from dllama_tpu_torch.parallel import quant_tp
    from dllama_tpu_torch.runtime import generate as tg
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    out: dict = {"card": gpu_line() if dev.type == "cuda" else "cpu",
                 "note": "gloo over one card, not TP speed"}
    want = p10g_drive(solo, prompt, batch_in)
    out["one"] = {k: want[k] for k in ("solo", "batch", "spec", "paged", "solo_s", "batch_s")}
    cfg = solo.cfg

    def verdict(got, ref, p) -> dict:
        if got == ref:
            return {"equal": True}
        tie = near_tie(solo, p, ref, got)
        tie["ok"] = tie.get("near_tie", False)
        return tie

    def streams(res: dict) -> dict:
        return {"solo": verdict(res["solo"], want["solo"], prompt),
                **{k: [verdict(g, w, p) for g, w, p in zip(res[k], want[k], batch_in)]
                   for k in ("batch", "spec", "paged")}}

    def ok(v) -> bool:
        return all(ok(x) for x in v.values()) if isinstance(v, dict) and "equal" not in v \
            else all(ok(x) for x in v) if isinstance(v, list) else v["equal"] or v["ok"]

    # (a) one NCCL rank, the CLI with both flags, runs in its own process
    # while (b)'s gloo ranks run their modes
    nccl = worlds.get("a")
    if nccl is not None:
        tok = Tokenizer.from_file(str(tok_path))
        ids = tok.encode(P10G_TEXT, add_bos=True)
        ref = solo.generate_fused(ids, P10G_STEPS, stop_tokens=(tok.eos_id,))[0]
        argv = ["generate", "--model", str(path), "--tokenizer", str(tok_path), "--prompt",
                P10G_TEXT, "--steps", str(P10G_STEPS), "--temperature", "0", "--seed", "0",
                "--dtype", "bfloat16", "--weights-float-type", "q40", "--tp-reduce", "q80",
                "--tp-overlap"]
    def nccl_job():
        cli_ranks = nccl.run(tp_serve_rank, argv, "")
        drives = nccl.run(p10g_rank, str(path), prompt, batch_in, P10G_NCCL_MODES)
        nccl.run(p10_release)
        return cli_ranks, drives[0]

    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(nccl_job) if nccl is not None else None
        ranks = world.run(p10g_rank, str(path), prompt, batch_in, P10G_MODES, size=2)
        world.run(p10_release)
        cli_ranks, nccl_drives = job.result() if job is not None else (None, None)
    if cli_ranks is not None:
        r0 = cli_ranks[0]
        line = next((ln for ln in r0["stdout"].splitlines() if ln.startswith("🔗")), "")
        got = [int(t) for t in next(ln for ln in r0["stdout"].splitlines()
                                    if ln.startswith("Token ids:")).split(":", 1)[1].split()]
        cli_res = {"line": line, "tokens": verdict(got, ref, ids),
                   "launches": r0["launches"]}
        log(f"  10g(a) one-rank NCCL `cli generate --tp-reduce q80 --tp-overlap`: {line!r}; "
            f"tokens against one device's: {cli_res['tokens']}")
        if not ("microbatch overlap" in line and "row-parallel q80 reduce" in line
                and ok(cli_res["tokens"])):
            fail(f"10g(a): the one-rank CLI run: {cli_res}")
        out["a"] = {"cli": cli_res}
        # the batched, speculative and paged paths at the NCCL rank: the
        # overlap's halves wait on NCCL's asynchronous all-gathers; at one
        # rank the reduce-scatter is the identity. Not bit-equal to one
        # device where a half's K1 launches take another split plan.
        for name, reduce_, overlap in P10G_NCCL_MODES:
            r = nccl_drives[name]
            res = {"streams": streams(r), "counts": r["counts"], "seams": r["seams"],
                   "resolved": r["resolved"], "solo_s": r["solo_s"], "batch_s": r["batch_s"],
                   "launches": r["launches"]}
            out["a"][name] = res
            log(f"  10g(a) one-rank NCCL, {name}: streams {res['streams']}; counters "
                f"{res['counts']}, seams {res['seams']}; {P10G_STEPS} tokens in "
                f"{res['solo_s']:.2f} s, B = 4 x {TP_BATCH_STEPS} in {res['batch_s']:.2f} s")
            log(f"    launches {({k: {n: c for n, c in v.items() if c} for k, v in res['launches'].items()})}")
            fired_r = res["counts"].get("dllama_tp_reduce_chunks_total", 0) > 0 and \
                res["seams"].get("tp_reduce", 0) > 0
            fired_o = res["counts"].get("dllama_tp_overlap_chunks_total", 0) > 0 and \
                res["seams"].get("overlap_split", 0) > 0
            if not (ok(res["streams"]) and fired_o and fired_r == (reduce_ != "off")
                    and res["resolved"] == [reduce_, reduce_ != "off", True]):
                fail(f"10g(a) {name}: a stream parted off a near tie, or a counter or seam "
                     f"did not fire as the mode says: {res}")
            for k in ("flash_decode_batched", "rope_cache_update_batched"):
                if not res["launches"]["batch"].get(k):
                    fail(f"10g(a) {name}: {k} never launched in the batched run")
            if not res["launches"]["spec"].get("rope_cache_update_verify"):
                fail(f"10g(a) {name}: the verify form of K5 never launched")

    # (b) gloo tp 2, every mode
    for name, reduce_, overlap in P10G_MODES:
        r0, r1 = ranks[0][name], ranks[1][name]
        in_step = all(r0[k] == r1[k] for k in ("solo", "batch", "spec", "paged"))
        mode = reduce_ if reduce_ != "off" else None
        model_kb = tg.wire_bytes_per_row(cfg, "q40", 2, 2.0, mode) / 1024
        # the JAX engine's _wire_bytes(1) at tp 2: the stack, then the logits
        jax_kb = (tg.dense_stack_wire_feat_bytes(cfg, quant_tp.ffn_padded_width(cfg, "q40", 2),
                                                 2.0, mode)
                  + _pad_up(cfg.vocab_size, 256) * 4.0) * 0.5 / 1024
        res = {"in_step": in_step, "streams": streams(r0), "counts": r0["counts"],
               "seams": r0["seams"], "resolved": r0["resolved"],
               "kb_per_token": r0["kb_per_token"], "kb_model": model_kb,
               "kb_jax_analytic": jax_kb, "kb_gather_only": gather_kb,
               "solo_s": r0["solo_s"], "batch_s": r0["batch_s"], "launches": r0["launches"]}
        out[name] = res
        log(f"  10g(b) gloo tp 2, {name}: ranks in step: {in_step}; streams {res['streams']}; "
            f"counters {res['counts']}, seams {res['seams']}; {res['kb_per_token']:.3f} kB sent "
            f"a decode token (the port's count {model_kb:.3f}, JAX's analytic {jax_kb:.3f}, "
            f"gather-only {gather_kb:.3f}); {P10G_STEPS} tokens in {res['solo_s']:.2f} s, "
            f"B = 4 x {TP_BATCH_STEPS} in {res['batch_s']:.2f} s ({out['note']}; {out['card']})")
        log(f"    launches {({k: {n: c for n, c in v.items() if c} for k, v in res['launches'].items()})}")
        fired_r = res["counts"].get("dllama_tp_reduce_chunks_total", 0) > 0 and \
            res["seams"].get("tp_reduce", 0) > 0
        fired_o = res["counts"].get("dllama_tp_overlap_chunks_total", 0) > 0 and \
            res["seams"].get("overlap_split", 0) > 0
        if not (in_step and ok(res["streams"]) and fired_r == bool(mode)
                and fired_o == overlap and res["resolved"] == [reduce_, bool(mode), overlap]):
            fail(f"10g(b) {name}: ranks parted, a stream parted off a near tie, or a counter "
                 f"or seam did not fire as the mode says: {res}")
        if abs(res["kb_per_token"] - model_kb) > 1e-6 * model_kb:
            fail(f"10g(b) {name}: {res['kb_per_token']} kB a token, the count {model_kb}")
        batched = res["launches"]["batch"]
        for k in ("q40_matmul", "flash_decode_batched", "rope_cache_update_batched"):
            if not batched.get(k):
                fail(f"10g(b) {name}: {k} never launched in the batched run")
        if not res["launches"]["spec"].get("rope_cache_update_verify"):
            fail(f"10g(b) {name}: the verify form of K5 never launched")
    return out


#: phase 10h: greedy tokens of the dense runs' solo streams
P10H_STEPS = 16
#: phase 10h's ep grid: Mixtral-8x7B widths at 2 of its 32 layers, ep 2 x tp 2
P10H_MIXTRAL = {**MIXTRAL_8X7B, "n_layers": 2}
P10H_GRID = (2, 2)


def dense_digests(torch, record: list):
    """Spies on the dense forward's all-reduces and MoE routings: each
    reduced sum's bytes and each layer's picked experts, hashed into
    ``record`` (a host copy each: for a gate, never inside a timed run).
    Returns the function that takes the spies out again."""
    import hashlib

    from dllama_tpu_torch.models import llama, moe

    steps0, red0, route0 = llama.reduce_columns_steps, moe.reduce_columns, moe.route_topk

    def digest(t) -> None:
        record.append(hashlib.sha1(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                                   .tobytes()).hexdigest())

    def steps(partial, group):
        out = yield from steps0(partial, group)
        digest(out)
        return out

    def red(partial, group):
        out = red0(partial, group)
        digest(out)
        return out

    def route(*a):
        topi, w = route0(*a)
        digest(topi)
        return topi, w

    llama.reduce_columns_steps, moe.reduce_columns, moe.route_topk = steps, red, route

    def undo():
        llama.reduce_columns_steps, moe.reduce_columns, moe.route_topk = steps0, red0, route0

    return undo


def reduce_split(torch, eng, prompt: list, steps: int) -> dict:
    """Where a dense TP decode token's wall time goes: ``steps`` tokens of
    ``generate`` after ``prompt``, the host clock around each all-reduce
    (``reduce_columns``: its hops and gather, each waited on at once, so
    the time includes the wait for this rank's queued kernels) summed a
    token, beside the token's wall (medians over the decode tokens)."""
    from dllama_tpu_torch.models import llama

    steps0 = llama.reduce_columns_steps
    spent = [0.0]

    def timed(partial, group):
        t0 = time.perf_counter()
        out = yield from steps0(partial, group)
        spent[0] += time.perf_counter() - t0
        return out

    llama.reduce_columns_steps = timed
    walls, reduces = [], []
    try:
        for _, st in eng.generate(prompt, steps + 1):
            walls.append(st.generation_ms)
            reduces.append(spent[0] * 1e3)
            spent[0] = 0.0
    finally:
        llama.reduce_columns_steps = steps0
    return {"ms_per_token": statistics.median(walls[1:]),
            "reduce_ms_per_token": statistics.median(reduces[1:])}


def dense_file_params(torch, path: str, dev, tp=None) -> tuple:
    """(cfg, the bf16 dense params of the `.m` file at ``path``): this
    rank's column/row shards under ``tp``, the whole model without; read
    and dequantized on ``dev`` (``sharding.sharded_params_from_reader``)."""
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.parallel import sharding

    with WeightFileReader(path) as reader:
        cfg = ModelConfig.from_spec(reader.spec, dtype="bfloat16")
        return cfg, sharding.sharded_params_from_reader(reader, cfg, dev, torch.bfloat16, tp=tp)


def seeded_dense_params(torch, cfg, dev, seed: int, tp=None) -> dict:
    """Random dense params of the MoE ``cfg`` made on ``dev`` from ``seed``, one
    matrix at a time (N(0, 0.02) in the compute dtype; norms 1; an f32
    embedding): with ``tp`` (a grid's tp subgroup) every rank draws every
    matrix in the same order and keeps its block under
    ``sharding.param_specs``, so the ranks' shards cut the one-device
    model exactly."""
    from dllama_tpu_torch.parallel import sharding

    pos = sharding.group_position(tp)
    specs = sharding.checked_specs(cfg, pos[sharding.TP][1], pos[sharding.EP][1])
    lspecs = specs["layers"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D, H, E = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_experts

    def mat(spec, *shape, dtype=cfg.torch_dtype):
        full = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
        return sharding.cut_leaf(full, spec, pos)

    stacks: dict = {}

    def place(name, index, leaf, lead):
        if name not in stacks:
            stacks[name] = torch.empty((*lead, *leaf.shape), dtype=leaf.dtype, device=dev)
        stacks[name][index].copy_(leaf)

    shapes = {"wq": (D, D), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim), "wo": (D, D),
              "moe_router": (D, E), "moe_up": (D, H), "moe_gate": (D, H), "moe_down": (H, D)}
    e0, e1 = sharding.axis_bounds(E, lspecs["moe_up"][1], pos)
    for i in range(L):
        for n in ("wq", "wk", "wv", "wo", "moe_router"):
            place(n, (i,), mat(lspecs[n][1:], *shapes[n]), (L,))
        for n in ("moe_up", "moe_gate", "moe_down"):
            for e in range(E):  # every expert drawn, the rank's kept
                m = mat(lspecs[n][2:], *shapes[n])
                if e0 <= e < e1:
                    place(n, (i, e - e0), m, (L, e1 - e0))
    params = {"embedding": mat((None, None), cfg.vocab_size, D, dtype=torch.float32),
              "rms_final": torch.ones(D, device=dev),
              "wcls": mat(specs["wcls"], D, cfg.vocab_size),
              "layers": {n: torch.ones((L, D), device=dev) for n in lspecs
                         if n.startswith("rms_")}}
    params["layers"].update(stacks)
    return params


def p10h_nccl_rank(group, argv: list, prompt: list) -> dict:
    """10h(a), one NCCL rank: ``cli.load_engine`` on ``argv`` (a dense bf16
    ``generate`` command line: this rank's column/row shard of the file,
    all of it at one rank), the first decode step's logits after
    ``prompt``, then the CLI's generate on the same engine (its stdout
    kept, its launches counted)."""
    import contextlib
    import io

    import torch

    from dllama_tpu_torch import cli, kernels

    args = cli.build_parser().parse_args(argv)
    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        engine, tok, _ = cli.load_engine(args, group)
        if cuda:
            torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        logits, _ = first_step(torch, engine, prompt)
        kernels.reset_launches()
        cli._generate(args, False, engine, tok, tok.encode(args.prompt, add_bos=True))
    out = {"stdout": buf.getvalue(), "logits": logits.cpu().numpy(), "load_s": load_s,
           "launches": dict(kernels.launches),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0}
    del engine
    if cuda:
        torch.cuda.empty_cache()
    return out


def p10h_rank(group, path: str, prompt: list, batch_prompts: list) -> dict:
    """10h(b), one gloo rank: its dense bf16 shard of the file (load time,
    peak memory), the first decode step's logits (rank 0) with the digests
    of every all-reduce on the way, then :func:`p10g_drive` (no batched
    spec: the error it raises)."""
    import torch

    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = dense_file_params(torch, path, dev, group)
    if cuda:
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    eng = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                 cache_dtype=torch.bfloat16, tp=group, metrics=None)
    del params
    record: list = []
    undo = dense_digests(torch, record)
    try:
        logits, _ = first_step(torch, eng, prompt)
    finally:
        undo()
    out = {"load_s": load_s, "digests": record,
           "logits": logits.cpu().numpy() if group.rank == 0 else None,
           "shapes": {n: list(v.shape) for n, v in eng.params["layers"].items()},
           **p10g_drive(eng, prompt, batch_prompts, spec=False),
           "reduce_split": reduce_split(torch, eng, prompt[:20], 4)}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return out


def p10h_ep_rank(group, cfg_kw: dict, prompt: list, steps: int, ep: int) -> dict:
    """10h(c), one rank of the ``ep x tp`` grid (``group.make_grid``): its
    shard of the seeded dense Mixtral (:func:`seeded_dense_params`), the
    first decode step's logits (rank 0) with the digests of every
    all-reduce and routing, ``steps`` greedy tokens and their launches."""
    import torch

    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.parallel.group import make_grid
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    grid = make_grid(group, ep)
    cfg = ModelConfig(**cfg_kw)
    eng = Engine(cfg, seeded_dense_params(torch, cfg, dev, 0, grid),
                 SamplerConfig(temperature=0.0, seed=0), cache_dtype=torch.bfloat16, tp=grid,
                 metrics=None)
    record: list = []
    undo = dense_digests(torch, record)
    try:
        logits, _ = first_step(torch, eng, prompt)
    finally:
        undo()
    out = {"pos": [grid.ep_rank, grid.rank], "digests": record,
           "logits": logits.cpu().numpy() if group.rank == 0 else None,
           "moe_down": list(eng.params["layers"]["moe_down"].shape),
           **decode_run(torch, eng, prompt, steps),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None}
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase10h(torch, dev, path: Path, tok_path: Path, world, nccl, prompt: list,
             batch_in: list, moe_kw: dict = P10H_MIXTRAL) -> dict:
    """Dense-weight tensor parallelism (``parallel.sharding``: column/row
    shards, partial products joined by ``collectives.reduce_columns``) on
    the card. The reference is a one-device eager engine on phase 10's
    Llama-3-8B-width Q40 file loaded as bf16 (dequantized on the card).
    (a) One NCCL rank (``nccl``, None to skip) loads its shard through
    ``cli.load_engine`` and runs the CLI's generate: logits and tokens
    bit-equal to the reference (at one rank the reduce is the identity).
    (b) gloo tp 2 on this card: the first step within 5e-2 * max|logit|,
    ``generate`` (16 tokens), ``generate_batch`` (B = 4 x 8) and a paged
    wave, each stream equal to the reference's or parting at a near tie,
    every rank's all-reduces the same bits, ``generate_batch_spec``
    refused with JAX's message, the kB a token the port's count (beside
    JAX's estimate). (c) ``ep`` 2 x ``tp`` 2 on four gloo ranks, a seeded
    dense Mixtral at full width and 2 layers: the first step within
    tolerance of one device, its tokens equal or a near tie, every rank's
    all-reduces and expert picks the same bits. K4 and K5 launch on each
    rank's kv heads. Times are gloo over one card, not TP speed."""
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime import generate as tg
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    cuda = dev.type == "cuda"
    out: dict = {"card": gpu_line() if cuda else "cpu", "note": "gloo over one card, not TP speed"}
    t0 = time.perf_counter()
    cfg, params = dense_file_params(torch, str(path), dev)
    solo = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0), cache_dtype=torch.bfloat16,
                  device=dev, cuda_graphs=False, metrics=None)
    del params
    if cuda:
        torch.cuda.synchronize(dev)
    out["solo_load_s"] = time.perf_counter() - t0
    solo_logits, _ = first_step(torch, solo, prompt)
    scale = solo_logits.abs().max().item()
    want = p10g_drive(solo, prompt, batch_in, spec=False)
    out["solo"] = {k: want[k] for k in ("solo_s", "batch_s", "ms_per_token")}
    log(f"  10h one-device dense bf16 engine (eager): loaded in {out['solo_load_s']:.1f} s "
        f"(dequantized on the card); {P10G_STEPS} tokens in {want['solo_s']:.2f} s; B = 4 x "
        f"{TP_BATCH_STEPS} in {want['batch_s']:.2f} s")

    def verdict(got, ref, p) -> dict:
        if got == ref:
            return {"equal": True}
        tie = near_tie(solo, p, ref, got)
        tie["ok"] = tie.get("near_tie", False)
        return tie

    def ok(v) -> bool:
        return all(ok(x) for x in v) if isinstance(v, list) else v["equal"] or v["ok"]

    # (a) one NCCL rank: cli.load_engine + the CLI's generate, bit-equal
    if nccl is not None:
        tok = Tokenizer.from_file(str(tok_path))
        ids = tok.encode(P10G_TEXT, add_bos=True)
        ref = solo.generate_fused(ids, P10H_STEPS, stop_tokens=(tok.eos_id,))[0]
        argv = ["generate", "--model", str(path), "--tokenizer", str(tok_path), "--prompt",
                P10G_TEXT, "--steps", str(P10H_STEPS), "--temperature", "0", "--seed", "0",
                "--dtype", "bfloat16", "--weights-float-type", "bf16", "--tp-reduce", "plain"]
        r0 = nccl.run(p10h_nccl_rank, argv, prompt)[0]
        lines = r0["stdout"].splitlines()
        line = next((ln for ln in lines if ln.startswith("🔗")), "")
        got = [int(t) for t in next(ln for ln in lines if ln.startswith("Token ids:"))
               .split(":", 1)[1].split()]
        bit_equal = bool(torch.equal(torch.from_numpy(r0["logits"]), solo_logits.cpu()))
        out["a"] = {"logits_bit_equal": bit_equal, "tokens_equal": got == ref, "line": line,
                    "declined": [ln for ln in lines if ln.startswith("⚠️")],
                    "load_s": r0["load_s"], "peak_gb": r0["peak_gb"], "launches": r0["launches"]}
        log(f"  10h(a) one-rank NCCL `cli generate --weights-float-type bf16 --tp-reduce plain`: "
            f"loaded in {r0['load_s']:.1f} s, peak {r0['peak_gb']:.2f} GB; first-step logits "
            f"bit-equal to one device: {bit_equal}; tokens equal: {got == ref}; {line!r}; "
            f"{out['a']['declined']}; launches {r0['launches']}")
        if not (bit_equal and got == ref and "dense weights" in line
                and any("--tp-reduce needs" in ln for ln in out["a"]["declined"])):
            fail(f"10h(a): the one-rank NCCL dense run differs from one device: {out['a']}")
        for k in ("flash_decode", "rope_cache_update"):
            if not r0["launches"].get(k):
                fail(f"10h(a): {k} never launched in the dense NCCL run")

    # (b) gloo tp 2
    ranks = world.run(p10h_rank, str(path), prompt, batch_in, size=2)
    r0 = ranks[0]
    err = float((torch.from_numpy(r0["logits"]) - solo_logits.cpu()).abs().max())
    in_step = all(r[k] == r0[k] for r in ranks for k in ("solo", "batch", "paged", "digests"))
    streams = {"solo": verdict(r0["solo"], want["solo"], prompt),
               **{k: [verdict(g, w, p) for g, w, p in zip(r0[k], want[k], batch_in)]
                  for k in ("batch", "paged")}}
    kb = tg.dense_tp_wire_bytes_per_row(cfg, 2) / 1024
    # the JAX engine's estimate of its dense path (``_wire_bytes``, printed
    # with a "~"): 2 all-reduces a layer of dim in bf16, 2 (tp - 1) / tp each
    jax_kb = cfg.n_layers * 2 * cfg.dim * 2.0 * 2 * 0.5 / 1024
    res = {"first_step_err": err, "tol": 5e-2 * scale, "in_step": in_step, "streams": streams,
           "reduces_checked": len(r0["digests"]), "spec_refusal": r0["spec"],
           "kb_per_token": r0["kb_per_token"], "kb_count": kb, "kb_jax_estimate": jax_kb,
           "load_s": [r["load_s"] for r in ranks], "peak_gb": [r["peak_gb"] for r in ranks],
           "solo_s": r0["solo_s"], "batch_s": r0["batch_s"], "shapes": r0["shapes"],
           "ms_per_token": [r["ms_per_token"] for r in ranks], "launches": r0["launches"]}
    out["b"] = res
    log(f"  10h(b) gloo tp 2 dense bf16: load {res['load_s']} s, peak {res['peak_gb']} GB a "
        f"rank; first-step err {err:.4f} (tol {res['tol']:.4f}); ranks in step (tokens and "
        f"{len(r0['digests'])} all-reduce digests): {in_step}; streams {streams}; "
        f"{r0['kb_per_token']:.3f} kB sent a decode token (the port's count {kb:.3f}; JAX's "
        f"estimate ~{jax_kb:.3f}); {P10G_STEPS} tokens in {r0['solo_s']:.2f} s (a decode token "
        f"{[round(m, 1) for m in res['ms_per_token']]} ms a rank, one device "
        f"{want['ms_per_token']:.1f}), B = 4 x {TP_BATCH_STEPS} in {r0['batch_s']:.2f} s "
        f"({out['note']}; {out['card']})")
    res["reduce_split"] = [r["reduce_split"] for r in ranks]
    split = [(round(v["reduce_ms_per_token"], 1), round(v["ms_per_token"], 1))
             for v in res["reduce_split"]]
    launched = {k: {n: c for n, c in v.items() if c} for k, v in res["launches"].items()}
    log(f"    a decode token's all-reduces (two a layer, host clock, each waiting on the "
        f"rank's queued kernels) / its wall, ms a rank: {split}")
    log(f"    launches {launched}; shapes {r0['shapes']}")
    if not (in_step and ok(streams["solo"]) and ok(streams["batch"]) and ok(streams["paged"])
            and err <= res["tol"] and len(r0["digests"]) == 2 * 2 * cfg.n_layers):
        fail(f"10h(b): ranks parted, a stream parted off a near tie, or the first step is off "
             f"its tolerance: {res}")
    if "does not run on the dense-pjit mesh path" not in r0["spec"]:
        fail(f"10h(b): generate_batch_spec was not refused with JAX's message: {r0['spec']!r}")
    if abs(r0["kb_per_token"] - kb) > 1e-6 * kb:
        fail(f"10h(b): {r0['kb_per_token']} kB a token, the count {kb}")
    for part, kinds in (("solo", ("flash_decode", "rope_cache_update")),
                        ("batch", ("flash_decode_batched", "rope_cache_update_batched")),
                        ("paged", ("flash_decode_batched", "rope_cache_update_batched"))):
        for k in kinds:
            if not r0["launches"][part].get(k):
                fail(f"10h(b): {k} never launched in the {part} run")
    del solo
    if cuda:
        torch.cuda.empty_cache()

    # (c) ep 2 x tp 2: a seeded dense Mixtral, four gloo ranks
    ep, tp = P10H_GRID
    mcfg = ModelConfig(**moe_kw)
    m_prompt = [t % mcfg.vocab_size for t in prompt[:20]]
    msolo = Engine(mcfg, seeded_dense_params(torch, mcfg, dev, 0), SamplerConfig(
        temperature=0.0, seed=0), cache_dtype=torch.bfloat16, device=dev, cuda_graphs=False,
        metrics=None)
    m_logits, _ = first_step(torch, msolo, m_prompt)
    m_want = decode_run(torch, msolo, m_prompt, 8)["tokens"]
    ranks = world.run(p10h_ep_rank, moe_kw, m_prompt, 8, ep, size=ep * tp)
    r0 = ranks[0]
    err = float((torch.from_numpy(r0["logits"]) - m_logits.cpu()).abs().max())
    tol = 5e-2 * m_logits.abs().max().item()
    if r0["tokens"] == m_want:
        tokens = {"equal": True}
    else:
        i = leading_equal(m_want, r0["tokens"])
        lg, _ = msolo.prefill(msolo.new_cache(), m_prompt + m_want[:i])
        lg = lg.float()
        gap = float((lg[m_want[i]] - lg[r0["tokens"][i]]).abs())
        tokens = {"equal": False, "at": i, "gap": gap,
                  "ok": gap <= P9_TOL * float(lg.abs().max())}
    same = all(r["digests"] == r0["digests"] and r["tokens"] == r0["tokens"] for r in ranks)
    res = {"first_step_err": err, "tol": tol, "tokens": tokens, "ranks_equal": same,
           "positions": [r["pos"] for r in ranks], "moe_down": r0["moe_down"],
           "digests_checked": len(r0["digests"]), "launches": r0["launches"],
           "ms_per_token": [r["ms_per_token"] for r in ranks],
           "kb_per_token": r0["kb_per_token"],
           "kb_count": tg.dense_tp_wire_bytes_per_row(mcfg, tp, ep) / 1024,
           "peak_gb": [r["peak_gb"] for r in ranks]}
    out["c"] = res
    del msolo
    if cuda:
        torch.cuda.empty_cache()
    log(f"  10h(c) ep {ep} x tp {tp}, dense bf16 Mixtral widths, {moe_kw['n_layers']} layers: "
        f"grid {res['positions']}, moe_down a rank {res['moe_down']}; first-step err {err:.4f} "
        f"(tol {tol:.4f}); tokens {tokens}; ranks' all-reduces and expert picks equal: {same} "
        f"({res['digests_checked']} digests); {res['kb_per_token']:.3f} kB a token (the count "
        f"{res['kb_count']:.3f}); {[round(m, 1) for m in res['ms_per_token']]} ms/token a rank; "
        f"peak {res['peak_gb']} GB; launches {res['launches']}")
    # the prefill and the step, each layer: the attention's reduce, the
    # routing, the MoE's reduce
    if not (err <= tol and (tokens["equal"] or tokens["ok"]) and same
            and res["digests_checked"] == 2 * 3 * mcfg.n_layers
            and abs(res["kb_per_token"] - res["kb_count"]) <= 1e-6 * res["kb_count"]):
        fail(f"10h(c): the ep grid is off one device, or its ranks parted: {res}")
    for k in ("flash_decode", "rope_cache_update"):
        if not r0["launches"].get(k):
            fail(f"10h(c): {k} never launched in the ep grid's run")
    return out


def phase10(torch, dev, cfg_kw: dict = LLAMA3_8B, moe_kw: dict = TP_MIXTRAL,
            nccl: bool = True, fleet_tok: Path = None, writer=None, then=None) -> dict:
    """Tensor parallelism (``parallel``) on the card. (a) A one-rank NCCL
    world runs the whole TP path (shard load, gathers through NCCL): logits
    and tokens bit-equal to the eager solo engine on the same `.m` file.
    (b) Ranks over gloo, every rank on this card (NCCL refuses two ranks on
    one device), at tp 2 and 4, each loading its shard of the file: every
    rank's 32 greedy tokens (tp 4: 8) equal and equal to the solo engine's,
    the first decode step within 5e-2 * max|logit|, the padded vocab never wins;
    ``generate_batch`` at B = 4 under tp 2 = the solo batch. (c) The Q80
    wire at tp 2: one teacher-forced step within JAX's compressed-against-
    plain tolerance (0.05 * max|logit|, correlation > 0.999), its bytes the
    analytic count. (d) Mixtral widths at tp 2 (4 layers): the first step
    within tolerance of the solo engine, the expert-indexed GEMVs launched.
    Each run's launches are counted from 0. ms per token here is gloo over
    one card, not tensor-parallel speed. With ``fleet_tok`` (a `.t` file)
    the solo engine also answers 11c's request (``fleet_reference``), (g)
    ``--tp-reduce`` and ``--tp-overlap`` run on the file (:func:`phase10g`,
    reusing tp 2's shards kept from (b)), (e) ``chat`` and ``serve`` run
    under TP on it (:func:`phase10e`), (f) spec and row moves
    (:func:`phase10f`), (h) dense bf16 weights under TP on the same file
    and the ``ep x tp`` grid (:func:`phase10h`, after every quantized
    shard is freed), and the `.m` file is kept for 11c (``out["path"]``;
    the caller deletes it). ``writer``: the process of :func:`start_tp_file`
    writing the file (None: written here). ``then(world, nccl_world)``: run
    last on the 4 gloo ranks and 10e's one NCCL rank (phase 12(d)), its
    result ``out["train"]``."""
    import numpy as np

    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.ops.qmatmul import _pad_up
    from dllama_tpu_torch.parallel import quant_tp
    from dllama_tpu_torch.parallel.group import LocalWorld, close_tp, init_tp, local_init_method
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    out: dict = {"card": gpu_line() if dev.type == "cuda" else "cpu"}
    # the ranks boot (spawn, CUDA context, gloo) while this process writes the file
    world = LocalWorld(4, backend="gloo", devices=[dev] * 4, timeout_s=900,
                       threads=1 if dev.type == "cpu" else None)
    e_worlds = p10e_worlds(dev, nccl) if fleet_tok is not None else None
    path = TP_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        if writer is None:
            write_tp_model(path, cfg_kw, seed=3)
        else:
            writer.join()
            if writer.exitcode != 0:
                fail(f"writing {path} failed (exit code {writer.exitcode})")
        out["file_gb"] = path.stat().st_size / 1e9
        out["write_s"] = time.perf_counter() - t0
        log(f"  random Q40 `.m` file of the Llama-3-8B widths ({cfg_kw['n_layers']} layers): "
            f"{out['file_gb']:.2f} GB, {out['write_s']:.1f} s of phase 10 waited for it")
        prompt = torch.randint(0, cfg_kw["vocab_size"], (100,),
                               generator=torch.Generator().manual_seed(1)).tolist()

        # the solo engine (eager) on the same file
        t0 = time.perf_counter()
        with WeightFileReader(str(path)) as reader:
            cfg = ModelConfig.from_spec(reader.spec, dtype="bfloat16")
            solo = Engine(cfg, llama.quant_params_from_reader(reader, cfg, dev, "q40"),
                          SamplerConfig(temperature=0.0, seed=0), cache_dtype=torch.bfloat16,
                          device=dev, cuda_graphs=False, metrics=None)
        out["solo_load_s"] = time.perf_counter() - t0
        batch_in = batch_prompts(cfg, 4, seed=2)
        solo_logits, _ = first_step(torch, solo, prompt)
        solo_run = decode_run(torch, solo, prompt, TP_STEPS)
        solo_batch = solo.generate_batch(batch_in, TP_BATCH_STEPS)
        out["solo"] = {k: v for k, v in solo_run.items() if k != "launches"}
        if fleet_tok is not None:
            out["fleet_reference"] = fleet_reference(solo, fleet_tok)
        log(f"  solo eager engine: loaded in {out['solo_load_s']:.1f} s; "
            f"{solo_run['ms_per_token']:.2f} ms/token; tokens {solo_run['tokens'][:8]}...")
        scale = solo_logits.abs().max().item()

        # (a) one rank, NCCL: the whole TP path, bit-equal to solo
        if nccl:
            group = init_tp(0, 1, backend="nccl", device=dev, init_method=local_init_method())
            try:
                with WeightFileReader(str(path)) as reader:
                    params = llama.quant_params_from_reader(reader, cfg, dev, "q40", tp=group)
                one = Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0),
                             cache_dtype=torch.bfloat16, tp=group, metrics=None)
                del params
                logits_a, tok_a = first_step(torch, one, prompt)
                run_a = decode_run(torch, one, prompt, TP_STEPS)
                del one
            finally:
                close_tp()
            bit_equal = bool(torch.equal(logits_a, solo_logits))
            out["a"] = {"logits_bit_equal": bit_equal, "tokens_equal":
                        run_a["tokens"] == solo_run["tokens"], "launches": run_a["launches"],
                        "ms_per_token": run_a["ms_per_token"]}
            log(f"  10a one-rank NCCL world: first-step logits bit-equal to solo: {bit_equal}; "
                f"tokens equal: {out['a']['tokens_equal']}; {run_a['ms_per_token']:.2f} ms/token "
                f"(129 NCCL gathers a token); launches {run_a['launches']}")
            if not (bit_equal and out["a"]["tokens_equal"]):
                fail("10a: the one-rank NCCL TP run differs from the solo engine")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # (b), (c) gloo ranks on this card
        for tp in (2, 4):
            ranks = world.run(tp_rank_llama, str(path), prompt, batch_in if tp == 2 else [],
                              tp == 2, size=tp)
            r0 = ranks[0]
            got = torch.from_numpy(r0["logits"])
            err = (got - solo_logits.cpu()).abs().max().item()
            vocab_ok = all(t < cfg.vocab_size for r in ranks for t in r["tokens"])
            same = all(r["tokens"] == r0["tokens"] for r in ranks)
            hidden = quant_tp.ffn_padded_width(cfg, "q40", tp)
            vp = _pad_up(cfg.vocab_size, 128 * tp)
            want_kb = tp_wire_bytes(cfg, tp, 2.0, hidden, vp) / 1024
            res = {"ranks_equal": same, "tokens_equal_solo": r0["tokens"] == solo_run["tokens"],
                   "first_step_err": err, "tol": 5e-2 * scale, "vocab_ok": vocab_ok,
                   "shapes": r0["shapes"], "load_s": [r["load_s"] for r in ranks],
                   "peak_gb": [r["peak_gb"] for r in ranks],
                   "ms_per_token": [r["ms_per_token"] for r in ranks],
                   "kb_per_token": r0["kb_per_token"], "kb_per_token_analytic": want_kb,
                   "launches": r0["launches"]}
            log(f"  10b tp {tp} (gloo, {tp} ranks on one card): load {res['load_s']} s, peak "
                f"{res['peak_gb']} GB a rank; first-step err {err:.4f} (tol {5e-2 * scale:.4f}); "
                f"ranks' tokens equal: {same}, = solo: {res['tokens_equal_solo']}; "
                f"{[round(m, 1) for m in res['ms_per_token']]} ms/token a rank (gloo over one "
                f"card, not TP speed); {r0['kb_per_token']:.1f} kB sent a token (analytic "
                f"{want_kb:.1f}); launches {r0['launches']}; shapes {r0['shapes']}")
            if not (same and res["tokens_equal_solo"] and err <= 5e-2 * scale and vocab_ok):
                fail(f"10b tp {tp}: tokens or first-step logits part from the solo engine")
            if abs(r0["kb_per_token"] - want_kb) > 1e-6 * want_kb:
                fail(f"10b tp {tp}: {r0['kb_per_token']} kB sent a token, analytic {want_kb}")
            for k in ("q40_matmul", "flash_decode", "rope_cache_update"):
                if not r0["launches"].get(k):
                    fail(f"10b tp {tp}: {k} never launched in the TP run")
            if tp == 2:
                res["batch_equal_solo"] = all(r["batch"] == solo_batch for r in ranks)
                res["batch_launches"] = r0["batch_launches"]
                res["batch_s"] = r0["batch_s"]
                log(f"  10b generate_batch B = 4 under tp 2: rows = solo's: "
                    f"{res['batch_equal_solo']}; {TP_BATCH_STEPS} steps in {r0['batch_s']:.2f} s "
                    f"(gloo over one card, not TP speed); launches {r0['batch_launches']}")
                if not res["batch_equal_solo"]:
                    fail("10b: generate_batch under tp 2 parts from the solo batch")
                for k in ("flash_decode_batched", "rope_cache_update_batched", "q40_matmul"):
                    if not r0["batch_launches"].get(k):
                        fail(f"10b: {k} never launched in the tp 2 batch run")
                plain, comp = r0["logits"], r0["q80_logits"]
                c_err = float(np.abs(comp - plain).max())
                corr = float(np.corrcoef(plain.reshape(-1), comp.reshape(-1))[0, 1])
                want_b = tp_wire_bytes(cfg, tp, 1.125, hidden, vp)
                res["q80"] = {"err": c_err, "tol": 0.05 * float(np.abs(plain).max()),
                              "corr": corr, "step_bytes": r0["q80_step_bytes"],
                              "analytic_bytes": want_b}
                log(f"  10c Q80 wire at tp 2, one teacher-forced step: err {c_err:.4f} (tol "
                    f"{res['q80']['tol']:.4f}), correlation {corr:.6f}; {r0['q80_step_bytes']} "
                    f"bytes sent (analytic {want_b:.0f}; plain {want_kb * 1024:.0f})")
                if not (0 < c_err <= res["q80"]["tol"] and corr > 0.999
                        and r0["q80_step_bytes"] == want_b):
                    fail("10c: the Q80 wire step is off its tolerance or its byte count")
            out[f"tp{tp}"] = res
        world.run(p10_release, 4)  # tp 2's shards stay on ranks 0 and 1 for 10g
        if fleet_tok is not None:
            log(f"== phase 10g: --tp-reduce and --tp-overlap under TP (at "
                f"{time.strftime('%H:%M:%S')})")
            out["g"] = phase10g(torch, dev, path, fleet_tok, solo, world, e_worlds, prompt,
                                batch_in, out["tp2"]["kb_per_token"])
            log(f"== phase 10e: chat and serve under TP (at {time.strftime('%H:%M:%S')})")
            out["e"] = phase10e(torch, dev, path, fleet_tok, solo, e_worlds)
            for w in e_worlds.values():  # the servers' freed shards, back to the card
                if w is not None:
                    w.run(p10_release)
            log(f"== phase 10f: speculative decoding and row moves under TP (at "
                f"{time.strftime('%H:%M:%S')})")
            out["f"] = phase10f(torch, dev, path, solo, e_worlds, prompt, batch_in)
            out["f"]["rope_verify"] = phase10f_rope(torch, dev, torch.Generator(
                device=dev).manual_seed(17))
        del solo
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # (d) Mixtral widths at tp 2
        mcfg = ModelConfig(**moe_kw)
        msolo = Engine(mcfg, llama.random_quant_params(
            mcfg, dev, torch.Generator(device=dev).manual_seed(0), "q40"),
            SamplerConfig(temperature=0.0, seed=0), cache_dtype=torch.bfloat16, device=dev,
            cuda_graphs=False, metrics=None)
        m_prompt = prompt[:20]
        m_logits, _ = first_step(torch, msolo, [t % mcfg.vocab_size for t in m_prompt])
        del msolo
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ranks = world.run(tp_rank_moe, moe_kw, [t % mcfg.vocab_size for t in m_prompt], 8,
                          size=2)
        got = torch.from_numpy(ranks[0]["logits"])
        err = (got - m_logits.cpu()).abs().max().item()
        tol = 5e-2 * m_logits.abs().max().item()
        launches = ranks[0]["launches"]
        out["d"] = {"first_step_err": err, "tol": tol, "launches": launches,
                    "ranks_equal": ranks[0]["tokens"] == ranks[1]["tokens"],
                    "ms_per_token": [r["ms_per_token"] for r in ranks],
                    "peak_gb": [r["peak_gb"] for r in ranks]}
        log(f"  10d Mixtral widths, {moe_kw['n_layers']} layers, tp 2: first-step err {err:.4f} "
            f"(tol {tol:.4f}); ranks' tokens equal: {out['d']['ranks_equal']}; launches "
            f"{launches}; {out['d']['ms_per_token']} ms/token a rank")
        if not (err <= tol and out["d"]["ranks_equal"] and launches.get("q40_matmul_stacked")):
            fail("10d: MoE under tp 2 is off the solo engine, or the indexed GEMVs never ran")

        # (h) dense weights under TP, and the ep grid: every quantized shard
        # and engine of the ranks freed first
        world.run(p10_release)
        for w in (e_worlds or {}).values():
            if w is not None:
                w.run(p10_release)
        log(f"== phase 10h: dense-weight tensor parallelism and the ep grid (at "
            f"{time.strftime('%H:%M:%S')})")
        t0 = time.perf_counter()
        out["h"] = phase10h(torch, dev, path, fleet_tok, world,
                            (e_worlds or {}).get("a"), prompt, batch_in)
        out["h"]["seconds"] = time.perf_counter() - t0
        log(f"  10h took {out['h']['seconds']:.1f} s")
        if then is not None:  # phase 12(d): training on these worlds
            out["train"] = then(world, (e_worlds or {}).get("a"))
    finally:
        world.close()
        for w in (e_worlds or {}).values():
            if w is not None:
                w.close()
        if fleet_tok is None:
            path.unlink(missing_ok=True)
    out["path"] = path
    return out


#: phase 11: the replicas' serve flags in process (11a, 11b) and in ``cli fleet`` (11c)
P11_SERVE = dict(batch_window_ms=5.0, batch_max=8, kv_pages=16, ckpt_interval=8)
FLEET_REPLICA_ARGS = ("--kv-pages 16 --batch-window 5 --batch-max 4 --ckpt-interval 8 "
                      "--chat-template llama3")
#: tokens of each request of 11a's wave, of 11b's streams and of 11c's greedy request
P11_WAVE_TOKENS = 16
P11_STREAM_TOKENS = 64
FLEET_TOKENS = 32
#: 11c's greedy request, answered through the fleet and by phase 10's solo engine
FLEET_MESSAGES = [{"role": "user", "content": "Tell me about the ocean and its tides"}]
#: the per-request identity fields of a chat completion chunk
CHUNK_IDS = (rb'"id": "chatcmpl-[0-9a-f]+"', rb'"created": [0-9]+')


def serialized_sessions(engine, lock) -> None:
    """Make every ``BatchSession`` that ``engine`` opens, and each step of
    its solo ``generate``, run its device work under ``lock``. Two engines
    in one process share the device's arrival counters and its default
    stream, and a graph's warm-up and capture (on a side stream) must not
    overlap the other engine's launches; replicas in processes of their own
    get that exclusion from their separate CUDA contexts, which the card
    time-slices. ``del engine.batch_session, engine.generate`` ends it."""
    orig = type(engine).batch_session.__get__(engine)
    solo = type(engine).generate.__get__(engine)

    def generate(*a, **k):
        it = solo(*a, **k)
        while True:
            with lock:
                item = next(it, None)
            if item is None:
                return
            yield item

    def opened(*a, **k):
        with lock:
            sess = orig(*a, **k)
        for name in ("admit", "admit_begin", "prefill_step", "step_chunk", "release", "cancel",
                     "close", "export_row", "admit_from_export"):
            def locked(*x, _fn=getattr(sess, name), **y):
                with lock:
                    return _fn(*x, **y)

            setattr(sess, name, locked)
        return sess

    engine.batch_session = opened
    engine.generate = generate


class P11Replica:
    """One in-process replica of phase 11: a ``ServerState`` on its own
    engine behind ``create_server``, which records the sockets it accepts
    (so :meth:`kill` can cut its streams as a dying process would) and the
    streams its batcher opens."""

    def __init__(self, engine, tok, cfg, port: int = 0):
        import threading

        from dllama_tpu_torch.serving.api_server import ServerState

        self.state = ServerState(engine, tok, cfg, model_name="llama3-8b-shape",
                                 template="llama3", ts_interval=0.0, **P11_SERVE)
        self.streams = 0  # streams opened (submit_stream or a resume's import)
        self.prompts: list = []  # each submitted stream's prompt tokens
        self._count = threading.Lock()
        for meth in ("submit_stream", "submit_import_stream"):
            def counted(*a, _orig=getattr(self.state.batcher, meth), **k):
                gen = _orig(*a, **k)
                with self._count:
                    self.streams += 1
                    if a and isinstance(a[0], list):
                        self.prompts.append(list(a[0]))
                return gen

            setattr(self.state.batcher, meth, counted)
        self.start(port)

    def warm(self) -> None:
        """One checkpointing stream of a prompt of its own: the paged pool
        opens, its graphs are made, and the chat template's first page is
        in the radix cache, so every later admission aliases that page
        whatever the order it comes in."""
        st, _, data = raw_post(self.port, {
            "messages": [{"role": "user", "content": "Say something"}], "max_tokens": 8,
            "temperature": 0.0, "stream": True},
            {"X-Dllama-Ckpt": str(P11_SERVE["ckpt_interval"])})
        if st != 200 or not sse_parts(data)[1]:
            fail(f"phase 11: a replica's warm-up stream answered {st}")
        with self._count:
            self.prompts.clear()

    def start(self, port: int = 0) -> None:
        import threading

        from dllama_tpu_torch.serving.api_server import create_server

        self.srv = create_server(self.state, "127.0.0.1", port)
        self.port = self.srv.server_address[1]
        self.conns: list = []
        accept = self.srv.get_request

        def get_request():
            sock, addr = accept()
            self.conns.append(sock)
            return sock, addr

        self.srv.get_request = get_request
        threading.Thread(target=self.srv.serve_forever, daemon=True, name="p11-http").start()

    def kill(self) -> None:
        """Cut every accepted connection, then close the listener."""
        import socket

        for sock in self.conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its handler
        self.srv.shutdown()
        self.srv.server_close()

    def stop(self) -> None:
        from dllama_tpu_torch.serving.api_server import drain_and_shutdown

        drain_and_shutdown(self.state, self.srv, 10.0)
        self.srv.server_close()


def p11_router(ports: list, **kw):
    """The port's router (``create_router_server``) in front of ``ports``,
    probing every 0.2 s: (state, server, port)."""
    import threading

    from dllama_tpu_torch.serving import router as rt

    state = rt.RouterState([rt.Replica("127.0.0.1", p) for p in ports], probe_interval_s=0.2,
                           **kw)
    state.probe_once()
    state.start_probes()
    srv = rt.create_router_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True, name="p11-router").start()
    return state, srv, srv.server_address[1]


def p11_close_router(state, srv) -> None:
    state.stop_probes()
    srv.shutdown()
    srv.server_close()


def raw_post(port: int, body: dict, headers: dict = None, timeout: float = 600) -> tuple:
    """POST /v1/chat/completions: (status, response headers, raw body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def raw_wave(port: int, bodies: list, headers: dict = None) -> tuple:
    """Every streamed body at once, one thread each: ([{status, text, done,
    error}], wall seconds)."""
    import threading

    out = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def one(i):
        start.wait()
        st, _, data = raw_post(port, bodies[i], headers)
        text, done, err = sse_parts(data)
        out[i] = {"status": st, "text": text, "done": done, "error": err}

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def sse_parts(data: bytes) -> tuple:
    """(content text, saw [DONE], the error event's payload or None)."""
    text, done, err = [], False, None
    for line in data.split(b"\n"):
        if line == b"data: [DONE]":
            done = True
        elif line.startswith(b"data: {"):
            obj = json.loads(line[6:])
            err = obj.get("error", err)
            for ch in obj.get("choices", []):
                text.append((ch.get("delta") or {}).get("content") or "")
    return "".join(text), done, err


def strip_ids(data: bytes) -> bytes:
    import re

    for pat in CHUNK_IDS:
        data = re.sub(pat, b"", data)
    return data


def stream_times(r: dict, tokens: int) -> dict:
    """One streamed ``http_chat`` of ``tokens`` tokens: the time to its first
    content, to its end, and the end over the tokens (a checkpointing stream
    decodes in the paged pool and arrives in bursts of a decode chunk; a
    plain one alone in the pool takes the solo path, a token an event)."""
    if r["status"] != 200 or r["finish"] != "length":
        fail(f"a timed stream ended {r['status']} {r.get('finish')}")
    return {"ttft_ms": r["content_times"][0] * 1e3, "total_ms": r["seconds"] * 1e3,
            "ms_per_token": r["seconds"] * 1e3 / tokens, "events": len(r["content_times"])}


def timed_streams(targets: dict, seed: int, rounds: int = 2, tokens: int = 32) -> dict:
    """``rounds`` greedy streams of ``tokens`` tokens to each named port, in
    turns, a fresh prompt each (every admission cold), the k-th to target n
    with the request id ``p11-<n>-<k>``: {name: {the medians of ttft_ms,
    total_ms, ms_per_token; runs}}."""
    runs = {name: [] for name in targets}
    prompts = wave_prompts(rounds * len(targets), seed)
    for i, p in enumerate(prompts):
        n = i % len(targets)
        name = list(targets)[n]
        body = {"messages": [{"role": "user", "content": p}], "max_tokens": tokens,
                "temperature": 0.0, "stream": True}
        runs[name].append(stream_times(http_chat(
            targets[name], body, headers={"X-Request-Id": f"p11-{n}-{len(runs[name])}"}),
            tokens))
    return {name: {**{m: statistics.median(x[m] for x in v)
                      for m in ("ttft_ms", "total_ms", "ms_per_token")}, "runs": v}
            for name, v in runs.items()}


def log_streams(what: str, med: dict) -> None:
    log(f"  {what}, medians of 2 streams of 32 greedy tokens: " + "; ".join(
        f"{name} {m['ttft_ms']:.1f} ms to the first token, {m['total_ms']:.1f} ms in all, "
        f"{m['ms_per_token']:.3f} ms/token" for name, m in med.items()))


def phase11(torch, dev, engine) -> dict:
    """11a and 11b: the router (``serving.router``) in process, in front of
    two in-process replicas on the card: phase 6's graphed Q40 engine and a
    twin sharing its weights, each ``--kv-pages 16 --batch-window 5
    --batch-max 8 --ckpt-interval 8`` (see the module docstring)."""
    import threading

    from dllama_tpu_torch import kernels
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    cfg = engine.cfg
    card = gpu_line() if dev.type == "cuda" else "cpu"
    out: dict = {"card": card}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        write_serving_tokenizer(Path(d) / "serve.t", cfg.vocab_size)
        tok = Tokenizer.from_file(str(Path(d) / "serve.t"))
    twin = Engine(cfg, engine.params, engine.sampler_cfg, cache_dtype=engine.cache_dtype,
                  device=dev)
    lock = threading.Lock()
    for e in (engine, twin):
        serialized_sessions(e, lock)
    reps = [P11Replica(e, tok, cfg) for e in (engine, twin)]
    ports = [r.port for r in reps]
    try:
        # -- (a) a wave of 8 streamed requests through the router, and each
        # replica's share of it sent straight to a fresh replica of its engine
        bodies = [{"messages": [{"role": "user", "content": p}], "max_tokens": P11_WAVE_TOKENS,
                   "stream": True, "temperature": 0.8 if i % 2 else 0.0, "top_p": 0.9,
                   "seed": 300 + i} for i, p in enumerate(wave_prompts(8, 11))]
        prompts = [tok.encode(reps[0].state.build_prompt(b["messages"]), add_bos=True)
                   for b in bodies]
        for r in reps:
            r.warm()
        state, rsrv, rport = p11_router(ports, ckpt_interval=P11_SERVE["ckpt_interval"])
        try:
            kernels.reset_launches()
            routed, wall = raw_wave(rport, bodies)
            launches = dict(kernels.launches)
            served = [[prompts.index(p) for p in r.prompts if p in prompts] for r in reps]
            refs = [P11Replica(e, tok, cfg) for e in (engine, twin)]
            try:
                straight = [None] * len(bodies)
                for ref, share in zip(refs, served):
                    ref.warm()
                    got, _ = raw_wave(ref.port, [bodies[i] for i in share],
                                      {"X-Dllama-Ckpt": str(P11_SERVE["ckpt_interval"])})
                    for i, g in zip(share, got):
                        straight[i] = g
            finally:
                for ref in refs:
                    ref.stop()

            # a conversation, then its next turn: the router's affinity sends the
            # turn to the replica whose radix cache holds the first turn's pages
            words = wave_prompts(10, 12)  # a first turn of 300-700 bytes
            conv = [{"role": "user", "content": " ".join(words[:6])}]
            n0 = [r.streams for r in reps]
            first = http_chat(rport, {"messages": conv, "max_tokens": 8, "temperature": 0.0,
                                      "stream": True})
            if first["status"] != 200:
                fail(f"phase 11a: the first turn answered {first}")
            holder = [i for i, (r, n) in enumerate(zip(reps, n0)) if r.streams > n]
            rate0 = [json.loads(http_get(p, "/ready")[1])["prefix_hit_rate"] for p in ports]
            turn2 = conv + [{"role": "assistant", "content": first["text"]},
                            {"role": "user", "content": " ".join(words[6:])}]
            picks0 = state._m_picks.value(reason="affinity")
            n1 = [r.streams for r in reps]
            second = http_chat(rport, {"messages": turn2, "max_tokens": 8, "temperature": 0.0,
                                       "stream": True})
            holder2 = [i for i, (r, n) in enumerate(zip(reps, n1)) if r.streams > n]
            rate1 = [json.loads(http_get(p, "/ready")[1])["prefix_hit_rate"] for p in ports]
            affinity_picks = state._m_picks.value(reason="affinity") - picks0

            # the router's cost on a stream: straight to a replica, through a router
            # that only relays (no checkpoints: the replica serves it solo, as
            # straight), and through this one (checkpoints every 8 tokens: the
            # paged pool, bursts of a decode chunk)
            pstate, psrv, pport = p11_router(ports, ckpt_interval=0)
            try:
                timed = timed_streams({"straight": ports[0], "relayed": pport,
                                       "checkpointed": rport}, seed=13)
            finally:
                p11_close_router(pstate, psrv)
        finally:
            p11_close_router(state, rsrv)
        parted = [i for i, (r, g) in enumerate(zip(routed, straight))
                  if g is None or r["text"] != g["text"]]
        a_checks = {
            "statuses": all(r["status"] == 200 and r["done"] and r["error"] is None
                            for r in routed + [g for g in straight if g is not None])
            and first["status"] == second["status"] == 200,
            "every request served once": sorted(i for sh in served for i in sh)
            == list(range(len(bodies))),
            "routed texts = straight to one replica": not parted,
            "both replicas served": all(len(sh) >= 1 for sh in served),
            "the next turn went to the first turn's replica": (len(holder) == 1
                                                               and holder2 == holder),
            "affinity picked it": affinity_picks >= 1,
            "its prefix hit rate rose": bool(holder) and rate1[holder[0]] > rate0[holder[0]],
        }
        n_tok = len(bodies) * P11_WAVE_TOKENS
        out["a"] = {"checks": a_checks, "served": served, "launches": launches,
                    "wave_tokens_per_s": n_tok / wall, "wave_wall_s": wall,
                    "parted": parted, "prefix_hit_rate": {"before": rate0, "after": rate1},
                    "affinity_picks": affinity_picks, "stream": timed}
        log(f"  {card}")
        log(f"  11a wave of 8 streamed requests (4 greedy, 4 sampled), {P11_WAVE_TOKENS} tokens "
            f"each, through the router: requests {served} a replica, {n_tok} tokens in "
            f"{wall * 1e3:.1f} ms = {n_tok / wall:.1f} tokens/s; texts parting from the same "
            f"requests straight to a fresh replica: {parted}; next turn on replica {holder2} "
            f"(first turn {holder}), affinity picks {affinity_picks}, its prefix hit rate "
            f"{rate0} -> {rate1}; launches {launches}")
        log_streams("11a", timed)
        log(f"  11a checks {a_checks}")
        if not all(a_checks.values()):
            fail(f"phase 11a: {[k for k, v in a_checks.items() if not v]}")
        for k in ("q40_matmul", "flash_decode_batched", "rope_cache_update_batched"):
            if not launches.get(k):
                fail(f"phase 11a: {k} never launched through the router")

        # -- (b) mid-stream failover: the serving replica's server stops after a checkpoint --
        out["b"] = {}
        for wire in ("f32", "q80"):
            state, rsrv, rport = p11_router(ports, ckpt_interval=P11_SERVE["ckpt_interval"],
                                            kv_wire=wire)
            stored: list = []
            put = state.ckpt_store.put

            def record(rid, payload, offset, replica, _put=put, _stored=stored):
                _stored.append(len(payload))
                _put(rid, payload, offset, replica)

            state.ckpt_store.put = record
            runs = {}
            try:
                for name, sampling in (("greedy", {"temperature": 0.0}),
                                       ("sampled", {"temperature": 0.8, "top_p": 0.9,
                                                    "seed": 77})):
                    body = {"messages": [{"role": "user",
                                          "content": f"{wave_prompts(1, 14)[0]} {wire} {name}"}],
                            "max_tokens": P11_STREAM_TOKENS, "stream": True, **sampling}
                    raw_post(rport, body)  # the first admission: its prompt's pages cached
                    ref = raw_post(rport, body)  # the run to match: a warm admission
                    n_put = len(stored)
                    live0 = [r.streams for r in reps]
                    got: dict = {}
                    t = threading.Thread(target=lambda: got.setdefault("r", raw_post(rport,
                                                                                      body)))
                    t0 = time.perf_counter()
                    t.start()
                    deadline = time.monotonic() + 120
                    while len(stored) == n_put and time.monotonic() < deadline and t.is_alive():
                        time.sleep(0.001)
                    victim = next((i for i, (r, n) in enumerate(zip(reps, live0))
                                   if r.streams > n), None)
                    if victim is None or len(stored) == n_put:
                        fail(f"phase 11b {wire} {name}: no checkpoint before the stream ended")
                    reps[victim].kill()
                    t.join(timeout=600)
                    resumed_s = time.perf_counter() - t0
                    reps[victim].start(ports[victim])
                    deadline = time.monotonic() + 30
                    while (state.readiness()[1].get("replicas_ready", 0) < 2
                           and time.monotonic() < deadline):
                        time.sleep(0.05)
                    st, _, data = got["r"]
                    text, done, err = sse_parts(data)
                    runs[name] = {"status": st, "victim": victim, "done": done, "error": err,
                                  "bytes_equal": strip_ids(data) == strip_ids(ref[2]),
                                  "text_equal": text == sse_parts(ref[2])[0],
                                  "ckpt_leak": b"dllama-ckpt" in data, "seconds": resumed_s}
                ok = state._m_resumes.value(outcome="ok")
            finally:
                p11_close_router(state, rsrv)
            b_checks = {"statuses": all(r["status"] == 200 and r["done"] and r["error"] is None
                                        and not r["ckpt_leak"] for r in runs.values()),
                        "resumes ok = 2": ok == 2}
            if wire == "f32":
                b_checks["resumed bytes = uninterrupted"] = all(r["bytes_equal"]
                                                                for r in runs.values())
            out["b"][wire] = {"checks": b_checks, "runs": runs, "resumes_ok": ok,
                              "ckpt_frames": len(stored), "ckpt_bytes_max": max(stored),
                              "ckpt_bytes_total": sum(stored)}
            log(f"  11b {wire} wire, a greedy and a sampled {P11_STREAM_TOKENS}-token stream, "
                f"the serving replica's server stopped after the router stored a checkpoint: "
                f"{ {k: {x: r[x] for x in ('victim', 'bytes_equal', 'text_equal', 'seconds')} for k, r in runs.items()} }; "
                f"{len(stored)} checkpoints stored, {max(stored)} bytes at most "
                f"({sum(stored)} in all); resumes ok {ok}; checks {b_checks}")
            if not all(b_checks.values()):
                fail(f"phase 11b {wire}: {[k for k, v in b_checks.items() if not v]}")
    finally:
        for r in reps:
            r.stop()
        for e in (engine, twin):
            del e.batch_session, e.generate
    del twin
    return out


def rss_mb(pid: int) -> float:
    """A process's resident set, MB (from /proc)."""
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return float("nan")


def child_pids(pid: int) -> list:
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for p in Path("/proc").iterdir():
        if p.name.isdigit():
            try:
                stat = (p / "stat").read_text()
            except OSError:
                continue  # gone since the listing
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(p.name))
    return out


def free_ports(n: int) -> int:
    """The first of ``n`` consecutive ports that are free now."""
    import socket

    for base in range(20000 + os.getpid() % 5000, 40000, 11):
        try:
            socks = []
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("no free ports")


def fleet_reference(eng, tok_path: Path) -> dict:
    """What phase 10's solo engine answers to 11c's request: the rendered
    prompt's greedy ids and their text (up to the first stop token)."""
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.serving.templates import render_llama3_chat
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    tok = Tokenizer.from_file(str(tok_path))
    prompt = tok.encode(render_llama3_chat(FLEET_MESSAGES), add_bos=True)
    ids = [t for t, _ in eng.generate(prompt, FLEET_TOKENS, stop_tokens=(tok.eos_id,),
                                      sampler=SamplerConfig(temperature=0.0, seed=0))]
    prev, text = prompt[-1], b""
    for t in ids:
        if t == tok.eos_id:
            break
        text += tok.decode_piece(prev, t)
        prev = t
    return {"prompt_tokens": len(prompt), "ids": ids, "text": text.decode("utf-8", "replace")}


def cli_run(args: list, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch.cli", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def smi_apps() -> dict:
    """{pid: MiB} of the card's compute processes, as nvidia-smi lists them."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       timeout=60)
    apps = {}
    for line in r.stdout.splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = float(mib.strip() or "nan")
    return apps


def phase11c(torch, dev, model: Path, tok_path: Path, reference: dict,
             replica_args: str = FLEET_REPLICA_ARGS) -> dict:
    """11c: ``python -m dllama_tpu_torch.cli fleet --replicas 2`` on phase
    10's Llama-3-8B-width `.m` file (see the module docstring)."""
    import signal
    import tarfile

    work = ROOT / "build" / "fleet"
    (work / "trace").mkdir(parents=True, exist_ok=True)
    trace, logs = work / "trace" / "trace.json", work / "logs"
    base = free_ports(3)  # the replicas' two, then the front door's
    rport = base + 2
    card = gpu_line() if dev.type == "cuda" else "cpu"
    out: dict = {"card": card}
    mem0 = torch.cuda.mem_get_info(dev) if dev.type == "cuda" else (0, 0)
    cmd = ["fleet", "--model", str(model), "--tokenizer", str(tok_path), "--replicas", "2",
           "--base-port", str(base), "--host", "127.0.0.1", "--port", str(rport),
           "--probe-interval", "0.5", "--ready-timeout", "180", "--log-dir", str(logs),
           "--ckpt-interval", "8",
           "--replica-arg", replica_args]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "dllama_tpu_torch.cli", *cmd], cwd=ROOT,
                            env=dict(os.environ, DLLAMA_TRACE=str(trace)),
                            stdout=open(work / "fleet.log", "w"), stderr=subprocess.STDOUT)
    replicas: list = []
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                fail(f"phase 11c: cli fleet exited {proc.returncode} before its front door "
                     f"was ready: {(work / 'fleet.log').read_text()[-3000:]}")
            replicas = replicas or child_pids(proc.pid)
            try:
                if http_get(rport, "/ready")[0] == 200:
                    break
            except OSError:
                pass  # the router is not listening yet
            time.sleep(0.25)
        else:
            fail("phase 11c: the fleet's front door never became ready")
        startup_s = time.perf_counter() - t0
        replicas = child_pids(proc.pid)
        loads = []
        for i in range(2):
            text = (logs / f"replica-{i}.log").read_text()
            loads += [float(ln.split("loaded weights in ")[1].rstrip("s\n"))
                      for ln in text.splitlines() if "loaded weights in " in ln]
        apps = smi_apps() if dev.type == "cuda" else {}
        mem1 = torch.cuda.mem_get_info(dev) if dev.type == "cuda" else (0, 0)
        on_card = {p: apps.get(p) for p in replicas}
        # where nvidia-smi lists processes of another pid namespace (it does
        # not list this one, which holds a context), each replica's own
        # report of its device and the card memory the fleet took stand in
        smi_sees_us = os.getpid() in apps
        said_cuda = all("device: cuda" in (logs / f"replica-{i}.log").read_text()
                        for i in range(2))
        # a warm-up request straight to each replica (its decode graphs)
        for i in range(2):
            http_chat(base + i, {"messages": [{"role": "user", "content": "hi"}],
                                 "max_tokens": 4, "temperature": 0.0})
        greedy = http_chat(rport, {"messages": FLEET_MESSAGES, "max_tokens": FLEET_TOKENS,
                                   "temperature": 0.0}, headers={"X-Request-Id": "p11c-greedy"})
        answer, n_answer = ((greedy["json"]["choices"][0]["message"]["content"],
                             greedy["json"]["usage"]["completion_tokens"])
                            if greedy["status"] == 200 else (None, None))
        timed = timed_streams({"straight": base, "through the fleet's router": rport}, seed=15)
        # where the second routed stream's time went: the replica's spans
        # (queue, prefill, decode) and the router's, from the trace parts
        parts = cli_run(["explain", "p11-1-1", "--trace", str(work / "trace"), "--json"])
        waterfall = ([(r["source"], r["phase"], r["dur_ms"])
                      for r in json.loads(parts.stdout)["rows"]]
                     if parts.returncode == 0 else parts.stdout[-300:])
        top = cli_run(["top", "--router", f"127.0.0.1:{rport}", "--iterations", "1"])
        bundle = work / "snapshot.tar.gz"
        snap = cli_run(["snapshot", "--router", f"127.0.0.1:{rport}", "--out", str(bundle),
                        "--trace-dir", str(work / "trace")])
        docs = len(tarfile.open(bundle).getnames()) if snap.returncode == 0 else 0
        explain = cli_run(["explain", "p11c-greedy", "--trace", str(work / "trace"), "--json"])
        wf = json.loads(explain.stdout) if explain.returncode == 0 else {}
        router_rss = rss_mb(proc.pid)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            rc = None
        drain_s = time.perf_counter() - t1
        gone = [p for p in replicas if not Path(f"/proc/{p}").exists()]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in replicas:
            try:
                os.kill(p, signal.SIGKILL)
            except OSError:
                pass  # already exited
    names = [f"127.0.0.1:{base + i}" for i in range(2)]
    checks = {
        "two replicas": len(replicas) == 2,
        "greedy through the fleet = phase 10's solo engine": answer == reference["text"]
        and n_answer == len(reference["ids"]),
        "top exits 0 with both replicas": top.returncode == 0
        and all(n in top.stdout for n in names),
        "snapshot exits 0 with documents": snap.returncode == 0 and docs >= 1,
        "explain exits 0 with the router's and a replica's spans": explain.returncode == 0
        and {"router", "replica"} <= {r["source"] for r in wf.get("rows", [])},
        "SIGTERM drains to exit 0 within 90 s": rc == 0,
        "the replicas exited": len(gone) == len(replicas),
    }
    if dev.type == "cuda":
        checks["both replicas on the card"] = (
            all(v is not None for v in on_card.values()) if smi_sees_us
            else said_cuda and (mem0[0] - mem1[0]) > 2 * 4e9)
    out.update(checks=checks, startup_s=startup_s, load_s=loads, replica_pids=replicas,
               replica_mib=on_card, card_used_gb=(mem0[0] - mem1[0]) / 1e9,
               router_rss_mb=router_rss, drain_s=drain_s, stream=timed,
               smi_lists_this_process=smi_sees_us, routed_waterfall=waterfall,
               snapshot_docs=docs, explain_rows=len(wf.get("rows", [])),
               greedy_seconds=greedy["seconds"])
    log(f"  {card}")
    log(f"  11c cli fleet --replicas 2 ({replica_args}): front door ready after "
        f"{startup_s:.1f} s (weights loaded in {loads} s), replica pids {replicas}, nvidia-smi "
        f"MiB {on_card} (it lists this process: {smi_sees_us}), card memory taken "
        f"{out['card_used_gb']:.2f} GB; router (the "
        f"supervisor process) RSS {router_rss:.1f} MB")
    log_streams("11c", timed)
    log(f"  11c the second routed stream's spans (source, phase, ms): {waterfall}")
    log(f"  11c snapshot {docs} documents, explain {out['explain_rows']} rows, SIGTERM exit "
        f"{rc} in {drain_s:.1f} s; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 11c: {[k for k, v in checks.items() if not v]}; top: {top.stdout[-800:]} "
             f"{top.stderr[-800:]}; snapshot: {snap.stdout[-400:]} {snap.stderr[-400:]}; "
             f"explain: {explain.stdout[-400:]} {explain.stderr[-400:]}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: training on the card
# ---------------------------------------------------------------------------

#: 12(a) and 12(d): the CPU tests' tiny f32 shapes (tests/test_torch_train_parallel.py)
P12_LLAMA = dict(arch="llama", dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=8,
                 vocab_size=128, seq_len=64, head_size=16, kv_dim=128, dtype="float32")
P12_MIXTRAL = dict(P12_LLAMA, arch="mixtral", vocab_size=256, n_experts=4, n_active_experts=2,
                   rope_style="half")
#: 12(b), 12(c): (what, widths, layers kept, Adam steps) at B x T = P12_BATCH
P12_FULL = [("Llama-3-8B", LLAMA3_8B, 2, 8), ("Mixtral-8x7B", MIXTRAL_8X7B, 1, 4)]
P12_BATCH = (2, 512)
#: 12(e): train_tiny_e2e's step cap (its early stop ends it sooner) and time cap
P12_TINY_STEPS = 900
P12_TINY_S = 60.0
#: 12(d): the CPU tests' tolerances (tests/test_torch_train_parallel.py)
P12_TOL = {"loss": 1e-5, "param": 1e-4, "grad": 1e-4, "pipe_logits": 2e-5, "pipe_grad": 2e-4}


def p12_host(torch, cfg_kw: dict, seed: int) -> dict:
    """The seeded whole params of a tiny shape as host numpy (the ranks
    cut their shards from them)."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from tests.torch_train_ranks import host_of

    return host_of(llama.random_params(ModelConfig(**cfg_kw), seed=seed, device="cpu"))


def p12_flops(cfg, B: int, T: int) -> tuple:
    """(FLOPs, bytes) of one training step: 6 x the product weights x the
    B·T tokens (forward 2, backward 4; every expert of the dense combine),
    plus the attention (QK^T and AV at the whole T x T, 4·B·H·T²·hd a layer
    forward, 3x with the backward); the bytes: every leaf, its gradient and
    Adam's two moments read, and the leaf and the moments written, in f32."""
    D, H, KV, L = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.n_layers
    ffn = cfg.n_experts * 3 * D * H + D * cfg.n_experts if cfg.is_moe else 3 * D * H
    products = L * (2 * D * D + 2 * D * KV + ffn) + D * cfg.vocab_size
    flops = 6 * products * B * T + 12 * B * cfg.n_heads * T * T * cfg.head_size * L
    leaves = products + cfg.vocab_size * D + (2 + 2 * cfg.post_norms) * L * D + D
    return flops, 7 * 4 * leaves


def phase12a(torch, dev) -> dict:
    """12(a): one SGD step of the tiny f32 Llama and Mixtral on the card
    against the same step of the port on the CPU: the loss within 1e-5,
    every gradient leaf within 1e-4·max|g|, the updated leaves within 1e-4."""
    from dllama_tpu_torch.models.config import ModelConfig
    from tests import torch_train_ranks as R

    out = {}
    for what, kw in (("Llama", P12_LLAMA), ("Mixtral", P12_MIXTRAL)):
        cfg = ModelConfig(**kw)
        host = p12_host(torch, kw, 3)
        tok = [torch.randint(0, cfg.vocab_size, (4, 16),
                             generator=torch.Generator().manual_seed(5)).numpy()]
        sgd = {"kind": "SGD", "lr": 1e-2}
        runs = {"cpu": R.step_case(None, {}, host, cfg, tok, sgd, "cpu"),
                "card": R.step_case(None, {}, host, cfg, tok, sgd, dev)}
        card, cpu = runs["card"], runs["cpu"]
        loss_err = abs(card["losses"][0] - cpu["losses"][0])
        grad_err = max(float(abs(card["grads"][k] - g).max() / max(abs(g).max(), 1e-30))
                       for k, g in cpu["grads"].items())
        param_err = max(float(abs(card["params"][k] - p).max())
                        for k, p in cpu["params"].items())
        out[what] = {"loss_card": card["losses"][0], "loss_cpu": cpu["losses"][0],
                     "loss_err": loss_err, "grad_err_over_max": grad_err,
                     "param_err": param_err,
                     "tol": {"loss": 1e-5, "grad_over_max": 1e-4, "param": 1e-4}}
        log(f"  12a {what} f32 (dim 128, 2 layers): loss card {card['losses'][0]:.7f} / CPU "
            f"{cpu['losses'][0]:.7f} (err {loss_err:.2e}, tol 1e-5); worst gradient leaf "
            f"{grad_err:.2e} of its max|g| (tol 1e-4); SGD-updated leaves {param_err:.2e} "
            f"(tol 1e-4)")
        if not (loss_err <= 1e-5 and grad_err <= 1e-4 and param_err <= 1e-4):
            fail(f"12a: the {what} train step on the card parts from the CPU's")
    return out


def phase12_full(torch, dev, what: str, cfg_kw: dict, layers: int, steps: int) -> dict:
    """12(b)/(c): ``steps`` Adam (lr 1e-4) steps on one fixed batch at full
    width, ``layers`` layers, f32 params from ``device_random_params``.
    Gates: the loss finite and falling; no host sync inside a step (the
    loss read after it is the one). Logged: ms a step (median of steps 2 on,
    CUDA events), tokens/s, peak memory, FLOPs and their rate beside
    ``F32_FLOPS``."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.runtime import train

    cfg = ModelConfig(**{**cfg_kw, "n_layers": layers, "dtype": "float32"})
    B, T = P12_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # the earlier phases' tensors still alive
    t0 = time.perf_counter()
    params = train.trainable(llama.device_random_params(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in train.leaves(params))
    opt = torch.optim.Adam(train.leaves(params), lr=1e-4)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(12))
    step = train.make_train_step(cfg)
    losses, ms = [], []
    for i in range(steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i > 0:  # step 1 makes the rope tables and Adam's state
            torch.cuda.set_sync_debug_mode("error")
        try:
            s.record()
            loss = step(params, opt, tokens)
            e.record()
        except RuntimeError as err:
            fail(f"12 {what}: a train step synchronizes with the device: {err}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        losses.append(float(loss))  # the one host read
        ms.append(s.elapsed_time(e))
    med = statistics.median(ms[1:])
    flops, nbytes = p12_flops(cfg, B, T)
    bound, by = bound_ms(nbytes, flops, F32_FLOPS)
    out = {"layers": layers, "steps": steps, "params": n_params, "make_s": make_s,
           "losses": losses, "ms": ms, "ms_median": med, "tokens_per_s": B * T / med * 1e3,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) - held) / 1e9,
           "held_before_gb": held / 1e9, "flops": flops,
           "tflop_per_s": flops / med / 1e9, "f32_peak_share": flops / med / 1e9 / (F32_FLOPS / 1e12),
           "bound_ms": bound, "bound_by": by, "card": gpu_line()}
    log(f"  12 {what} widths, {layers} layer(s), f32, Adam lr 1e-4, B x T = {B} x {T}: "
        f"{n_params / 1e9:.3f} B params made on the card in {make_s:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}; {med:.2f} ms a step (median of steps 2-{steps}; "
        f"steps {[round(x, 1) for x in ms]}), {out['tokens_per_s']:.0f} tokens/s; peak "
        f"{out['peak_gb']:.2f} GB above the {held / 1e9:.2f} GB earlier phases hold; "
        f"{flops / 1e12:.3f} TFLOP a step = "
        f"{out['tflop_per_s']:.1f} TFLOP/s ({out['f32_peak_share']:.2f} of F32_FLOPS "
        f"{F32_FLOPS / 1e12:.0f}); bound {bound:.1f} ms ({by}); no host sync inside steps "
        f"2-{steps}; {out['card']}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"12 {what}: the loss is not finite or does not fall: {losses}")
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def p12_err(a, b) -> float:
    """max|a - b| over matching leaves (dicts of numpy) or two arrays."""
    import numpy as np

    if isinstance(a, dict):
        return max(float(np.abs(a[k] - b[k]).max()) for k in b)
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def phase12d(torch, dev, world, nccl) -> dict:
    """12(d), on phase 10's worlds: a tp 1 step at one NCCL rank bit-equal to
    the one-device step; on the 4 gloo ranks (all on this card) tp 2 and
    dp 2 x tp 2 SGD steps, dp 2 x sp 2 (ring attention) loss and gradients,
    pp 2 at 2 and 4 microbatches, an ep 2 x tp 2 Mixtral step, each against
    the one-device run on the card at the CPU tests' tolerances; a
    checkpoint saved at dp 2 x tp 2 and restored there, at tp 2 and at one
    rank: the saved leaves and Adam state back bit for bit and the next
    two losses equal to the uninterrupted run's."""
    import numpy as np

    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.parallel import sharding
    from tests import torch_train_ranks as R

    cfg, mcfg = ModelConfig(**P12_LLAMA), ModelConfig(**P12_MIXTRAL)
    host, mhost = p12_host(torch, P12_LLAMA, 4), p12_host(torch, P12_MIXTRAL, 1)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    mtok = rng.integers(0, mcfg.vocab_size, (2, 16)).astype(np.int32)
    sgd = {"kind": "SGD", "lr": 1e-2}
    out, bad = {}, []
    t0 = time.perf_counter()

    def unshard(c, ranks, key):
        return sharding.unshard_leaves(c, [(r["position"], r[key]) for r in ranks])

    one = R.step_case(None, {}, host, cfg, [tok], sgd, dev)
    if nccl is not None:
        r = nccl.run(R.step_case, {"tp": 1}, host, cfg, [tok], sgd)[0]
        eq = r["losses"] == one["losses"] and all(np.array_equal(r["params"][k], v)
                                                   for k, v in one["params"].items())
        out["nccl_tp1_bit_equal"] = eq
        bad += [] if eq else ["one NCCL rank's tp 1 step is not the one-device step's bits"]
    for axes in ({"tp": 2}, {"dp": 2, "tp": 2}):
        size = int(np.prod(list(axes.values())))
        ranks = world.run(R.step_case, axes, host, cfg, [tok], sgd, size=size)
        l_err = max(abs(r["losses"][0] - one["losses"][0]) for r in ranks)
        p_err = p12_err(unshard(cfg, ranks, "params"), one["params"])
        out[str(axes)] = {"loss_err": l_err, "param_err": p_err}
        if l_err > P12_TOL["loss"] or p_err > P12_TOL["param"]:
            bad.append(f"{axes} step: loss err {l_err}, leaves {p_err}")
    sp_tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    dense = R.loss_case(None, {}, host, cfg, sp_tok, dev)
    ranks = world.run(R.loss_case, {"dp": 2, "sp": 2}, host, cfg, sp_tok)
    l_err = max(abs(r["loss"] - dense["loss"]) for r in ranks)
    g_err = max(p12_err(r["grads"], dense["grads"]) for r in ranks)
    out["dp2xsp2"] = {"loss_err": l_err, "grad_err": g_err}
    if l_err > 1e-4 or g_err > P12_TOL["grad"]:
        bad.append(f"dp 2 x sp 2: loss err {l_err}, gradients {g_err}")
    pipe = R.pipeline_case(None, {}, host, cfg, tok, 2, False, dev)
    for micro in (2, 4):
        ranks = world.run(R.pipeline_case, {"pp": 2}, host, cfg, tok, micro, False, size=2)
        f_err = max(p12_err(r["logits"], pipe["logits"]) for r in ranks)
        g_err = p12_err(unshard(cfg, ranks, "grads"), pipe["grads"])
        out[f"pp2_m{micro}"] = {"logits_err": f_err, "grad_err": g_err}
        if f_err > P12_TOL["pipe_logits"] or g_err > P12_TOL["pipe_grad"]:
            bad.append(f"pp 2, {micro} microbatches: logits {f_err}, gradients {g_err}")
    mone = R.step_case(None, {}, mhost, mcfg, [mtok], sgd, dev)
    ranks = world.run(R.step_case, {"ep": 2, "tp": 2}, mhost, mcfg, [mtok], sgd)
    l_err = max(abs(r["losses"][0] - mone["losses"][0]) for r in ranks)
    p_err = p12_err(unshard(mcfg, ranks, "params"), mone["params"])
    out["ep2xtp2_mixtral"] = {"loss_err": l_err, "param_err": p_err}
    if l_err > P12_TOL["loss"] or p_err > P12_TOL["param"]:
        bad.append(f"ep 2 x tp 2 Mixtral step: loss err {l_err}, leaves {p_err}")

    path = str(ROOT / "build" / "p12" / "ckpt")
    batches = [rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(4)]
    before, after = batches[:2], batches[2:]  # two steps each side of the save
    other = p12_host(torch, P12_LLAMA, 9)
    try:
        saved = world.run(R.checkpoint_save_case, {"dp": 2, "tp": 2}, host, cfg, before, after,
                          path)
        back = {"dp2xtp2": world.run(R.checkpoint_restore_case, {"dp": 2, "tp": 2}, other,
                                     cfg, after, path),
                "tp2": world.run(R.checkpoint_restore_case, {"tp": 2}, other, cfg, after, path,
                                 size=2),
                "one rank": world.run(R.checkpoint_restore_case, {"tp": 1}, other, cfg, after,
                                      path, size=1)}
    finally:
        import shutil

        shutil.rmtree(ROOT / "build" / "p12", ignore_errors=True)
    want = {k: unshard(cfg, saved, w) for k, w in
            (("params", "saved"), ("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"))}
    cont = saved[0]["next_losses"]
    ref = R.loss_case(None, {}, R.nest(want["params"]), cfg, after[0], dev)["loss"]
    ck = {"saving_run_next_losses": cont, "one_device_loss_of_saved": ref}
    for where, ranks in back.items():
        state_ok = all(np.array_equal(v, want[key][k]) for key in want
                       for k, v in unshard(cfg, ranks, key).items())
        state_ok &= all(r["adam_step"] == saved[0]["adam_step"] for r in ranks)
        ck[where] = {"steps": [r["step"] for r in ranks], "state_bit_equal": state_ok,
                     "next_losses": [r["next_losses"] for r in ranks]}
        # the second loss reads the restored Adam state
        same = (all(r["next_losses"] == cont for r in ranks) if where == "dp2xtp2" else
                all(abs(a - b) <= 1e-6 for r in ranks for a, b in zip(r["next_losses"], cont)))
        if not (state_ok and same and all(r["step"] == 2 for r in ranks)):
            bad.append(f"checkpoint restored at {where}: leaves and Adam state {state_ok}, "
                       f"next losses {ck[where]['next_losses']} against {cont}")
    if back["one rank"][0]["next_losses"][0] != ref:
        bad.append(f"one rank's restored next loss {back['one rank'][0]['next_losses'][0]} is "
                   f"not the one-device loss of the saved leaves {ref}")
    out["checkpoint"] = ck
    out["seconds"] = time.perf_counter() - t0
    log(f"  12d grids on this card (gloo ranks, one NCCL rank), errors against one device: "
        f"{ {k: v for k, v in out.items() if k not in ('checkpoint', 'seconds')} }; "
        f"checkpoint: {ck}; {out['seconds']:.1f} s")
    if bad:
        fail("12d: " + "; ".join(bad))
    return out


def phase12e(torch) -> dict:
    """12(e): ``python -m dllama_tpu_torch.train_tiny_e2e`` as a subprocess on
    the card: it trains until memorised (or its step cap), writes the Q40
    `.m` file and serves it through ``Engine.generate_fused`` and ``cli
    generate``; exit 0 means both 95 % prefix gates passed."""
    outdir = ROOT / "build" / "train_tiny_e2e"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.train_tiny_e2e",
                           str(outdir), "--steps", str(P12_TINY_STEPS)],
                          capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall = time.perf_counter() - t0
    res_path = outdir / "e2e_result.json"
    res = json.loads(res_path.read_text()) if res_path.exists() else {}
    res.update({"rc": proc.returncode, "wall_s": wall})
    log(f"  12e train_tiny_e2e on the card: rc {proc.returncode} in {wall:.1f} s; final loss "
        f"{res.get('final_loss')} after {res.get('steps')} steps in "
        f"{res.get('train_seconds')} s; served: {res.get('match_tokens')}/"
        f"{res.get('expected_tokens')} tokens in process, cli generate "
        f"{res.get('cli_ok')}; {res.get('decode_ms_per_token')} ms a decode token; in-process "
        f"launches {res.get('launches')} (cli generate prints none)")
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-3000:])
        fail("12e: train_tiny_e2e failed its gates")
    if res.get("train_seconds", 1e9) > P12_TINY_S:
        fail(f"12e: training took {res.get('train_seconds')} s, over {P12_TINY_S}")
    got = res.get("launches", {})
    for family in (("q40_matmul",), ("flash_decode", "flash_decode_batched"),
                   ("rope_cache_update", "rope_cache_update_batched")):
        if not any(got.get(k) for k in family):
            fail(f"12e: {family[0]} never launched serving the trained model")
    return res


P13_PROMPT = "Tell me about the ocean and the tides"  # one prefill dispatch
P13_STEPS = 40  # the first token from the prefill, one 32-step loop chunk, a tail of 7
P13_LONG_STEPS = 200  # six chunks: the runner's loop after its first call
P13_TOL = 1e-3  # the prefill program's logits against the engine's, of max |logit|
P13_DIR = ROOT / "build" / "native_export"
P13_SEED = 13


def p13_config(cfg_kw: dict):
    from dllama_tpu_torch.models.config import ModelConfig

    return ModelConfig(**{**cfg_kw, "n_layers": 1, "dtype": "float32"})


def p13_export(cfg_kw: dict, device: str) -> None:
    """13's export, run by :func:`start_p13_export` in a process of its own:
    the serving tokenizer, dense f32 params of one layer at ``cfg_kw``'s
    widths drawn on ``device`` (seed ``P13_SEED``), ``export_model`` (the
    three programs traced and AOTInductor-compiled) with the runner's g++
    build beside it; the seconds of each stage and the hand-written kernels
    launched (none expected) go to ``P13_DIR/export.json``. Raises on any
    failure (a non-zero exit)."""
    import torch

    from dllama_tpu_torch import export_native, kernels
    from dllama_tpu_torch.models import llama

    t0 = time.perf_counter()
    shutil.rmtree(P13_DIR, ignore_errors=True)
    P13_DIR.mkdir(parents=True)
    runner_build = subprocess.Popen(
        [sys.executable, "-c", "import time; t = time.perf_counter(); from dllama_tpu_torch "
         "import native_launch as n; n.build([n.RUNNER]); print(time.perf_counter() - t)"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        write_serving_tokenizer(P13_DIR / "serve.t", cfg_kw["vocab_size"])
        cfg = p13_config(cfg_kw)
        params = llama.device_random_params(cfg, seed=P13_SEED, device=device)
        times: dict = {}
        kernels.reset_launches()
        export_native.export_model(cfg, params, str(P13_DIR / "export"),
                                   tokenizer_path=str(P13_DIR / "serve.t"),
                                   cache_dtype=torch.float32, device=device, times=times)
        launched = {k: n for k, n in kernels.launches.items() if n}
        build_log = runner_build.communicate(timeout=900)[0]
    finally:
        if runner_build.poll() is None:
            runner_build.kill()
            runner_build.wait()
    if runner_build.returncode != 0:
        raise RuntimeError(f"the runner's build failed:\n{build_log[-3000:]}")
    (P13_DIR / "export.json").write_text(json.dumps({
        "times_s": times, "runner_build_s": float(build_log.split()[-1]),
        "launched": launched, "wall_s": time.perf_counter() - t0}))


#: processes started beside the phases (phase 13's export), each the leader
#: of a process group of its own (its compile workers and g++ in it)
SIDE: list = []


def side_signal(proc, sig) -> None:
    """``sig`` to ``proc``'s process group, if it still has one."""
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass


@contextlib.contextmanager
def side_stopped():
    """Stop the running :data:`SIDE` process groups (SIGSTOP) for the block
    and let them go on after it (SIGCONT): a profiler window that counts
    kernel records exactly runs with no compile beside it. The stop costs
    the side process the block's length and nothing else."""
    running = [p for p in SIDE if p.poll() is None]
    for p in running:
        side_signal(p, signal.SIGSTOP)
    try:
        yield
    finally:
        for p in running:
            side_signal(p, signal.SIGCONT)


def start_p13_export(cfg_kw: dict = LLAMA3_8B, device: str = "cuda"):
    """Start :func:`p13_export` in a process of its own at nice 10 and
    return it: the compiles keep a few host cores busy for minutes, which
    the phases before 13 leave idle; its GPU work is the params and the
    compiles' autotuning. Its process group is stopped while a profiler
    window runs (:func:`side_stopped`) and killed at exit if still
    running."""
    import atexit

    code = (f"import os, sys; os.nice(10); sys.path.insert(0, {str(ROOT)!r}); import "
            f"chip_smoke as c; c.p13_export({cfg_kw!r}, {device!r})")
    log_file = open(ROOT / "build" / "native_export.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=log_file,
                            stderr=subprocess.STDOUT, start_new_session=True)
    SIDE.append(proc)
    atexit.register(lambda: proc.poll() is None and (side_signal(proc, signal.SIGKILL),
                                                     proc.wait()))
    return proc


def p13_ids(text: str) -> list:
    """The ids of a ``Token ids:`` line (the runner's and the CLI's)."""
    line = next((ln for ln in text.splitlines() if ln.startswith("Token ids:")), None)
    if line is None:
        fail(f"13: no 'Token ids:' line in the runner's output:\n{text[-2000:]}")
    return [int(t) for t in line.split(":", 1)[1].split()]


def p13_windows(torch, out: Path, leaves: list, cache: dict, dev) -> dict:
    """The compiled loop and step programs called in process (greedy):
    host-clock ms a token of one loop call (32 steps) and of one step call
    (median of 8, each ending in a sync), and the loop call's device busy
    ms a token under the profiler, split by kernel name (top 8)."""
    from torch.profiler import ProfilerActivity, profile

    def i32(v, shape=None):
        t = torch.tensor(v, dtype=torch.int32, device=dev)
        return t if shape is None else t.reshape(shape)

    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    loop = torch._inductor.aoti_load_package(str(out / "model_loop.pt2"))
    step = torch._inductor.aoti_load_package(str(out / "model.pt2"))
    head = (*leaves, cache["k"], cache["v"], i32([1]))
    args = (*head, i32(0, ()), torch.zeros((), device=dev), torch.full((), 0.9, device=dev),
            i32(1, ()))
    loop(*args)
    loop_ms = wall_ms(lambda: loop(*args)) / 32
    step(*head, i32(40, ()))
    step_ms = statistics.median(wall_ms(lambda p=p: step(*head, i32(p, ()))) for p in range(41, 49))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop(*args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3
        if t > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + t / 32
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"loop_ms_per_token": loop_ms, "step_ms": step_ms,
            "loop_busy_ms_per_token": sum(by_name.values()), "loop_kernels": len(by_name),
            "loop_top_ms_per_token": top}


def p13_runner(out: Path, steps: int) -> dict:
    """``native_launch generate --temperature 0`` on the export ``out`` for
    ``steps`` tokens, as a user runs it: its ids, the prompt line, each
    loop chunk's and tail step's ms a token and its load lines. A failed
    build or run fails the script."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch.native_launch", "generate", "--export-dir",
         str(out), "--prompt", P13_PROMPT, "--steps", str(steps), "--temperature", "0"],
        cwd=ROOT, capture_output=True, text=True, errors="replace", timeout=300)
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"13: the runner exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-3000:]}")
    err_lines = proc.stderr.splitlines()
    dispatch = [ln.strip() for ln in err_lines if "prompt:" in ln]
    return {"ids": p13_ids(proc.stdout), "run_s": run_s,
            "prompt_line": dispatch[0] if dispatch else "no prompt line",
            "chunk_ms": [float(ln.split("(")[-1].split()[0]) for ln in err_lines
                         if "🔶 chunk" in ln],
            "tail_ms": [float(ln.split("G")[1].split("ms")[0]) for ln in err_lines
                        if "| pos" in ln],
            "avg_ms": next(float(ln.split(":")[1].split()[0]) for ln in proc.stdout.splitlines()
                           if ln.startswith("Avg generation time")),
            "load": " | ".join(ln.strip() for ln in err_lines
                               if "ready in" in ln or "loaded" in ln)}


def phase13(torch, dev, cfg_kw: dict = LLAMA3_8B, side=None) -> dict:
    """13: native export. ``side``: the process of :func:`start_p13_export`
    (its export and compiles ran beside the earlier phases; None runs
    :func:`p13_export` here). Then ``native_launch generate --temperature
    0`` runs the runner on a one-dispatch prompt for ``P13_STEPS`` tokens.
    Gates: the runner's ids equal the engine's ``generate_fused`` ids on the
    same params (redrawn from the seed), or part only at a near tie
    (logged); the prefill program's logits within ``P13_TOL`` of the
    engine's prefill; the export and the traced programs launch no
    hand-written kernel; the hash bits of the loop's sampler are the CPU's.
    Any failed export, compile, build or run fails the script."""
    try:
        import triton
        log(f"  triton {triton.__version__}")
    except ImportError:
        log("  triton: not installed")
    from dllama_tpu_torch import export_native, kernels
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig, hash_bits
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    t_phase = time.perf_counter()
    if side is None:
        p13_export(cfg_kw, str(dev))
    else:
        t0 = time.perf_counter()
        if side.wait() != 0:
            fail(f"13: the export process exited {side.returncode}:\n"
                 f"{(ROOT / 'build' / 'native_export.log').read_text()[-4000:]}")
        log(f"  waited {time.perf_counter() - t0:.1f} s for the export process")
    side_res = json.loads((P13_DIR / "export.json").read_text())
    times = side_res["times_s"]
    log(f"  export process: {side_res['wall_s']:.1f} s (nice 10, beside phases 2-12 when run "
        f"by the script); export and compile s {({k: round(v, 2) for k, v in times.items()})}; "
        f"the runner built in {side_res['runner_build_s']:.1f} s beside them")
    if side_res["launched"]:
        fail(f"13: the export launched hand-written kernels: {side_res['launched']}")
    out, tok_path = P13_DIR / "export", P13_DIR / "serve.t"

    cfg = p13_config(cfg_kw)
    params = llama.device_random_params(cfg, seed=P13_SEED, device=dev)
    tok = Tokenizer.from_file(str(tok_path))
    prompt = tok.encode(P13_PROMPT, add_bos=True)
    bucket = min(export_native.PREFILL_BUCKET, cfg.seq_len)
    names, leaves = export_native.flatten_weights(params, llama.rope_tables(cfg, dev))

    # the prefill and loop programs in process: no hand-written kernel
    kernels.reset_launches()
    cache = llama.init_cache(cfg, torch.float32, dev)
    padded = torch.zeros(bucket, dtype=torch.int32, device=dev)
    padded[:len(prompt)] = torch.tensor(prompt, dtype=torch.int32, device=dev)
    prefill = torch._inductor.aoti_load_package(str(out / "model_prefill.pt2"))
    got_logits = prefill(*leaves, cache["k"], cache["v"], padded,
                         torch.zeros((), dtype=torch.int32, device=dev),
                         torch.tensor(len(prompt), dtype=torch.int32, device=dev)).float()
    window = p13_windows(torch, out, leaves, cache, dev) if dev.type == "cuda" else {}
    torch.cuda.synchronize()
    traced_launches = {k: n for k, n in kernels.launches.items() if n}
    if traced_launches:
        fail(f"13: a traced program launched hand-written kernels: {traced_launches}")
    del prefill, cache
    log(f"  the loop and step programs in process (greedy): {window}")

    engine = Engine(cfg, params, SamplerConfig(temperature=0.0), cache_dtype=torch.float32,
                    device=dev)
    ref_logits = engine.prefill(engine.new_cache(), prompt)[0].float().reshape(-1)
    err = float((got_logits.reshape(-1) - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    log(f"  prefill program vs the engine's prefill: max |err| {err:.3e} of max |logit| "
        f"{scale:.3e} (tolerance {P13_TOL} x)")
    if not err <= P13_TOL * scale:
        fail(f"13: the prefill program's logits are {err:.3e} from the engine's "
             f"(tolerance {P13_TOL * scale:.3e})")
    engine.generate_fused(prompt, P13_STEPS)  # captures the engine's graphs
    torch.cuda.synchronize()
    runs = {}
    for steps in (P13_STEPS, P13_LONG_STEPS):
        want, eng_prefill_ms, eng_decode_ms = engine.generate_fused(prompt, steps)
        r = p13_runner(out, steps)
        r["engine_ms_per_token"] = eng_decode_ms / max(1, len(want) - 1)
        r["near_tie"] = tie = near_tie(engine, prompt, list(want), r["ids"])
        log(f"  runner, {steps} steps: {len(r['ids'])} tokens in {r['run_s']:.1f} s "
            f"({r['prompt_line']}); loop chunks {r['chunk_ms']} ms/token, tail steps "
            f"{r['tail_ms']} ms, avg generation {r['avg_ms']} ms; the engine's "
            f"generate_fused {r['engine_ms_per_token']:.3f} ms/token (prefill "
            f"{eng_prefill_ms:.1f} ms); ids vs the engine: {tie}; {r['load']}")
        if len(r["ids"]) != len(want) or not (tie.get("equal") or tie.get("near_tie")):
            fail(f"13: the runner's ids part from the engine's away from a near tie: {tie}\n"
                 f"runner {r['ids']}\nengine {list(want)}")
        if " in 1 dispatches" not in r["prompt_line"]:
            fail(f"13: the prompt did not take one prefill dispatch: {r['prompt_line']}")
        runs[steps] = r
    # the first chunk of a runner process carries its first call's costs
    warm = runs[P13_LONG_STEPS]["chunk_ms"][1:]
    warm_ms = statistics.median(warm) if warm else None
    log(f"  runner loop chunks after the first: median {warm_ms} ms a token")

    # the loop sampler's noise: the card's hash bits are the CPU's
    seed, step = (torch.tensor(v, dtype=torch.int32) for v in (12345, 31))
    if not torch.equal(hash_bits(seed, step, cfg.vocab_size),
                       hash_bits(seed.to(dev), step.to(dev), cfg.vocab_size).cpu()):
        fail("13: the sampler's hash bits differ between the card and the CPU")

    weight_bytes = sum(p.numel() * p.element_size() for n, p in zip(names, leaves)
                       if n not in ("params.embedding", "rope.cos", "rope.sin"))
    kv = 2 * cfg.n_layers * cfg.seq_len * cfg.kv_dim * 4  # gqa reads the whole f32 cache
    bound = (weight_bytes + kv) / HBM_BYTES_PER_S * 1e3
    phase_s = time.perf_counter() - t_phase
    log(f"  the bound: {bound:.3f} ms a token ({(weight_bytes + kv) / 1e9:.3f} GB over 3.35 "
        f"TB/s); phase 13 in {phase_s:.1f} s here")
    res = {"export": side_res, "runner": runs, "warm_chunk_ms_per_token": warm_ms,
           "bound_ms": bound, "in_process": window, "prefill_err": err,
           "prefill_scale": scale, "phase_s": phase_s}
    del engine, params, leaves
    torch.cuda.empty_cache()
    return res


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
    starts: list = []  # (phase title, its start in s)

    def header(title: str) -> None:
        label = title.split(":")[0]
        seen = sum(a == label or a.startswith(label + " (") for a, _ in starts)
        starts.append((f"{label} ({seen + 1})" if seen else label,
                       time.perf_counter() - t_start))
        log(f"== {title} (at {starts[-1][1]:.0f} s)")

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
    tp_writer = start_tp_file()  # phase 10's `.m` file, written while phases 1-9 run
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

    # phase 13's export and compiles, niced, beside phases 2-12
    p13_side = start_p13_export()
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

    header("phase 9: bucketed KV slot pools, paged KV and row migration on phase 6's graphed "
           "Q40 engine")
    engine = kept.pop()
    pools = phase9(torch, dev, engine)
    header("phase 8: the OpenAI-compatible server on phase 6's graphed Q40 engine")
    serving = phase8(torch, dev, engine, graphs["generate_ms_per_token_graphed"])
    torch.cuda.empty_cache()  # the engine stays for phase 11's replicas
    header("phase 8d: cli verify and cli generate --profile on phase 3's small Q40 model")
    serving["cli"] = phase8d()

    header("phase 10: tensor parallelism: K1/K3 at the tp 2 and tp 4 shard widths, T = 1 "
           "(decode) and 5, 9, 16, 72 (10f: verify steps)")
    tp_widths = phase10_widths(torch, dev, gen)
    header("phase 10g: K1/K3 on the wo/w2 row shards of --tp-reduce at tp 2 and 4, T = 1, 4, "
           "8, 9, 16, 72; K4/K5 launched on half a batch")
    row_widths = phase10g_widths(torch, dev, gen)
    halves = phase10g_halves(torch, dev, gen)
    header("phase 10: tensor parallelism: one-rank NCCL, then gloo ranks on this card; 10g "
           "--tp-reduce and --tp-overlap; 10e chat and serve under TP; 10f speculative "
           "decoding and row moves under TP; 10h dense weights under TP and the ep grid")
    fleet_tok = ROOT / "build" / "fleet" / "serve.t"
    fleet_tok.parent.mkdir(parents=True, exist_ok=True)
    write_serving_tokenizer(fleet_tok, LLAMA3_8B["vocab_size"])

    def run_phase12d(world, nccl_world):
        header("phase 12d: training on phase 10's worlds: one NCCL rank; gloo tp 2, dp 2 x tp "
               "2, dp 2 x sp 2, pp 2, ep 2 x tp 2; a checkpoint across grids")
        return phase12d(torch, dev, world, nccl_world)

    tp_run = phase10(torch, dev, fleet_tok=fleet_tok, writer=tp_writer, then=run_phase12d)

    header("phase 11a-b: the router in front of two in-process replicas on phase 6's graphed "
           "Q40 engine and its twin")
    fleet = phase11(torch, dev, engine)
    del engine
    torch.cuda.empty_cache()
    header("phase 11c: cli fleet --replicas 2 on phase 10's Llama-3-8B-width Q40 `.m` file")
    try:
        fleet["c"] = phase11c(torch, dev, tp_run["path"], fleet_tok, tp_run["fleet_reference"])
    finally:
        tp_run["path"].unlink(missing_ok=True)

    header("phase 12a: a train step of a tiny f32 Llama and Mixtral, the card against the CPU")
    train_run = {"a": phase12a(torch, dev), "d": tp_run["train"]}
    for what, kw, layers, steps in P12_FULL:
        header(f"phase 12{'b' if what.startswith('Llama') else 'c'}: {what} widths, {layers} "
               f"layer(s), f32, {steps} Adam steps at B x T = {P12_BATCH[0]} x {P12_BATCH[1]}")
        train_run[what] = phase12_full(torch, dev, what, kw, layers, steps)
    header("phase 12e: python -m dllama_tpu_torch.train_tiny_e2e: train, Q40 `.m`, cli generate")
    train_run["e"] = phase12e(torch)
    header("phase 13: native export: step, loop and prefill programs of a Llama-3-8B-width "
           "layer through AOTInductor, the C++ runner on libtorch")
    native = phase13(torch, dev, side=p13_side)
    header("end")

    phase_s = {a: round(tb - ta, 1) for (a, ta), (_, tb) in zip(starts, starts[1:])}
    log(f"  seconds a phase: {phase_s}")

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
    # phase 10: each kernel's launches in rank 0's tensor-parallel runs
    # (tp 2: 33-token generate, generate_batch at B = 4; 10d: Mixtral, 9
    # tokens), and K1's and K3's decode GEMVs at the shard widths
    tp_launch = {**tp_run["tp2"]["launches"],
                 **{k: v for k, v in tp_run["tp2"]["batch_launches"].items() if "batched" in k},
                 "q40_matmul_stacked": tp_run["d"]["launches"]["q40_matmul_stacked"]}
    # 10e: rank 0's launches while the gloo tp 2 server answered its
    # requests (wave, n = 2, a cancelled stream and its companion, one solo)
    tp_serve = tp_run["e"]["b"]["launches"]
    # 10f: rank 0's launches in the gloo tp 2 generate_spec (33 tokens) and
    # generate_batch_spec (B = 4), draft 8
    tp_spec = tp_run["f"]["b"]["launches"]
    # 10g: rank 0's launches in the gloo tp 2 runs of every mode (generate
    # 16 tokens, generate_batch B = 4, generate_batch_spec, a paged wave);
    # in the two overlap modes each batched K4/K5 launch covers half a batch
    tp_modes, tp_halves = {}, {}
    for name, _, overlap in P10G_MODES:
        for part in tp_run["g"][name]["launches"].values():
            for k, n in part.items():
                tp_modes[k] = tp_modes.get(k, 0) + n
                if overlap and k in ("flash_decode_batched", "rope_cache_update_batched",
                                     "rope_cache_update_verify"):
                    tp_halves[k] = tp_halves.get(k, 0) + n
    # 10h: rank 0's launches in the dense bf16 runs: gloo tp 2 (generate 16
    # tokens, generate_batch B = 4, a paged wave), the ep 2 x tp 2 Mixtral
    # (9 tokens), the one NCCL rank's CLI generate
    tp_dense: dict = {}
    for part in tp_run["h"]["b"]["launches"].values():
        for k, n in part.items():
            tp_dense[k] = tp_dense.get(k, 0) + n
    tp_dense_ep = tp_run["h"]["c"]["launches"]
    tp_dense_nccl = tp_run["h"].get("a", {}).get("launches", {})
    for entry in summary["kernels"]:
        if tp_dense.get(entry["name"]):
            entry["launches_tp2_dense"] = tp_dense[entry["name"]]
        if tp_dense_ep.get(entry["name"]):
            entry["launches_ep2xtp2_dense"] = tp_dense_ep[entry["name"]]
        if tp_dense_nccl.get(entry["name"]):
            entry["launches_tp1_nccl_dense"] = tp_dense_nccl[entry["name"]]
        if tp_modes.get(entry["name"]):
            entry["launches_tp2_reduce_overlap"] = tp_modes[entry["name"]]
        if tp_halves.get(entry["name"]):
            entry["launches_tp2_half_batch"] = tp_halves[entry["name"]]
        if tp_launch.get(entry["name"]):
            entry["launches_tp2"] = tp_launch[entry["name"]]
        if tp_serve.get(entry["name"]):
            entry["launches_tp_serve"] = tp_serve[entry["name"]]
        if tp_spec.get(entry["name"]):
            entry["launches_tp2_spec"] = tp_spec[entry["name"]]
        if entry["name"] in ("q40_matmul", "q80_matmul"):
            kind = entry["name"][:3]
            keys = ("O", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "max_abs_err",
                    "route", "blocks", "block_slots")
            entry["tp_widths"] = {f"{r['matrix']}@tp{r['tp']}": {k: r[k] for k in keys}
                                  for r in tp_widths if r["kind"] == kind and r["T"] == 1}
            entry["tp_verify_widths"] = {
                f"{r['matrix']}@tp{r['tp']}@T{r['T']}": {k: r[k] for k in keys}
                for r in tp_widths if r["kind"] == kind and r["T"] != 1}
            entry["tp_row_widths"] = {
                f"{r['matrix']}@tp{r['tp']}@T{r['T']}": {k: r[k] for k in ("K", *keys)}
                for r in row_widths if r["kind"] == kind}
        if entry["name"] in ("flash_decode_batched", "rope_cache_update_batched"):
            k = "k4" if entry["name"] == "flash_decode_batched" else "k5"
            entry["half_batch"] = {h["cache"]: {"bit_equal": all(h["bit_equal"].values()),
                                                "half_ms": h[f"{k}_half_ms"],
                                                "full_ms": h[f"{k}_full_ms"]} for h in halves}
        if entry["name"] == "rope_cache_update_verify":
            entry["tp_heads"] = {
                f"tp{r['tp']}@B{r['rows'][0]}xT{r['rows'][1]}": {
                    k: r[k] for k in ("heads", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "max_abs_err")}
                for r in tp_run["f"]["rope_verify"] if "ms" in r}
    # phase 6's graphed solo run (prefill, the graph's warm-up step, 32
    # replays): the kernels a replay launches
    # phase 12e: the trained tiny model served on the card in process
    # (prefill + 84 graphed decode steps): K1, and K4/K5 in their batched
    # B = 1 form, the graphed step's
    for entry in summary["kernels"]:
        if train_run["e"]["launches"].get(entry["name"]):
            entry["launches_train_tiny_served"] = train_run["e"]["launches"][entry["name"]]
    for entry in summary["kernels"]:
        run = graphs80 if entry["name"] == "q80_matmul" else graphs
        if entry["name"] in ("q40_matmul", "q80_matmul", "flash_decode_batched",
                             "rope_cache_update_batched"):
            entry["launches_graphed_decode"] = run["launches_graphed"][entry["name"]]
        if entry["name"] in ("q40_matmul", "flash_decode_batched", "rope_cache_update_batched"):
            # phase 9's exact gates: 8 rows of 200 tokens through each layout
            for layout in ("bucketed", "paged"):
                entry[f"launches_{layout}"] = pools[layout]["launches"].get(entry["name"], 0)
            # phase 11a: the wave of 8 requests through the router
            entry["launches_router"] = fleet["a"]["launches"].get(entry["name"], 0)
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "ptxas": ptxas, "q40": q40, "q80": q80, "variants": variants,
               "flash_decode": flash, "rope_cache": rope, "flash_decode_batched": flash_b,
               "rope_cache_batched": rope_b, "rope_cache_verify": rope_v, "e2e": e2e,
               "e2e_q80": e2e80, "batch_q40": batch, "batch_q80": batch80, "spec": spec,
               "graphs_q40": graphs, "graphs_q80": graphs80, "k4_bound_S": k4_fixed,
               "experiments": exp, "cli": cli, "moe_indexed": moe_k, "mixtral_q40": mix,
               "grok1_q40": grok, "mixtral_q80": mix80, "pools": pools, "serving": serving,
               "tp_widths": tp_widths, "tp_row_widths": row_widths, "tp_halves": halves,
               "tp": tp_run, "fleet": fleet, "train": train_run, "native_export": native,
               "summary": summary,
               "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start}
    (ROOT / "build" / "chip_smoke.json").write_text(json.dumps(details, indent=1, default=str))
    log(f"== done in {details['seconds']:.1f} s; details in build/chip_smoke.json")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
