"""Command-line entry point of the port: ``inference``, ``generate`` and
``chat`` over a `.m` model and a `.t` tokenizer, on the card unless
``--device cpu`` is given.

    python -m dllama_tpu_torch.cli generate --model m.m --tokenizer t.t \\
        --prompt "Hello" --steps 64 --temperature 0

On the card the weights stay in the file's own Q40 or Q80 format and every
projection runs through that format's dequant-matmul kernel (pass
``--weights-float-type`` to choose otherwise; q80 on a Q40 file requantizes
the dequantized values). ``DLLAMA_FUSE_NORM=1`` folds each rmsnorm into the
projection kernels that follow it. Each decode step replays one captured
CUDA graph. ``generate`` decodes in fused chunks of ``--decode-chunk N``
steps (64 by default), one host sync and one print a chunk
(``Engine.generate_fused``); ``inference`` and ``chat`` read each token as
it is made, for its per-token times and its stop. ``--spec-draft K`` decodes with
prompt-lookup speculative drafting (up to K drafted tokens verified in one
step); on the CPU the tokens are the plain run's, on the card up to the
low-bit logit differences of a drafted step (see ``Engine.generate_spec``).
``--profile DIR`` writes a ``torch.profiler`` trace of the run
(``DIR/trace.json``, Chrome trace format: host ops and, on the card, every
kernel).

``serve`` is the OpenAI-compatible HTTP server (``serving.api_server``)
with the JAX package's flags and defaults: ``--batch-window`` batches on
bucketed KV slot pools (``--kv-buckets 1``, the default; 0 for the uniform
pool), ``--kv-pages N`` on paged KV with the radix prefix cache, and the
paged pool serves ``--role prefill|decode``, ``--ckpt-interval``
checkpoints and preemption. ``verify`` checks a `.m` file's integrity
checksums without a model or a device:

    python -m dllama_tpu_torch.cli serve --model m.m --tokenizer t.t --port 8189 \\
        --batch-window 30 --kv-pages 16
    python -m dllama_tpu_torch.cli verify --model m.m

``router``, ``fleet``, ``top``, ``explain`` and ``snapshot`` are the fleet's
control plane (``serving.router``, ``serving.fleet``, ``obsv.forensics``):
stdlib only, dispatched before ``torch`` is imported. ``fleet`` spawns N
``serve`` replicas of this CLI, each on the card (``cuda:0``, shared) unless
``--replica-arg "--device cpu ..."`` is given, and fronts them with the
router; ``top`` watches a live router, ``snapshot`` bundles its
observability surfaces and ``explain`` joins one request's trace spans and
flight events:

    python -m dllama_tpu_torch.cli fleet --model m.m --tokenizer t.t \\
        --replicas 2 --replica-arg "--kv-pages 16 --batch-window 5"
    python -m dllama_tpu_torch.cli top --router 127.0.0.1:9900 --iterations 1

``--tp N`` runs ``inference``, ``generate``, ``chat`` and ``serve``
tensor-parallel (``parallel``): this process is rank 0 and starts N - 1
local ranks, one process and one GPU each (``cuda:<local rank>``, NCCL), or
CPU ranks over gloo with ``--device cpu``. Each rank loads only its shard of the weights,
quantized weights only; decode steps are eager under TP.
``--buffer-float-type q80`` moves the activation gathers as the Q80 wire.
Across hosts every host runs the same command with ``--coordinator
HOST:PORT --num-hosts H --host-id h`` and runs N / H ranks (rank h·N/H +
local index); ``worker`` is that command with its output kept back on
hosts other than 0:

    python -m dllama_tpu_torch.cli generate --model m.m --tokenizer t.t --tp 4
    python -m dllama_tpu_torch.cli worker --model m.m --tokenizer t.t --tp 8 \\
        --coordinator host0:29500 --num-hosts 2 --host-id 1

In ``chat`` and ``serve`` rank 0 alone reads stdin or binds the port, and
hands each engine call to the other ranks (``parallel.control``).
``--spec-draft`` speculates under ``--tp`` as on one device, and ``serve
--role prefill|decode`` moves rows between replicas of any ``--tp``.
``--tp-reduce plain|q80`` runs wo and w2 row-parallel (each rank loads
their K chunk; partial sums on a ring reduce-scatter, Q80 hops with q80)
and ``--tp-overlap`` runs a batched decode or verify step of two or more
rows as two microbatches whose collectives overlap: both as the JAX
package runs them, declined with its warning where they cannot engage
(no ``--tp``, MoE, a K chunk off the scale planes). Dense weights are
refused under ``--tp`` > 1 (ROADMAP Queue 1 item 8.6).
"""

from __future__ import annotations

import argparse
import codecs
import contextlib
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama_tpu_torch")
    sub = p.add_subparsers(dest="mode", required=True)
    # offline artifact check: no tokenizer, no engine, no device
    vp = sub.add_parser(
        "verify", help="verify a .m weight file's integrity checksums")
    vp.add_argument("--model", required=True)
    vp.add_argument("--json", action="store_true",
                    help="print the full verification report as JSON")
    vp.add_argument("--shard", default=None, metavar="I/N",
                    help="verify only the row stripe host I of N actually "
                    "loads (tensor-parallel sharded verify): with a DLRB "
                    "row-band section the check reads ~1/N of the file's "
                    "bytes; replicated 1-D tensors are always fully "
                    "checked. Run once per host, e.g. --shard 0/4 ... 3/4")
    def add_router_flags(rp, default_port: int) -> None:
        # shared by `router` (standalone front door) and `fleet` (router +
        # local replicas): the routing policy knobs
        rp.add_argument("--host", default="0.0.0.0")
        rp.add_argument("--port", type=int, default=default_port,
                        help="the front-door listen port")
        rp.add_argument(
            "--probe-interval", type=float, default=1.0, metavar="S",
            help="seconds between /ready probe rounds: drain/crash takes a "
            "replica out of rotation within one interval")
        rp.add_argument(
            "--connect-timeout", type=float, default=2.0, metavar="S",
            help="upstream connect + status-line timeout per hop")
        rp.add_argument(
            "--upstream-timeout", type=float, default=0.0, metavar="S",
            help="upstream response/stream read timeout after the status "
            "line; 0 = unlimited (long decodes stream for minutes)")
        rp.add_argument(
            "--first-byte-timeout", type=float, default=0.0, metavar="S",
            help="deadline for the upstream status line after the request "
            "was sent (the replica's queue+prefill window); 0 falls back "
            "to --upstream-timeout (0 = unlimited)")
        rp.add_argument(
            "--stall-timeout", type=float, default=0.0, metavar="S",
            help="inter-byte stall budget on SSE relay: an upstream "
            "silent past this mid-stream is treated as DEAD and the "
            "stream is checkpoint-resumed on a sibling (counted as "
            "outcome=stall); 0 disables stall detection")
        rp.add_argument(
            "--header-timeout", type=float, default=10.0, metavar="S",
            help="deadline for a client to land a full request head "
            "(the slow-loris kill); 0 = unlimited")
        rp.add_argument(
            "--client-stall-timeout", type=float, default=30.0, metavar="S",
            help="hard kill for clients that stop draining their socket "
            "mid-response: a blocked client write past this closes the "
            "connection (and its upstream within one chunk); 0 = wait "
            "forever (backpressure still pauses the upstream read)")
        rp.add_argument(
            "--max-conns", type=int, default=0, metavar="N",
            help="connection-count admission: at N open client "
            "connections, new ones are shed at accept time with a canned "
            "503 + Retry-After before any state is allocated; 0 = "
            "unlimited")
        rp.add_argument(
            "--probe-read-timeout", type=float, default=2.0, metavar="S",
            help="per-probe READ deadline, distinct from --connect-timeout:"
            " a gray replica (accepts, then silence) costs one read "
            "deadline and is marked circuit-open, never a wedged probe "
            "pass; 0 falls back to --connect-timeout")
        rp.add_argument(
            "--retry-budget", type=int, default=2, metavar="N",
            help="extra replicas tried after a retriable upstream failure "
            "(connect error or 503); 429/504 always pass through untouched")
        rp.add_argument(
            "--affinity-block", type=int, default=256, metavar="BYTES",
            help="prompt-prefix affinity hash block size: repeat "
            "conversations route to the replica whose radix cache holds "
            "their warm KV pages; 0 disables affinity (pure least-load)")
        rp.add_argument(
            "--kv-wire", default="f32", choices=["f32", "q80", "q80+f32"],
            help="wire mode for KV page handoffs (migrations and "
            "mid-stream checkpoints): f32 is bit-exact — a migrated "
            "stream is token-for-token the solo stream; q80 ships ~3.76x "
            "fewer bytes, block-quantized and error-bounded; q80+f32 "
            "ships full pages as q80 but the partial tail page bit-exact "
            "f32 — the page still being decoded into carries no "
            "quantization error, at near-q80 cost")
        rp.add_argument(
            "--ckpt-interval", type=int, default=32, metavar="K",
            help="mid-stream failover: ask each streamed request's "
            "replica for a session checkpoint every K emitted tokens "
            "(token-count based, so deterministic); on an upstream death "
            "mid-SSE the router resumes the stream bit-identically on a "
            "sibling replica from the latest checkpoint. 0 disables "
            "checkpoint frames and resume orchestration")
        rp.add_argument(
            "--ts-interval", type=float, default=1.0, metavar="S",
            help="metrics-history sampling cadence in seconds: a daemon "
            "thread snapshots every counter/gauge/histogram-percentile "
            "into the bounded in-process time-series store behind "
            "GET /metrics/history (under `fleet` the flag also rides "
            "every replica's serve argv, so one flag sets the whole "
            "fleet's history resolution); 0 disables the sampler thread")

    # the fleet front door: stdlib-only, no model artifacts, no torch — it
    # proxies the OpenAI surface across N running `serve` replicas
    rp = sub.add_parser(
        "router", help="stateless HTTP front door over N running replicas")
    rp.add_argument(
        "--replica", action="append", required=True, metavar="HOST:PORT",
        help="one upstream dllama-api replica (repeatable)")
    add_router_flags(rp, default_port=9900)

    # router + N locally spawned/supervised replicas in one command — the
    # test/bench topology (production runs `serve` per machine + `router`)
    fp = sub.add_parser(
        "fleet", help="spawn, supervise and front N local replicas")
    fp.add_argument("--model", required=True)
    fp.add_argument("--tokenizer", required=True)
    fp.add_argument("--replicas", type=int, default=2, metavar="N",
                    help="replica subprocesses to spawn and supervise")
    fp.add_argument("--base-port", type=int, default=9990, metavar="P",
                    help="replica i listens on P+i")
    fp.add_argument("--replica-host", default="127.0.0.1",
                    help="interface the replicas bind (loopback: only the "
                    "router is meant to face traffic)")
    fp.add_argument(
        "--prefill", type=int, default=0, metavar="N",
        help="dedicated prefill replicas (the first N of --replicas, via "
        "a per-replica --role): they run new prompts plus the first decode "
        "chunk, then hand the row's KV pages to a decode replica; goes "
        "with --decode")
    fp.add_argument(
        "--decode", type=int, default=0, metavar="M",
        help="dedicated decode replicas (the next M): they import migrated "
        "KV page streams warm and stream the rest of each completion; "
        "goes with --prefill")
    fp.add_argument(
        "--replica-arg", action="append", default=[], metavar="'--flag v'",
        help="extra `serve` flag(s) passed to every replica (repeatable), "
        "e.g. --replica-arg '--kv-pages 16' --replica-arg '--batch-max 4'")
    fp.add_argument("--max-restarts", type=int, default=3, metavar="N",
                    help="per-replica crash-restart budget; a replica past "
                    "it stays down (the router routes around the hole)")
    fp.add_argument("--ready-timeout", type=float, default=180.0,
                    metavar="S", help="max wait for every replica's first "
                    "/ready 200 (weights load time)")
    fp.add_argument("--drain-timeout", type=float, default=30.0,
                    metavar="S", help="SIGTERM grace per drain: replicas "
                    "finish in-flight work, then the router stops")
    fp.add_argument("--log-dir", default=None, metavar="DIR",
                    help="per-replica stdout/stderr logs (replica-N.log); "
                    "default: inherit this terminal")
    fp.add_argument(
        "--slo-classes", default=None, metavar="SPEC",
        help="per-class SLO lane config passed to every replica's serve "
        "argv (see `serve --slo-classes`); a --replica-arg "
        "'--slo-classes ...' overrides")
    # -- elastic fleet: the closed autoscale loop (serving/autoscale.py
    #    decides, serving/fleet.py's ElasticSupervisor executes) --
    fp.add_argument(
        "--autoscale", action="store_true",
        help="close the loop: evaluate the SLO/pressure policy every "
        "--scale-interval and scale the replica set live between "
        "--min-replicas and --max-replicas (default: the fleet stays at "
        "--replicas forever)")
    fp.add_argument("--min-replicas", type=int, default=1, metavar="N",
                    help="autoscale floor (never drain below this)")
    fp.add_argument("--max-replicas", type=int, default=0, metavar="N",
                    help="autoscale ceiling (0: use --replicas)")
    fp.add_argument("--scale-interval", type=float, default=1.0,
                    metavar="S", help="seconds between policy evaluations")
    fp.add_argument("--scale-up-pressure", type=float, default=0.75,
                    metavar="P", help="fleet pressure at/above which an "
                    "observation counts toward scale-up")
    fp.add_argument("--scale-down-pressure", type=float, default=0.25,
                    metavar="P", help="fleet pressure at/below which a "
                    "quiet observation counts toward scale-down")
    fp.add_argument("--scale-cooldown-up", type=float, default=5.0,
                    metavar="S", help="min seconds between a scale event "
                    "and the next scale-up")
    fp.add_argument("--scale-cooldown-down", type=float, default=20.0,
                    metavar="S", help="min seconds between a scale event "
                    "and the next scale-down")
    fp.add_argument("--prewarm-tokens", type=int, default=16, metavar="N",
                    help="decode budget of each pre-warm prefill replayed "
                    "into a joining replica (must exceed the batch chunk "
                    "or the row finishes before it exports KV pages)")
    add_router_flags(fp, default_port=9900)

    # live fleet terminal view: polls the router's /stats + /metrics/fleet
    # — stdlib only, runs anywhere a curl would
    tp = sub.add_parser(
        "top", help="live terminal view of a running router/fleet")
    tp.add_argument("--router", default="127.0.0.1:9900",
                    metavar="HOST:PORT", help="the router front door")
    tp.add_argument("--interval", type=float, default=1.0, metavar="S",
                    help="seconds between refreshes")
    tp.add_argument("--iterations", type=int, default=0, metavar="N",
                    help="stop after N refreshes (0 = run until ^C)")

    # per-request latency forensics: join trace spans + flight-recorder
    # events already on disk into one phase waterfall — stdlib only
    ep = sub.add_parser(
        "explain", help="phase waterfall for one request id from trace "
        "+ flight-recorder files")
    ep.add_argument("request_id", metavar="REQUEST_ID",
                    help="the X-Request-Id to explain (as logged / "
                    "returned in the response headers)")
    ep.add_argument("--trace", action="append", default=[], metavar="PATH",
                    help="trace file or directory of part files "
                    "(repeatable); the DLLAMA_TRACE output, solo or "
                    "fleet-merged")
    ep.add_argument("--flight", action="append", default=[],
                    metavar="PATH",
                    help="flight-recorder snapshot JSON (a saved "
                    "/debug/flight body or $DLLAMA_FLIGHT dump; "
                    "repeatable)")
    ep.add_argument("--json", action="store_true",
                    help="emit the joined waterfall as JSON")
    ep.add_argument("--width", type=int, default=48, metavar="COLS",
                    help="waterfall bar width in columns")

    # support bundle: one tarball of every observability surface of a
    # running fleet — what you attach to a bug report
    zp = sub.add_parser(
        "snapshot", help="support bundle: tarball the fleet's metrics, "
        "history, stats, alerts, flight rings and newest trace parts")
    zp.add_argument("--router", default="127.0.0.1:9900",
                    metavar="HOST:PORT", help="the router front door")
    zp.add_argument("--out", default=None, metavar="PATH",
                    help="output tarball path (default "
                    "dllama-snapshot-<unixtime>.tar.gz)")
    zp.add_argument("--window", type=float, default=300.0, metavar="S",
                    help="history window to bundle from /metrics/history")
    zp.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="directory holding DLLAMA_TRACE part files; the "
                    "newest part per replica (and overall) is bundled")

    for mode in ("inference", "generate", "chat", "serve", "worker"):
        sp = sub.add_parser(
            mode, help="the generate run of one host of a multi-host tensor-parallel job "
            "(--coordinator/--num-hosts/--host-id), output kept back on hosts other than 0"
            if mode == "worker" else None)
        if mode == "serve":  # the dllama-api surface (`src/apps/dllama-api`)
            sp.add_argument("--host", default="0.0.0.0")
            sp.add_argument("--port", type=int, default=9990)
            sp.add_argument(
                "--session-cache",
                type=int,
                default=2,
                metavar="N",
                help="conversation KV states kept resident (LRU): N "
                "interleaved chats each reuse their own prefix instead of "
                "re-prefilling; every slot holds a full KV cache in HBM",
            )
            sp.add_argument(
                "--batch-window",
                type=float,
                default=0.0,
                metavar="MS",
                help="arrival window in milliseconds before the scheduler "
                "routes a batch: concurrent requests share every "
                "weight-streaming pass (~Kx throughput under K-way "
                "concurrency, same tokens as solo runs), and later "
                "arrivals join the running pool mid-flight (continuous "
                "batching; streaming rows emit chunk-sized SSE bursts); "
                "0 disables batching entirely",
            )
            sp.add_argument(
                "--batch-max",
                type=int,
                default=8,
                metavar="B",
                help="slot-pool size for continuous batching (HBM bound: "
                "the resident batch cache holds B full-context rows); "
                "requests beyond B queue and are admitted into slots as "
                "earlier rows finish — mid-flight, between decode chunks",
            )
            sp.add_argument(
                "--batch-chunk",
                type=int,
                default=8,
                metavar="N",
                help="fused decode steps per scheduler pass: smaller N "
                "admits queued arrivals into free slots sooner (lower "
                "time-to-first-token under load) at more host round trips; "
                "larger N amortizes dispatch overhead",
            )
            sp.add_argument(
                "--prefill-chunk",
                type=int,
                default=-1,
                metavar="N",
                help="prompt tokens consumed per scheduler tick during "
                "pooled admission: a long prompt no longer stalls resident "
                "rows for its whole prefill — the pool keeps decoding "
                "between N-token pieces, and each piece is bit-identical "
                "to monolithic prefill; -1 = auto (batch-chunk x "
                "batch-max, one decode-chunk's worth of compute), "
                "0 = monolithic",
            )
            sp.add_argument(
                "--kv-buckets",
                type=int,
                default=1,
                metavar="0|1",
                help="length-bucketed KV slot pools (power-of-two ladders "
                "up to seq-len) instead of one uniform full-context slab: "
                "short rows occupy small slabs, so strictly more rows fit "
                "the same HBM budget; rows that outgrow a bucket migrate "
                "to the next slab mid-flight; 0 = uniform full-context "
                "slots (pre-bucketing behavior). The port serves only the uniform "
                "pool: batching with 1 is refused at start",
            )
            sp.add_argument(
                "--kv-bucket-min",
                type=int,
                default=0,
                metavar="N",
                help="smallest KV bucket context length (rounded up to a "
                "power of two); 0 = auto (max(16, 2x batch-chunk))",
            )
            sp.add_argument(
                "--kv-pages",
                type=int,
                default=0,
                metavar="N",
                help="paged KV: tokens per page of one preallocated arena "
                "(halved until it divides seq-len) with per-row page "
                "tables and a copy-on-write radix prefix cache — admits "
                "alias cached shared-prompt pages and prefill only the "
                "uncached tail, growing rows append pages (no slab "
                "migration copies), eviction is LRU under the same "
                "modeled HBM budget; overrides --kv-buckets; 0 = slab "
                "modes (pre-paging behavior)",
            )
            sp.add_argument(
                "--request-timeout",
                type=float,
                default=0.0,
                metavar="S",
                help="per-request wall-clock budget in seconds, counted "
                "from admission (queue time included): an expired request "
                "gets 504 and its decode row is released at the next chunk "
                "boundary; 0 = unlimited",
            )
            sp.add_argument(
                "--queue-depth",
                type=int,
                default=64,
                metavar="N",
                help="max requests in flight (decoding + waiting): overflow "
                "is rejected immediately with 429 + Retry-After instead of "
                "queuing unboundedly",
            )
            sp.add_argument(
                "--slo-classes",
                default=None,
                metavar="SPEC",
                help="per-class SLO lanes for the admission gate and "
                "batch scheduler, e.g. 'interactive:depth=48,deadline=30;"
                "batch:depth=16,resident=2'. Requests pick their lane "
                "with X-Dllama-Class (default interactive). depth bounds "
                "the lane's in-flight count (429 + lane-scoped "
                "Retry-After past it), deadline is the lane's default "
                "wall-clock budget in seconds (outranks "
                "--request-timeout), resident caps the lane's decoding "
                "rows — interactive arrivals preempt batch rows at chunk "
                "boundaries and resume them bit-identically when "
                "pressure drops. Unset = one classless lane "
                "(pre-SLO behavior). Burn-rate targets ride the same "
                "spec: ttft=MS / tpot=MS (per-class p95 latency SLO "
                "targets) and err=FRACTION (5xx error budget) arm the "
                "multi-window burn-rate alert engine behind GET /alerts",
            )
            sp.add_argument(
                "--ts-interval", type=float, default=1.0, metavar="S",
                help="metrics-history sampling cadence in seconds "
                "(see `router --ts-interval`); the sampler also drives "
                "SLO burn-rate evaluation; 0 disables both",
            )
            sp.add_argument(
                "--burn-short", type=float, default=60.0, metavar="S",
                help="short burn-rate window: an SLO alert fires only "
                "when BOTH the short and long windows burn past the "
                "threshold (short reacts, long filters blips)",
            )
            sp.add_argument(
                "--burn-long", type=float, default=300.0, metavar="S",
                help="long burn-rate window (see --burn-short)",
            )
            sp.add_argument(
                "--drain-timeout",
                type=float,
                default=30.0,
                metavar="S",
                help="SIGTERM grace: stop admitting (503), finish live "
                "requests up to S seconds, then exit",
            )
            sp.add_argument(
                "--pid-file",
                default=None,
                metavar="PATH",
                help="write the server pid here (atomic tmp+rename); "
                "removed on shutdown",
            )
            sp.add_argument(
                "--log-json",
                action="store_true",
                help="emit one structured JSON line per finished request "
                "(request id, path, TTFT/TPOT, token counts, finish "
                "reason) to stderr; prompt TEXT is never logged — only "
                "token counts and a sha256 digest — unless --log-prompts",
            )
            sp.add_argument(
                "--log-prompts",
                action="store_true",
                help="include raw prompt text in --log-json records "
                "(privacy default is OFF: logs carry counts and hashes "
                "only)",
            )
            sp.add_argument(
                "--role",
                default="both",
                choices=["prefill", "decode", "both"],
                help="disaggregation role this replica declares on /ready: "
                "'prefill' replicas serve POST /v1/prefill (prompt + first "
                "decode chunk, then export the row's KV pages on the "
                "wire), 'decode' replicas serve POST /v1/kv/import (admit "
                "the migrated row warm and stream the rest); 'both' (the "
                "default) serves end-to-end. Needs --kv-pages for the "
                "migration endpoints; the role is advisory — the router "
                "enforces placement",
            )
            sp.add_argument(
                "--ckpt-interval",
                type=int,
                default=32,
                metavar="K",
                help="mid-stream failover: default checkpoint cadence (in "
                "emitted tokens) for streams the router opts in via the "
                "X-Dllama-Ckpt header without naming its own K; 0 refuses "
                "checkpointing entirely on this replica. Checkpoints need "
                "--kv-pages (the paged pool is what export_row snapshots)",
            )
        sp.add_argument("--model", required=True)
        sp.add_argument("--tokenizer", required=True)
        sp.add_argument("--prompt", default=None)
        sp.add_argument("--steps", type=int, default=64)
        sp.add_argument("--temperature", type=float, default=0.8)
        sp.add_argument("--topp", type=float, default=0.9)
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
        sp.add_argument(
            "--cache-dtype", default=None, choices=[None, "float32", "bfloat16", "f8"],
            help="KV cache element type (default: --dtype); f8 = float8_e4m3fn")
        sp.add_argument("--system-prompt", default=None, help="chat mode system prompt")
        sp.add_argument("--chat-template", default="llama2", choices=["llama2", "llama3"])
        sp.add_argument(
            "--weights-float-type", default=None, choices=["q40", "q80", "bf16", "f16", "f32"],
            help="on-device weight storage: q40/q80 keep weights block-quantized and "
            "run that format's dequant-matmul kernel (default on the card: the model "
            "file's own q40/q80); bf16/f16/f32 dequantize at load")
        sp.add_argument(
            "--spec-draft", type=int, default=0, metavar="K",
            help="prompt-lookup speculative decoding: draft up to K tokens from the "
            "context's own history and verify them in one step (more than one token a "
            "step on repetitive text). On the CPU the tokens are plain decode's, greedy "
            "or sampled; on the card a drafted step's logits differ from plain decode's "
            "in their low bits, so greedy tokens may differ at near-ties and sampled "
            "ones more often")
        sp.add_argument(
            "--decode-chunk", type=int, default=None, metavar="N",
            help="generate mode: decode steps per host sync (default 64), each step one "
            "CUDA graph replay; the text is printed a chunk at a time and a stop token "
            "ends the run after its chunk. inference and chat read each token as it is "
            "made and do not chunk")
        if mode != "serve":
            sp.add_argument(
                "--profile", default=None, metavar="DIR",
                help="write a torch.profiler trace of the run to DIR/trace.json (Chrome "
                "trace format: host ops and, on the card, every kernel with its device "
                "time)")
        sp.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' runs the kernels' "
            "plain PyTorch versions)")
        sp.add_argument(
            "--tp", type=int, default=1,
            help="tensor-parallel ranks: one process per rank, each on its own GPU "
            "(cuda:<local rank>, NCCL) or, with --device cpu, on the CPU over gloo; 0 = every "
            "visible GPU of every host. Each rank loads its output shard of the quantized "
            "(q40/q80) weights; decode steps are eager under TP (no CUDA graphs). In chat "
            "and serve, rank 0 reads the input and hands each engine call to the other ranks")
        sp.add_argument(
            "--buffer-float-type", default=None, choices=["q80", "f32", "f16", "bf16"],
            help="q80: move the TP activation gathers as the reference's Q80 wire (int8 "
            "32-value blocks + f32 scales, ~1.8x fewer bytes than bf16); f32/f16/bf16/unset: "
            "plain gathers in the activation dtype")
        sp.add_argument(
            "--tp-overlap", action="store_true",
            help="under --tp: run a batched decode or verify step of two or more rows as two "
            "microbatches, each one's gathers and reduce hops issued asynchronously and "
            "waited on after the other's compute (same tokens; declined for MoE)")
        sp.add_argument(
            "--tp-reduce", default="off", choices=["off", "plain", "q80"],
            help="under --tp: wo/w2 row-parallel (each rank loads their K chunk) with a "
            "pinned-order ring reduce-scatter of the f32 partial sums; q80 moves each hop as "
            "the Q80 wire. Declined (with the reason) for MoE or a K chunk off the q40/q80 "
            "scale planes")
        # multi-host topology: every host runs the same command with its own
        # --host-id; rank 0 (host 0's first rank) hosts the rendezvous
        sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="rank 0's address of a multi-host TP run (torch.distributed "
                        "tcp:// rendezvous)")
        sp.add_argument("--num-hosts", type=int, default=None)
        sp.add_argument("--host-id", type=int, default=None)
    return p


def tp_plan(args, n_gpus: int):
    """Check the tensor-parallel flags against ``n_gpus`` visible GPUs and
    return this host's part of the world, or None for one rank: {"size",
    "ranks" (this process's first), "devices", "backend", "init_method"}.
    What is refused raises SystemExit with the reason."""
    hosts, host = 1, 0
    if args.coordinator is not None:
        if args.num_hosts is None or args.host_id is None:
            raise SystemExit("--coordinator requires --num-hosts and --host-id")
        hosts, host = args.num_hosts, args.host_id
        if not 0 <= host < hosts:
            raise SystemExit(f"--host-id {host} outside --num-hosts {hosts}")
    elif args.mode == "worker":
        raise SystemExit("worker mode requires --coordinator/--num-hosts/--host-id")
    cpu = args.device is not None and args.device.split(":")[0] == "cpu"
    size = args.tp if args.tp > 0 else hosts * (1 if cpu else max(n_gpus, 1))
    if size % hosts:
        raise SystemExit(f"--tp {size} does not split evenly over {hosts} hosts")
    if size == 1:
        return None
    local = size // hosts
    if not cpu and local > n_gpus:
        raise SystemExit(f"--tp {size} needs {local} GPUs on this host and {n_gpus} are "
                         f"visible: a rank never shares a card")
    from dllama_tpu_torch.parallel.group import local_init_method

    first = host * local
    return {"size": size, "ranks": range(first, first + local),
            "devices": ["cpu"] * local if cpu else [f"cuda:{i}" for i in range(local)],
            "backend": "gloo" if cpu else "nccl",
            "init_method": (f"tcp://{args.coordinator}" if args.coordinator
                            else local_init_method())}


def run_tp_rank(group, args, speaker: int, local: int):
    """One rank of a tensor-parallel run. ``inference``/``generate``/
    ``worker``: every rank runs the same command. ``chat``/``serve``: global
    rank 0 reads stdin or binds the port and hands each engine call to the
    other ranks, which replay them (``parallel.control``); returns the
    rank's control-plane report. Only ``speaker`` (this host's first rank)
    prints, and in worker mode only on host 0. The others keep their output
    back (and their ``--profile``). CPU ranks split the host's cores between
    the ``local`` ranks, unless ``OMP_NUM_THREADS`` sets each rank's."""
    if group.device.type == "cpu" and not os.environ.get("OMP_NUM_THREADS"):
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    quiet = group.rank != speaker or (args.mode == "worker" and args.host_id != 0)
    if quiet:
        args = argparse.Namespace(**{**vars(args), "profile": None})
    with open(os.devnull, "w") as sink:
        with contextlib.redirect_stdout(sink) if quiet else contextlib.nullcontext():
            if args.mode == "chat":
                return run_chat(args, tp=group)
            if args.mode == "serve":
                from dllama_tpu_torch.serving.api_server import serve

                return serve(args, tp=group)
            run_generate(args, show_stats=args.mode == "inference", tp=group)
            return None


def write_pid_file(path: str) -> None:
    """Write this process's pid to ``path`` ATOMICALLY (tmp + rename in the
    same directory): a monitor polling the file never reads a half-written
    pid, and a crash mid-write leaves the old file intact."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(f"{os.getpid()}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@contextlib.contextmanager
def profiled(profile_dir, device):
    """Trace the body with ``torch.profiler`` into ``profile_dir/trace.json``
    when ``profile_dir`` is set: the host's ops, and the card's kernels when
    ``device`` is CUDA. The trace is written even when the body fails."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"🔬 profiler trace written to {path}")


def load_engine(args, tp=None):
    """(engine, tokenizer, cfg) for ``args``; ``tp``: this process's rank of
    a tensor-parallel world (``parallel.group.TPGroup``), which loads its
    shard and whose engine gathers."""
    import torch

    from dllama_tpu_torch import resolve_device
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig, resolve_dtype
    from dllama_tpu_torch.parallel import quant_tp
    from dllama_tpu_torch.quants import blocks
    from dllama_tpu_torch.runtime.generate import DECODE_CHUNK, Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    device = tp.device if tp is not None else resolve_device(args.device)
    t0 = time.time()
    with WeightFileReader(args.model) as reader:
        cfg = ModelConfig.from_spec(reader.spec, dtype=args.dtype)
        print(f"💡 arch: {cfg.arch}  device: {device}")
        print(f"💡 dim: {cfg.dim}  hiddenDim: {cfg.hidden_dim}  nLayers: {cfg.n_layers}")
        print(f"💡 nHeads: {cfg.n_heads}  nKvHeads: {cfg.n_kv_heads}")
        print(f"💡 vocabSize: {cfg.vocab_size}  seqLen: {cfg.seq_len}")
        wft = args.weights_float_type
        if wft is None and device.type == "cuda":
            # the file's own quantized format: the dequant-matmul kernel reads
            # ~4x fewer bytes per token than bf16 weights
            wft = {blocks.Q40: "q40", blocks.Q80: "q80"}.get(reader.spec.weights_float_type)
        if tp is not None and wft not in ("q40", "q80"):
            raise SystemExit(f"--tp {tp.size} takes quantized weights: pass "
                             f"--weights-float-type q40 or q80 (dense-weight TP is "
                             f"{quant_tp.NOT_PORTED})")
        if wft in ("q40", "q80"):
            shard = "" if tp is None else f", rank {tp.rank}'s shard of {tp.size}"
            print(f"🧮 weights resident as {wft} (fused dequant-matmul kernels{shard})")
            # wo/w2 load as row shards only where the engine will run them so
            row_pack = (tp is not None and args.tp_reduce != "off"
                        and quant_tp.validate_tp_reduce(cfg, wft, tp.size) is None)
            params = llama.quant_params_from_reader(reader, cfg, device, wft, tp=tp,
                                                    tp_reduce=row_pack)
        else:
            dense = {"bf16": torch.bfloat16, "f16": torch.float16,
                     "f32": torch.float32}.get(wft)
            params = llama.params_from_reader(reader, cfg, device, dtype=dense)
    print(f"⏩ loaded weights in {time.time() - t0:.1f}s")

    tok = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    if tp is not None:  # every rank must sample with rank 0's seed
        seed = tp.broadcast_object(seed)
    sampler_cfg = SamplerConfig(temperature=args.temperature, topp=args.topp, seed=seed)
    cache_dtype = resolve_dtype(args.cache_dtype, default=args.dtype)
    compress = args.buffer_float_type == "q80"
    if compress and tp is None:
        print("⚠️  --buffer-float-type q80 applies to the gathers of --tp > 1; none run here")
    if args.tp_overlap and tp is None:
        print("⚠️  --tp-overlap needs --tp > 1 with quantized weights (q40/q80); running "
              "monolithic TP programs")
    if args.tp_reduce != "off" and tp is None:
        print("⚠️  --tp-reduce needs --tp > 1 with quantized weights (q40/q80); running "
              "gather-only TP programs")
    # an explicit 0 must reach Engine's own validation, not become the default
    chunk = args.decode_chunk
    engine = Engine(cfg, params, sampler_cfg, cache_dtype=cache_dtype, device=device,
                    decode_chunk=DECODE_CHUNK if chunk is None else chunk, tp=tp,
                    tp_compress=compress, tp_overlap=args.tp_overlap, tp_reduce=args.tp_reduce)
    if tp is not None:
        overlap = ", microbatch overlap" if engine.tp_overlap_active else ""
        reduce_ = (f", row-parallel {engine.tp_reduce} reduce" if engine.tp_reduce_active
                   else "")
        print(f"🔗 tensor-parallel over {tp.size} devices ({tp.backend}, {engine.tp_wire} "
              f"wire{overlap}{reduce_}; eager decode steps: no CUDA graphs under TP)")
    return engine, tok, cfg


def run_generate(args, show_stats: bool, tp=None) -> None:
    engine, tok, _cfg = load_engine(args, tp)
    prompt = args.prompt if args.prompt is not None else "Hello"
    tokens = tok.encode(prompt, add_bos=True)
    print(f"📄 prompt tokens: {len(tokens)}")
    with profiled(args.profile, engine.device):
        _generate(args, show_stats, engine, tok, tokens)


def _generate(args, show_stats: bool, engine, tok, tokens: list) -> None:
    prev = tokens[-1]
    produced = []
    # incremental decode: multi-byte chars can span byte-fallback tokens
    utf8 = codecs.getincrementaldecoder("utf-8")("replace")

    def emit(tok_id: int) -> None:
        nonlocal prev
        sys.stdout.write(utf8.decode(tok.decode_piece(prev, tok_id)))
        prev = tok_id
        produced.append(tok_id)

    if not show_stats and not args.spec_draft:
        # fused chunks: one host sync and one print per chunk
        def on_chunk(ids):
            for tok_id in ids:
                emit(tok_id)
            sys.stdout.flush()

        _, prefill_ms, decode_ms = engine.generate_fused(
            tokens, args.steps, stop_tokens=(tok.eos_id,), on_chunk=on_chunk)
        sys.stdout.write(utf8.decode(b"", True))
        print()
        print(f"Token ids:           {' '.join(map(str, produced))}")
        if produced:
            decoded = len(produced) - (len(tokens) > 1)
            print(f"Generated tokens:    {len(produced)}")
            if decoded:
                avg = decode_ms / decoded
                print(f"Avg tokens / second: {1000.0 / avg:.2f}")
                print(f"Avg generation time: {avg:.2f} ms (chunks of {engine.decode_chunk}, "
                      f"one host sync each)")
            print(f"Prefill time:        {prefill_ms:.2f} ms ({len(tokens)} tokens)")
        return

    gen_ms = []
    inf_ms = []
    if args.spec_draft:
        stream = engine.generate_spec(tokens, args.steps, stop_tokens=(tok.eos_id,),
                                      draft_len=args.spec_draft)
    else:
        stream = engine.generate(tokens, args.steps, stop_tokens=(tok.eos_id,))
    for tok_id, stats in stream:
        emit(tok_id)
        sys.stdout.flush()
        gen_ms.append(stats.generation_ms)
        inf_ms.append(stats.inference_ms)
        if show_stats:
            line = (f"  🔶 G {stats.generation_ms:7.2f} ms I {stats.inference_ms:7.2f} ms "
                    f"T {stats.transfer_ms:7.2f} ms")
            if stats.sent_kb:  # the reference's S/R columns: this rank's gather bytes
                line += f" S {stats.sent_kb:7.1f} kB R {stats.recv_kb:7.1f} kB"
            sys.stdout.write(line + "\n")
    sys.stdout.write(utf8.decode(b"", True))
    print()
    print(f"Token ids:           {' '.join(map(str, produced))}")
    if gen_ms:
        # skip the first token (prefill) in the average, like the reference
        steady = gen_ms[1:] if len(gen_ms) > 1 else gen_ms
        steady_inf = inf_ms[1:] if len(inf_ms) > 1 else inf_ms
        avg = sum(steady) / len(steady)
        avg_inf = sum(steady_inf) / len(steady_inf)
        print(f"Generated tokens:    {len(produced)}")
        print(f"Avg tokens / second: {1000.0 / avg:.2f}")
        print(f"Avg generation time: {avg:.2f} ms")
        print(f"Avg inference time:  {avg_inf:.2f} ms (device wait)")
        print(f"Avg transfer time:   {avg - avg_inf:.2f} ms (host+launch)")
        print(f"Prefill time:        {engine.prefill_ms:.2f} ms ({len(tokens)} tokens)")


def run_chat(args, tp=None):
    """``chat`` mode. ``tp``: this process's rank of a tensor-parallel world;
    rank 0 chats over ``parallel.control.TPEngine`` (only it reads stdin)
    and every other rank replays its engine calls. Returns the rank's
    control-plane report under TP."""
    engine, tok, cfg = load_engine(args, tp)

    def run(eng) -> None:
        with profiled(args.profile, eng.device):
            _chat(args, eng, tok, cfg)

    if tp is None:
        return run(engine)
    from dllama_tpu_torch.parallel import control

    return control.lead(engine, tp, run)


def _chat(args, engine, tok, cfg) -> None:
    from dllama_tpu_torch.serving.templates import render_llama2_turn, render_llama3_chat

    system = args.system_prompt
    if system is None:
        system = input("💻 Enter system prompt (optional): ")
    session = None
    consumed: list = []  # every token fed or emitted so far; the pending one last
    while True:
        try:
            user = input("👱 User: ")
        except EOFError:
            break
        first = session is None
        used = session.pos if session else 0
        if args.chat_template == "llama3":
            turn = [{"role": "user", "content": user}]
            if first and system:
                turn.insert(0, {"role": "system", "content": system})
            rendered = render_llama3_chat(turn)
        else:
            rendered = render_llama2_turn(user, system or "", first)
        tokens = tok.encode(rendered, add_bos=first)
        if used + len(tokens) + 2 > cfg.seq_len:
            print("(context window exhausted)")
            break
        print("🤖 Assistant: ", end="", flush=True)
        prev = tokens[-1]
        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        if args.spec_draft:
            # the n-gram index drafts from the whole conversation so far
            stream = engine.generate_spec(tokens, args.steps, session=session,
                                          stop_tokens=(tok.eos_id,), draft_len=args.spec_draft,
                                          history=consumed[:-1] if session else None)
        else:
            stream = engine.generate(tokens, args.steps, session=session,
                                     stop_tokens=(tok.eos_id,))
        consumed.extend(tokens)
        for tok_id, _ in stream:
            consumed.append(tok_id)
            if tok_id == tok.eos_id:
                continue  # the generator stops itself after a stop token
            print(utf8.decode(tok.decode_piece(prev, tok_id)), end="", flush=True)
            prev = tok_id
        print(utf8.decode(b"", True))
        session = engine.final_session
        if session.pos >= cfg.seq_len - 1:
            print("(context window exhausted)")
            break


def run_verify(args) -> int:
    """``verify`` mode: open + fully checksum a `.m` file, exit 0/1.

    Three outcomes:
    * structural rejection (truncated/hostile file) — the open itself
      raises, we print the FormatError (which names the first bad tensor
      and byte offset for truncation) and exit 1;
    * checksum mismatch — the report names every failing tensor with its
      byte offset and both CRCs, first corrupt tensor first; exit 1;
    * clean — exit 0 (a legacy file without an integrity section passes
      with the size/offset guarantee only, and says so).

    ``--shard I/N`` restricts the check to host I's row stripe (the bytes
    that host would actually map under N-way tensor parallelism), using the
    DLRB row-band table when the file carries one.
    """
    import json as json_mod

    from dllama_tpu_torch.formats.spec import FormatError
    from dllama_tpu_torch.formats.weights import WeightFileReader

    shard = None
    if getattr(args, "shard", None):
        try:
            i, n = (int(v) for v in args.shard.split("/", 1))
            if not 0 <= i < n:
                raise ValueError
        except ValueError:
            print(f"❌ bad --shard {args.shard!r}: want I/N with 0 <= I < N")
            return 1
        shard = (i, n)
    try:
        with WeightFileReader(args.model) as reader:
            report = reader.verify(shard=shard)
    except FormatError as e:
        if args.json:
            print(json_mod.dumps(
                {"path": args.model, "ok": False, "error": str(e)}))
        else:
            print(f"❌ {args.model}: {e}")
        return 1
    if args.json:
        print(json_mod.dumps(report))
        return 0 if report["ok"] else 1
    if not report["has_integrity"]:
        print(f"⚠️  {args.model}: no integrity section (legacy file) — "
              f"size/offset layout of {report['tensors']} tensors "
              f"({report['payload_bytes']} payload bytes) is consistent, "
              "but payload bytes are UNVERIFIED")
        return 0
    if report["ok"]:
        if shard is not None:
            print(f"✅ {args.model}: shard {report['shard']} — "
                  f"{report.get('bands_checked', 0)} row bands checked "
                  f"({report['tensors']} tensors), all checksums OK")
        else:
            print(f"✅ {args.model}: {report['tensors']} tensors, "
                  f"{report['payload_bytes']} payload bytes, all checksums OK")
        return 0
    for f in report["failures"]:
        where = (f" row band {f['band']}" if "band" in f else "")
        print(f"❌ {args.model}: tensor {f['name']!r}{where} corrupt at byte "
              f"offset {f['offset']} ({f['nbytes']} bytes): stored "
              f"crc32 {f['expected_crc32']}, "
              f"computed {f['actual_crc32']}")
    print(f"{len(report['failures'])} of {report['tensors']} tensors failed")
    return 1


def _top_get(host: str, port: int, path: str, timeout_s: float = 2.0):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _top_fleet_families(text: str) -> dict:
    """Fold a /metrics/fleet exposition into
    {(family, replica): value}, summing counter series and histogram
    ``_sum``/``_count`` lines across their remaining labels."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if not head:
            continue
        name, _, labels = head.partition("{")
        replica = None
        for part in labels.rstrip("}").split(","):
            if part.startswith('replica="'):
                replica = part[len('replica="'):].rstrip('"')
        if name.endswith("_bucket"):
            continue
        try:
            v = float(value)
        except ValueError:
            continue  # a non-numeric sample (foreign exposition noise)
            #           must not kill a read-only dashboard loop
        key = (name, replica)
        out[key] = out.get(key, 0.0) + v
    return out


def _top_class_series(text: str, families: tuple) -> dict:
    """Fold the named per-class families of a /metrics/fleet exposition
    into {(family, replica, slo_class): value}. The plain families fold
    (:func:`_top_fleet_families`) SUMS across non-replica labels — exactly
    wrong for lane gauges, where interactive and batch pressure must stay
    distinguishable."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        if name not in families:
            continue
        replica = slo_class = None
        for part in labels.rstrip("}").split(","):
            if part.startswith('replica="'):
                replica = part[len('replica="'):].rstrip('"')
            elif part.startswith('slo_class="'):
                slo_class = part[len('slo_class="'):].rstrip('"')
        try:
            out[(name, replica, slo_class)] = float(value)
        except ValueError:
            continue  # a torn exposition line (replica died mid-write):
            #           skip the sample, the next scrape heals the cell
    return out


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _spark(values, width: int = 24) -> str:
    """A unicode sparkline of the last ``width`` values (min..max scaled;
    flat series render as a flat low line)."""
    vals = [v for v in values if v is not None][-width:]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK_GLYPHS[int((v - lo) / span * (len(_SPARK_GLYPHS) - 1))]
        for v in vals)


def run_top(args) -> int:
    """``cli top``: a refreshing terminal view of the fleet — per-replica
    rotation/load from the router's /stats, per-replica request counters
    and latency means from /metrics/fleet, firing SLO alerts from
    /alerts and TTFT-p95 sparklines from /metrics/history. Read-only;
    safe against a half-up fleet (unreachable router prints a retry
    line, pre-observability routers just lose the alert/spark rows)."""
    import json as json_mod

    from dllama_tpu_torch.serving.protocol import (MET_CLASS_QUEUE_DEPTH,
                                             MET_CLASS_RESIDENT_ROWS,
                                             MET_FLEET_REPLICAS,
                                             MET_HTTP_REQUESTS,
                                             MET_KV_TRANSFER_BYTES,
                                             MET_SCALE_EVENTS,
                                             MET_TPOT_MS, MET_TTFT_MS)

    host, _, port_s = args.router.rpartition(":")
    if not host or not port_s.isdigit():
        raise SystemExit(f"bad --router {args.router!r}: want HOST:PORT")
    port = int(port_s)
    n = 0
    # last-seen dllama_kv_transfer_bytes_total per replica (value, t): the
    # KV-handoff column is a RATE, so it needs the previous refresh
    kv_prev: dict = {}
    try:
        while True:
            n += 1
            now = time.monotonic()
            lines = []
            try:
                _, stats_body = _top_get(host, port, "/stats")
                stats = json_mod.loads(stats_body)
                code, fleet_body = _top_get(host, port, "/metrics/fleet")
                fleet_text = (fleet_body.decode("utf-8", "replace")
                              if code == 200 else "")
                fams = _top_fleet_families(fleet_text)
                # lane gauges keep their slo_class label (a summed fold
                # would blur interactive and batch pressure together)
                lanes = _top_class_series(
                    fleet_text, (MET_CLASS_QUEUE_DEPTH,
                                 MET_CLASS_RESIDENT_ROWS))
                load = stats.get("load") or {}
                lines.append(
                    f"dllama top — router {args.router}  "
                    f"up {stats.get('uptime_s', 0):.0f}s  "
                    f"replicas {load.get('replicas_ready', '?')}/"
                    f"{load.get('replicas_total', '?')} ready  "
                    f"affinity {stats.get('affinity_entries', 0)}")
                # elastic fleet row: registered size + scale-event
                # counters, rendered only when the router exposes the
                # families (pre-elastic routers just omit the row); every
                # value parse is guarded — a torn /stats body mid-scale
                # must degrade a cell, never kill the dashboard loop
                mets = stats.get("metrics") or {}

                def fam_values(fam):
                    return (mets.get(fam) or {}).get("values") or []

                size_vals = fam_values(MET_FLEET_REPLICAS)
                if size_vals:
                    try:
                        size = f"{float(size_vals[0].get('value')):.0f}"
                    except (TypeError, ValueError):
                        size = "?"
                    events = {}
                    for v in fam_values(MET_SCALE_EVENTS):
                        ev = (v.get("labels") or {}).get("event")
                        try:
                            events[ev] = int(float(v.get("value")))
                        except (TypeError, ValueError):
                            continue  # torn stats value: drop this cell
                    marks = "  ".join(
                        f"{ev} {events[ev]}"
                        for ev in ("joined", "draining", "retired",
                                   "spawn_failed", "prewarm_fallback",
                                   "drain_killed", "injected")
                        if events.get(ev))
                    lines.append(f"elastic: {size} registered  "
                                 + (marks or "no scale events yet"))
                lines.append("")
                lines.append(
                    f"{'replica':<22}{'role':<9}{'state':<10}{'infl':>5}"
                    f"{'occ':>8}{'queue':>7}{'q i/b':>8}{'res i/b':>9}"
                    f"{'kv_free':>9}{'probe_age':>11}"
                    f"{'reqs':>8}{'ttft_ms':>9}{'tpot_ms':>9}"
                    f"{'kv_kB/s':>9}")
                for snap in load.get("replicas") or []:
                    name = snap.get("name", "?")
                    state = ("circuit" if snap.get("circuit_open")
                             else "ready" if snap.get("ready") else "down")
                    # a mid-transition lifecycle outranks the probe
                    # verdict in the column: joining/draining is WHY the
                    # replica isn't taking normal traffic
                    lc = snap.get("state")
                    if lc and lc != "active":
                        state = lc
                    rload = snap.get("load") or {}
                    age = snap.get("probed_age_s")

                    def mean(fam):
                        s = fams.get((f"{fam}_sum", name))
                        c = fams.get((f"{fam}_count", name))
                        return f"{s / c:.1f}" if s is not None and c else "-"

                    def lane_pair(fam):
                        # "i/b": the replica's interactive vs batch value
                        # of a lane gauge; "-" until the replica exposes
                        # per-class series (mixed-version fleets)
                        i = lanes.get((fam, name, "interactive"))
                        b = lanes.get((fam, name, "batch"))
                        if i is None and b is None:
                            return "-"
                        return f"{int(i or 0)}/{int(b or 0)}"

                    reqs = fams.get((MET_HTTP_REQUESTS, name))
                    # KV handoff wire rate (in+out summed — the families
                    # fold summed their direction label): delta since the
                    # previous refresh of this replica's bytes counter
                    kv_bytes = fams.get((MET_KV_TRANSFER_BYTES, name))
                    kv_rate = "-"
                    if kv_bytes is not None:
                        last = kv_prev.get(name)
                        kv_prev[name] = (kv_bytes, now)
                        if last is not None and now > last[1]:
                            kv_rate = "{:.1f}".format(
                                (kv_bytes - last[0]) / 1024.0
                                / (now - last[1]))
                    lines.append(
                        f"{name:<22}{snap.get('role', 'both'):<9}{state:<10}"
                        f"{snap.get('inflight', 0):>5}"
                        f"{rload.get('slots_occupied', 0):>4}/"
                        f"{rload.get('slots_total', 0):<3}"
                        f"{rload.get('queue_depth', 0):>7}"
                        f"{lane_pair(MET_CLASS_QUEUE_DEPTH):>8}"
                        f"{lane_pair(MET_CLASS_RESIDENT_ROWS):>9}"
                        f"{rload.get('kv_pages_free', '-'):>9}"
                        f"{(f'{age:.1f}s' if age is not None else '-'):>11}"
                        f"{(f'{reqs:.0f}' if reqs is not None else '-'):>8}"
                        f"{mean(MET_TTFT_MS):>9}"
                        f"{mean(MET_TPOT_MS):>9}"
                        f"{kv_rate:>9}")
                # the SLO burn-rate picture: every firing alert gets its
                # own row; pre-observability routers 404 -> row omitted
                code, alerts_body = _top_get(host, port, "/alerts")
                if code == 200:
                    alerts = json_mod.loads(alerts_body)
                    firing = [
                        (rname, a)
                        for rname, pay in (alerts.get("replicas")
                                           or {}).items()
                        for a in pay.get("alerts") or []
                        if a.get("state") == "firing"]
                    lines.append("")
                    if firing:
                        for rname, a in firing:
                            lines.append(
                                f"🔥 SLO {a.get('slo', '?'):<18}"
                                f"{rname:<22}burn "
                                f"{a.get('short_burn', 0):.2f}/"
                                f"{a.get('long_burn', 0):.2f} "
                                f"(short/long, fires >"
                                f"{alerts.get('threshold', 1.0):g})")
                    else:
                        lines.append("alerts: none firing")
                # TTFT p95 sparkline per replica, from the federated
                # time-series history (empty until samplers have data)
                code, hist_body = _top_get(
                    host, port, "/metrics/history?window=120")
                if code == 200:
                    hist = json_mod.loads(hist_body)
                    spark_key = f"{MET_TTFT_MS}:p95"
                    rows = []
                    # fleet-size trajectory from the router's OWN series
                    # (the registered-replica gauge is router state, so it
                    # lives under "router", not any replica)
                    rseries = ((hist.get("router") or {}).get("series")
                               or {})
                    fpts = rseries.get(MET_FLEET_REPLICAS)
                    if fpts:
                        try:
                            rows.append(
                                f"  {'fleet size':<22}replicas "
                                f"{_spark([p[1] for p in fpts])} "
                                f"{float(fpts[-1][1]):.0f}")
                        except (TypeError, ValueError, IndexError):
                            pass  # torn history payload: drop the row
                    for rname, pay in sorted(
                            (hist.get("replicas") or {}).items()):
                        pts = (pay.get("series") or {}).get(spark_key)
                        if pts:
                            rows.append(f"  {rname:<22}ttft_p95 "
                                        f"{_spark([p[1] for p in pts])} "
                                        f"{pts[-1][1]:.1f}ms")
                    if rows:
                        lines.append("")
                        lines.extend(rows)
            except (OSError, ValueError) as e:
                lines = [f"dllama top — router {args.router} "
                         f"unreachable ({e}); retrying..."]
            sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines) + "\n")
            sys.stdout.flush()
            if args.iterations and n >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0  # ^C is how an interactive top session ends: clean exit


def run_explain(args) -> int:
    """``cli explain <request-id>``: join the request's trace spans
    (replica phases + router hops) and flight-recorder events into one
    phase waterfall. Pure file reader — nothing needs to be running."""
    import json as json_mod

    from dllama_tpu_torch.obsv import forensics

    if not args.trace and not args.flight:
        print("❌ explain needs at least one --trace or --flight input "
              "(the DLLAMA_TRACE file / a saved /debug/flight body)")
        return 1
    wf = forensics.build_waterfall(
        args.request_id,
        forensics.load_trace_events(args.trace),
        forensics.load_flight_events(args.flight))
    if args.json:
        print(json_mod.dumps(wf, indent=2))
        return 0 if (wf["rows"] or wf["events"]) else 1
    print(forensics.render_waterfall(wf, width=args.width))
    return 0 if (wf["rows"] or wf["events"]) else 1


def run_snapshot(args) -> int:
    """``cli snapshot``: one support-bundle tarball of a running fleet —
    /metrics, /metrics/history, /stats, /alerts and /debug/flight from
    the router plus every replica the router knows, and the newest trace
    part per replica when --trace-dir is given. Unreachable targets
    contribute an error note, never abort the bundle."""
    import io
    import json as json_mod
    import tarfile

    from dllama_tpu_torch.obsv import forensics

    host, _, port_s = args.router.rpartition(":")
    if not host or not port_s.isdigit():
        raise SystemExit(f"bad --router {args.router!r}: want HOST:PORT")
    out_path = args.out or f"dllama-snapshot-{int(time.time())}.tar.gz"
    paths = ("/metrics", f"/metrics/history?window={args.window:g}",
             "/stats", "/alerts", "/debug/flight")

    targets = [("router", host, int(port_s))]
    try:
        _, stats_body = _top_get(host, int(port_s), "/stats")
        stats = json_mod.loads(stats_body)
        for snap in (stats.get("load") or {}).get("replicas") or []:
            name = snap.get("name") or ""
            rhost, _, rport = name.rpartition(":")
            if rhost and rport.isdigit():
                targets.append((name.replace(":", "-"), rhost, int(rport)))
    except (OSError, ValueError) as e:
        print(f"⚠️  router {args.router} unreachable ({e}); bundling "
              "router errors only")

    n_ok = 0
    with tarfile.open(out_path, "w:gz") as tar:

        def add(arcname: str, data: bytes) -> None:
            info = tarfile.TarInfo(arcname)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))

        for tname, thost, tport in targets:
            errors = []
            for path in paths:
                fname = (path.split("?", 1)[0].strip("/")
                         .replace("/", "-") or "root")
                try:
                    code, body = _top_get(thost, tport, path,
                                          timeout_s=5.0)
                except (OSError, ValueError) as e:
                    errors.append(f"GET {path}: {e}")
                    continue
                if code != 200:
                    errors.append(f"GET {path}: HTTP {code}")
                    continue
                add(f"{tname}/{fname}", body)
                n_ok += 1
            if errors:
                add(f"{tname}/error.txt",
                    ("\n".join(errors) + "\n").encode())
        if args.trace_dir:
            seen = set()
            # per-replica part (fleet names them .replica-<port>) plus
            # the newest file overall (the merged/solo trace)
            hints = [None] + [str(t[2]) for t in targets[1:]]
            for hint in hints:
                p = forensics.newest_trace_part(args.trace_dir, hint=hint)
                if p and p not in seen:
                    seen.add(p)
                    try:
                        with open(p, "rb") as fh:
                            add(f"trace/{os.path.basename(p)}", fh.read())
                    except OSError:
                        pass  # a part rotating away mid-bundle is fine
    print(f"📦 {out_path}: {n_ok} document(s) from {len(targets)} "
          f"target(s)")
    return 0 if n_ok else 1


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "verify":  # a host-side file check: no device
        raise SystemExit(run_verify(args))
    # the fleet's control plane: stdlib only, dispatched before torch is
    # imported, so a router runs on a host with no GPU and the supervisor
    # holds no CUDA context beside its replicas
    if args.mode == "router":
        from dllama_tpu_torch.serving.router import run_router

        run_router(args)
        return
    if args.mode == "fleet":  # the replicas import torch in their own processes
        from dllama_tpu_torch.serving.fleet import run_fleet

        run_fleet(args)
        return
    if args.mode == "top":  # read-only observer: HTTP polling
        raise SystemExit(run_top(args))
    if args.mode == "explain":  # offline join over trace and flight files
        raise SystemExit(run_explain(args))
    if args.mode == "snapshot":  # read-only observer + tarfile
        raise SystemExit(run_snapshot(args))
    import torch

    plan = tp_plan(args, torch.cuda.device_count())
    if plan is not None:
        from dllama_tpu_torch.parallel.group import launch

        launch(run_tp_rank, plan["ranks"], plan["size"], backend=plan["backend"],
               devices=plan["devices"], init_method=plan["init_method"],
               args=(args, plan["ranks"][0], len(plan["ranks"])))
        return
    if args.mode == "serve":
        from dllama_tpu_torch.serving.api_server import serve

        serve(args)
    elif args.mode == "chat":
        run_chat(args)
    else:  # inference, generate, and worker mode's one-rank host
        run_generate(args, show_stats=args.mode == "inference")


if __name__ == "__main__":
    main()
