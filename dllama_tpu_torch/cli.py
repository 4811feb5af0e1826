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
with the JAX package's flags and defaults. Before it loads the model it
refuses the configurations the port does not run yet (``--kv-pages``,
``--role prefill|decode``, ``--batch-window`` with ``--kv-buckets 1``).
``verify`` checks a `.m` file's integrity checksums without a model or a
device:

    python -m dllama_tpu_torch.cli serve --model m.m --tokenizer t.t --port 8189 \\
        --batch-window 30 --kv-buckets 0
    python -m dllama_tpu_torch.cli verify --model m.m
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
    for mode in ("inference", "generate", "chat", "serve"):
        sp = sub.add_parser(mode)
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
                "modes (pre-paging behavior). Not ported yet: > 0 is refused at start",
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
                "enforces placement. Not ported yet: prefill and decode are refused "
                "at start",
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
    return p


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


def load_engine(args):
    import torch

    from dllama_tpu_torch import resolve_device
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig, resolve_dtype
    from dllama_tpu_torch.quants import blocks
    from dllama_tpu_torch.runtime.generate import DECODE_CHUNK, Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    device = resolve_device(args.device)
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
        if wft in ("q40", "q80"):
            print(f"🧮 weights resident as {wft} (fused dequant-matmul kernels)")
            params = llama.quant_params_from_reader(reader, cfg, device, wft)
        else:
            dense = {"bf16": torch.bfloat16, "f16": torch.float16,
                     "f32": torch.float32}.get(wft)
            params = llama.params_from_reader(reader, cfg, device, dtype=dense)
    print(f"⏩ loaded weights in {time.time() - t0:.1f}s")

    tok = Tokenizer.from_file(args.tokenizer)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler_cfg = SamplerConfig(temperature=args.temperature, topp=args.topp, seed=seed)
    cache_dtype = resolve_dtype(args.cache_dtype, default=args.dtype)
    # an explicit 0 must reach Engine's own validation, not become the default
    chunk = args.decode_chunk
    engine = Engine(cfg, params, sampler_cfg, cache_dtype=cache_dtype, device=device,
                    decode_chunk=DECODE_CHUNK if chunk is None else chunk)
    return engine, tok, cfg


def run_generate(args, show_stats: bool) -> None:
    engine, tok, _cfg = load_engine(args)
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
            sys.stdout.write(f"  🔶 G {stats.generation_ms:7.2f} ms "
                             f"I {stats.inference_ms:7.2f} ms "
                             f"T {stats.transfer_ms:7.2f} ms\n")
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


def run_chat(args) -> None:
    engine, tok, cfg = load_engine(args)
    with profiled(args.profile, engine.device):
        _chat(args, engine, tok, cfg)


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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "verify":  # a host-side file check: no device
        raise SystemExit(run_verify(args))
    if args.mode == "serve":
        from dllama_tpu_torch.serving.api_server import serve

        serve(args)
    elif args.mode == "chat":
        run_chat(args)
    else:
        run_generate(args, show_stats=args.mode == "inference")


if __name__ == "__main__":
    main()
