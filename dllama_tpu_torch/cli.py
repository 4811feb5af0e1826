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
"""

from __future__ import annotations

import argparse
import codecs
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama_tpu_torch")
    sub = p.add_subparsers(dest="mode", required=True)
    for mode in ("inference", "generate", "chat"):
        sp = sub.add_parser(mode)
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
        sp.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' runs the kernels' "
            "plain PyTorch versions)")
    return p


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
    from dllama_tpu_torch.serving.templates import render_llama2_turn, render_llama3_chat

    engine, tok, cfg = load_engine(args)
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "chat":
        run_chat(args)
    else:
        run_generate(args, show_stats=args.mode == "inference")


if __name__ == "__main__":
    main()
