"""Train, convert, serve: a tiny byte-level Llama trained with the port's own
training step, written as a Q40 `.m` file, and served back (the port of
``scripts/train_tiny_e2e.py``).

    python -m dllama_tpu_torch.train_tiny_e2e [outdir] [--steps N] [--no-cli]
                                              [--device cpu]

The model memorises an embedded corpus (the Macbeth soliloquy the
reference's determinism example feeds): AdamW under a warmup-cosine
schedule on every 192-token window of the wrapped corpus (and a BOS-led
twin of each), stopping once a read loss is under 0.012. The weights go
through the port's `.m` writer as Q40 (and an f32 twin), a byte-fallback
`.t` tokenizer beside them; then ``Engine.generate_fused`` on the Q40 file
and ``python -m dllama_tpu_torch.cli generate`` as a subprocess (started
first, so that it loads while the engine serves) must each continue a 100-token corpus prefix with at least 95 % of the next 85
tokens. On the card the served file runs the Q40 decode kernels (K1, K4,
K5; their in-process launch counts go to the result).

Writes ``outdir/tiny.m``, ``tiny_f32.m``, ``tiny.t`` and
``e2e_result.json``; exits 0 only when every gate that ran passed. On the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

CORPUS = (
    "Tomorrow, and tomorrow, and tomorrow, creeps in this petty pace "
    "from day to day, to the last syllable of recorded time; and all our "
    "yesterdays have lighted fools the way to dusty death. Out, out, brief "
    "candle! Life's but a walking shadow, a poor player that struts and "
    "frets his hour upon the stage, and then is heard no more. It is a tale "
    "told by an idiot, full of sound and fury, signifying nothing. "
)

#: prompt/expected split shared by the in-process and CLI gates (tokens of
#: one full-corpus encoding; the byte vocab maps token n to CORPUS[n - 1])
N_PROMPT, N_STEPS = 100, 85
#: the trained window: generation stays within prompt + steps <= T
WINDOW = 192
BATCH = 8
#: the loss under which the corpus counts as memorised
STOP_LOSS = 0.012
#: the share of the expected continuation each gate needs as a prefix
GATE = 0.95


def build_byte_tokenizer(path: str):
    """A `.t` file of 3 specials and the 256 byte tokens (byte fallback
    only: no merges are needed to memorise a text)."""
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer

    vocab = [b"<unk>", b"<s>", b"</s>"] + [bytes([i]) for i in range(256)]
    tok = TokenizerData(vocab=vocab, scores=[0.0] * len(vocab), bos_id=1, eos_id=2)
    write_tokenizer(path, tok)
    return tok


def windows(corpus_ids: list, bos: int):
    """Every WINDOW-token window of the wrapped corpus and a BOS-led twin
    of each (generation feeds BOS + prompt), as an int32 array."""
    import numpy as np

    stream = corpus_ids * (2 + (WINDOW * 8) // len(corpus_ids))
    out = []
    for start in range(len(corpus_ids)):
        w = stream[start:start + WINDOW]
        if len(w) == WINDOW:
            out.append(w)
            out.append([bos] + w[:-1])
    return np.asarray(out, dtype=np.int32)


def prefix_match(got: list, want: list) -> int:
    n = 0
    for a, b in zip(got, want):
        if a != b:
            break
        n += 1
    return n


def start_cli(outdir: str, device: str) -> subprocess.Popen:
    """Start ``cli generate`` on the written files as a user runs it (f32
    activations; on the CPU the Q40 plain versions); :func:`cli_gate`
    reads it."""
    argv = [sys.executable, "-m", "dllama_tpu_torch.cli", "generate",
            "--model", os.path.join(outdir, "tiny.m"),
            "--tokenizer", os.path.join(outdir, "tiny.t"),
            "--prompt", CORPUS[:N_PROMPT - 1], "--steps", str(N_STEPS), "--temperature", "0",
            "--dtype", "float32"]
    if device == "cpu":
        argv += ["--device", "cpu", "--weights-float-type", "q40"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def cli_gate(proc: subprocess.Popen) -> bool:
    """The 95 % prefix gate on the started ``cli generate``'s text."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    expected = CORPUS[N_PROMPT - 1:N_PROMPT - 1 + N_STEPS]
    ok = proc.returncode == 0 and expected[:int(GATE * len(expected))] in stdout
    print(f"CLI generate: rc={proc.returncode} match={ok}")
    if not ok:
        print(stdout[-1500:])
        print(stderr[-1500:])
    return ok


def write_files(params: dict, spec, m_path: str, f32_path: str) -> None:
    """The trained params as a Q40 `.m` file and its f32 twin."""
    import numpy as np

    from dllama_tpu_torch.formats.weights import tensor_plan, write_model
    from dllama_tpu_torch.quants import blocks

    def host(t):
        return t.detach().float().cpu().numpy()

    tensors = {"token_embedding": host(params["embedding"]),
               "rms_final": host(params["rms_final"]), "wcls": host(params["wcls"]).T}
    for i in range(spec.n_layers):
        for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            tensors[f"layers.{i}.{name}"] = host(params["layers"][name][i]).T
        for name in ("rms_att", "rms_ffn"):
            tensors[f"layers.{i}.{name}"] = host(params["layers"][name][i])
    for path, s in ((m_path, spec), (f32_path, dataclasses.replace(
            spec, weights_float_type=blocks.F32, header_size=0))):
        write_model(path, s, {e.name: np.ascontiguousarray(tensors[e.name]).reshape(-1)
                              for e in tensor_plan(s)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default="build/train_tiny_e2e")
    ap.add_argument("--steps", type=int, default=2500, help="max train steps")
    ap.add_argument("--no-cli", action="store_true",
                    help="skip the CLI subprocess drive (in-process check only)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    import numpy as np
    import torch

    from dllama_tpu_torch import kernels, resolve_device
    from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
    from dllama_tpu_torch.formats.tokenizer_file import read_tokenizer
    from dllama_tpu_torch.formats.weights import WeightFileReader
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.quants import blocks
    from dllama_tpu_torch.runtime import train
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    dev = resolve_device(args.device)
    t_path = os.path.join(args.outdir, "tiny.t")
    m_path = os.path.join(args.outdir, "tiny.m")
    f32_path = os.path.join(args.outdir, "tiny_f32.m")
    build_byte_tokenizer(t_path)
    tokenizer = Tokenizer(read_tokenizer(t_path))

    # tiny but real: dim and hidden multiples of 64, so Q40 packs them
    spec = ModelSpec(arch=ArchType.LLAMA, dim=256, hidden_dim=704, n_layers=4, n_heads=8,
                     n_kv_heads=4, vocab_size=tokenizer.vocab_size, seq_len=256,
                     weights_float_type=blocks.Q40)
    cfg = ModelConfig.from_spec(spec, dtype="float32")
    corpus_ids = tokenizer.encode(CORPUS, add_bos=False)
    bos = tokenizer.bos_id
    data = windows(corpus_ids, bos)
    print(f"corpus: {len(CORPUS)} chars -> {len(corpus_ids)} byte tokens; "
          f"train windows {data.shape}; device {dev}")

    params = train.trainable(llama.random_params(cfg, seed=0, device=dev))
    opt = torch.optim.AdamW(train.leaves(params), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, train.warmup_cosine_decay_schedule(
        0.0, 3e-3, 50, args.steps, 3e-4))
    step = train.make_train_step(cfg)
    # the windows and every step's draws (numpy's, one per step as the JAX
    # script draws them) go to the device once: no host copy, so no sync,
    # inside the loop
    windows_dev = torch.from_numpy(data).to(dev)
    picks = torch.from_numpy(np.random.default_rng(0).integers(0, len(data),
                                                                (args.steps, BATCH))).to(dev)
    t0 = time.perf_counter()
    first_loss = loss = None
    steps_run = 0
    for i in range(args.steps):
        loss = step(params, opt, windows_dev[picks[i]])
        sched.step()
        steps_run = i + 1
        # one host read every 50 steps: a read a step would serialise the loop
        if i % 50 == 0 or i == args.steps - 1:
            cur = float(loss)
            first_loss = cur if first_loss is None else first_loss
            if i % 100 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {cur:.4f}")
            if cur < STOP_LOSS:
                print(f"step {i:4d}  loss {cur:.4f}: memorised, stopping")
                break
    train_s = time.perf_counter() - t0
    final_loss = float(loss)
    write_files(params, spec, m_path, f32_path)
    print(f"wrote {m_path} ({os.path.getsize(m_path) / 1e6:.1f} MB q40) and its f32 twin")
    del params, opt
    # the CLI starts now and loads while this process serves the same file
    t0 = time.perf_counter()
    cli = None if args.no_cli else start_cli(args.outdir, dev.type)

    # served back through the quantized engine: the greedy continuation of a
    # corpus prefix must be the corpus; the split is on tokens of one
    # full-corpus encoding (encode() adds a dummy space, as the reference's)
    prompt_ids = [bos] + corpus_ids[:N_PROMPT]
    expected_ids = corpus_ids[N_PROMPT:N_PROMPT + N_STEPS]
    with WeightFileReader(m_path) as reader:
        qparams = llama.quant_params_from_reader(reader, cfg, dev, "q40")
    engine = Engine(cfg, qparams, SamplerConfig(temperature=0.0), device=dev)
    kernels.reset_launches()
    toks, _, decode_ms = engine.generate_fused(prompt_ids, steps=N_STEPS)
    launches = {k: v for k, v in kernels.launches.items() if v}
    ms_tok = decode_ms / max(1, len(toks) - 1)
    n_match = prefix_match(list(toks), expected_ids)
    print(f"completion : {tokenizer.decode(list(toks))[:80]!r}")
    print(f"expected   : {CORPUS[N_PROMPT - 1:N_PROMPT - 1 + 80]!r}")
    print(f"match: {n_match}/{len(expected_ids)} tokens; {ms_tok:.2f} ms/token on {dev}; "
          f"launches {launches}")
    in_process_ok = n_match >= int(GATE * len(expected_ids))
    if not in_process_ok:  # Q40 noise or underfit? the f32 twin answers
        with WeightFileReader(f32_path) as r32:
            p32 = llama.params_from_reader(r32, cfg, dev)
        t32, _, _ = Engine(cfg, p32, SamplerConfig(temperature=0.0),
                           device=dev).generate_fused(prompt_ids, steps=N_STEPS)
        m32 = prefix_match(list(t32), expected_ids)
        print(f"f32 twin match: {m32}/{len(expected_ids)} tokens: "
              + ("quantization noise is the gap" if m32 > n_match + 10
                 else "underfit, not quantization"))
    del engine, qparams

    cli_ok = None if cli is None else cli_gate(cli)
    serve_s = time.perf_counter() - t0
    result = {"first_loss": first_loss, "final_loss": final_loss, "steps": steps_run,
              "train_seconds": round(train_s, 3), "serve_seconds": round(serve_s, 3),
              "model_bytes": os.path.getsize(m_path),
              "device": str(dev), "decode_ms_per_token": round(ms_tok, 3),
              "match_tokens": n_match, "expected_tokens": len(expected_ids),
              "in_process_ok": bool(in_process_ok), "cli_ok": cli_ok,
              "launches": launches}
    with open(os.path.join(args.outdir, "e2e_result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if in_process_ok and cli_ok is not False else 1


if __name__ == "__main__":
    raise SystemExit(main())
