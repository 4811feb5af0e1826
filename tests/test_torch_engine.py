"""The port's Engine, CLI and sampler against the JAX package's (CPU).

* From one Q40 `.m` written by the JAX package's writer (and read by the
  port's own reader), the port's Engine and the JAX Engine emit the same
  greedy stream of 16 tokens, f32 activations.
* ``python -m dllama_tpu_torch.cli generate --device cpu --temperature 0``
  prints the same token ids.
* ``sample_dynamic`` fed the Gumbel noise JAX draws picks JAX's token at
  temperature 0.8 and top-p 0.9.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.spec import ArchType, ModelSpec
from dllama_tpu.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu.formats.weights import WeightFileReader as JReader
from dllama_tpu.formats.weights import tensor_plan, write_model
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.quants import blocks
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu.tokenizer.bpe import Tokenizer as JTokenizer
from dllama_tpu_torch.formats.weights import WeightFileReader as TReader
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.tokenizer.bpe import Tokenizer as TTokenizer

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "Hello world"
STEPS = 16


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [b" ", b"He", b"ll", b"o", b" w", b"or", b"ld", b"Hello", b" world"]
    vocab += [f"tok{i}".encode() for i in range(320 - len(vocab))]
    scores = [0.0] * 259 + [float(i) for i in range(len(vocab) - 259)]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=128, hidden_dim=192, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=len(vocab), seq_len=64,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    tensors = {e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                        else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
               for e in tensor_plan(spec)}
    write_model(str(d / "m.m"), spec, tensors)
    return d / "m.m", d / "t.t"


def _tokens(tok_path):
    jt = JTokenizer.from_file(str(tok_path)).encode(PROMPT, add_bos=True)
    tt = TTokenizer.from_file(str(tok_path)).encode(PROMPT, add_bos=True)
    assert jt == tt
    return tt


def _port_stream(model_path, tokens):
    with TReader(str(model_path)) as r:
        cfg = TConfig.from_spec(r.spec, dtype="float32")
        params = tl.quant_params_from_reader(r, cfg, "cpu", "q40")
    eng = tgen.Engine(cfg, params, tsampler.SamplerConfig(temperature=0.0), device="cpu")
    return [t for t, _ in eng.generate(tokens, STEPS, stop_tokens=(2,))]


def test_engine_greedy_stream_matches_jax(model_files):
    model, tok = model_files
    tokens = _tokens(tok)
    with JReader(str(model)) as r:
        cfg = JConfig.from_spec(r.spec, dtype="float32")
        params = jl.quant_params_from_reader(r, cfg, "q40")
    eng = jgen.Engine(cfg, params, jsampler.SamplerConfig(temperature=0.0), metrics=None)
    want = [t for t, _ in eng.generate(tokens, STEPS, stop_tokens=(2,))]
    got = _port_stream(model, tokens)
    assert len(want) > 1 and got == want


@pytest.mark.parametrize("mode", ["generate", "inference"])
def test_cli_prints_the_same_tokens(model_files, mode):
    model, tok = model_files
    want = _port_stream(model, _tokens(tok))
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch.cli", mode, "--device", "cpu",
         "--model", str(model), "--tokenizer", str(tok), "--prompt", PROMPT,
         "--steps", str(STEPS), "--temperature", "0", "--seed", "0", "--dtype", "float32",
         "--weights-float-type", "q40"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("Token ids:"))
    assert [int(t) for t in line.split(":", 1)[1].split()] == want
    assert ("🔶 G" in proc.stdout) == (mode == "inference")  # per-token stats lines


def test_cli_chat_runs_two_turns(model_files):
    model, tok = model_files
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch.cli", "chat", "--device", "cpu",
         "--model", str(model), "--tokenizer", str(tok), "--steps", "4", "--temperature", "0",
         "--dtype", "float32", "--system-prompt", ""],
        input="Hello\nworld\n", cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("🤖 Assistant:") == 2


def test_sample_dynamic_matches_jax_given_its_noise():
    rng = np.random.default_rng(5)
    jax_sample = jax.jit(jsampler.sample_dynamic)
    for i in range(12):
        logits = (rng.standard_normal(300) * 2).astype(np.float32)
        key = jax.random.PRNGKey(i)
        want = int(jax_sample(jnp.asarray(logits), key, jnp.float32(0.8), jnp.float32(0.9)))
        noise = np.array(jax.random.gumbel(key, (300,), jnp.float32))
        got = int(tsampler.sample_dynamic(torch.from_numpy(logits), 0.8, 0.9,
                                          gumbel=torch.from_numpy(noise)))
        assert got == want, i
        greedy = int(jax_sample(jnp.asarray(logits), key, jnp.float32(0.0), jnp.float32(0.9)))
        assert int(tsampler.sample_dynamic(torch.from_numpy(logits), 0.0, 0.9)) == greedy
    g = torch.Generator().manual_seed(0)
    draws = {int(tsampler.sample_dynamic(torch.from_numpy(logits), 0.8, 0.9, generator=g))
             for _ in range(20)}
    assert len(draws) > 1  # the generator path draws fresh noise each call


def test_session_continuation_and_chunked_prefill(model_files):
    """Two generate() calls through ``final_session`` emit the tokens one
    call does; a prefill cut into chunks lands within f32 summation noise
    of the monolithic one (not bit-identity: the pieces take other kernel
    routes)."""
    model, tok = model_files
    tokens = _tokens(tok)
    with TReader(str(model)) as r:
        cfg = TConfig.from_spec(r.spec, dtype="float32")
        params = tl.quant_params_from_reader(r, cfg, "cpu", "q40")
    eng = tgen.Engine(cfg, params, tsampler.SamplerConfig(temperature=0.0), device="cpu")
    straight = [t for t, _ in eng.generate(tokens, 8)]
    first = [t for t, _ in eng.generate(tokens, 4)]
    rest = [t for t, _ in eng.generate([], 4, session=eng.final_session)]
    assert first + rest == straight
    assert eng.final_session.pos == len(tokens) + 7  # the 8th token is still pending

    mono, _ = eng.prefill(eng.new_cache(), tokens)
    chunked, _ = eng.prefill(eng.new_cache(), tokens, chunk=2)
    torch.testing.assert_close(chunked, mono, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds seq_len"):
        eng.prefill(eng.new_cache(), [1] * (cfg.seq_len + 1))
