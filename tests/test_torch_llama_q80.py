"""A Q80 model through the port and through the JAX package (CPU).

One tiny Q80 `.m` (2 layers, dim 256, hidden 512, vocab 96), written by the
port's own writer, is loaded by both packages with
``quant_params_from_reader(..., "q80")``:

* the port's planes are a lossless repack of the file (equal to the JAX
  package's planes, and dequantizing to the file's own values);
* ``forward`` logits agree at a 5-token prefill and a 1-token decode, with
  ``DLLAMA_FUSE_NORM`` 0 and 1 on both sides (the JAX side with its flash
  decode and fused rope+cache kernels on, the routes the port's T <= 16
  steps take). f32 activations; both sides round the dot operands to bf16
  alike, so the logits differ only by summation order and last-ulp
  transcendentals: within 1e-3 of their magnitude;
* greedy ``Engine.generate`` emits the same 8 tokens;
* ``python -m dllama_tpu_torch.cli generate --device cpu
  --weights-float-type q80`` prints those tokens.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.weights import WeightFileReader as JReader
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import WeightFileReader as TReader
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops import qmatmul as tq
from dllama_tpu_torch.quants import blocks
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.tokenizer.bpe import Tokenizer

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "Hello world"
STEPS = 8


@pytest.fixture(scope="module")
def q80_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_q80")
    # 96 pieces, no byte fallback: every character of PROMPT is a piece
    vocab = [b"<unk>", b"<s>", b"</s>", b" ", b"H", b"e", b"l", b"o", b"w", b"r", b"d",
             b"He", b"ll", b"Hell", b"Hello", b" w", b"or", b"ld", b" wor", b" world"]
    vocab += [f"tok{i}".encode() for i in range(96 - len(vocab))]
    scores = [0.0] * 11 + [float(i) for i in range(1, len(vocab) - 10)]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                     n_kv_heads=4, vocab_size=len(vocab), seq_len=64,
                     weights_float_type=blocks.Q80)
    rng = np.random.default_rng(0)
    tensors = {e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                        else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
               for e in tensor_plan(spec)}
    write_model(str(d / "m.m"), spec, tensors)
    return d / "m.m", d / "t.t"


def _tokens(tok_path):
    return Tokenizer.from_file(str(tok_path)).encode(PROMPT, add_bos=True)


def _load_both(model):
    with JReader(str(model)) as r:
        jc = JConfig.from_spec(r.spec, dtype="float32")
        jp = jl.quant_params_from_reader(r, jc, "q80")
    with TReader(str(model)) as r:
        tc = TConfig.from_spec(r.spec, dtype="float32")
        tp = tl.quant_params_from_reader(r, tc, "cpu", "q80")
        wcls_file = r.read_tensor("wcls", np.float32).T
    return jc, jp, tc, tp, wcls_file


def test_q80_file_repacks_losslessly(q80_files):
    _, jp, _, tp, wcls_file = _load_both(q80_files[0])
    assert set(tp["layers"]) == {"wqkv", "wo", "w13", "w2", "rms_att", "rms_ffn"}
    for name in ("wqkv", "wo", "w13", "w2"):
        j, t = jp["layers"][name], tp["layers"][name]
        assert (t.kind, t.k_logical) == (j.kind, j.k_logical) == ("q80", j.k_logical)
        for plane in ("w", "s"):
            np.testing.assert_array_equal(np.asarray(getattr(j, plane)),
                                          getattr(t, plane).numpy(), err_msg=name)
    np.testing.assert_array_equal(tq.dequantize(tp["wcls"]), wcls_file)


@pytest.mark.parametrize("fuse_norm", ["0", "1"])
def test_q80_forward_matches_jax(q80_files, fuse_norm, monkeypatch):
    monkeypatch.setenv("DLLAMA_FLASH_DECODE", "1")
    monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")
    monkeypatch.setenv("DLLAMA_FUSE_NORM", fuse_norm)
    jc, jp, tc, tp, _ = _load_both(q80_files[0])
    prompt = np.array([1, 14, 19, 40, 77], np.int32)
    jrope, jcache = jl.rope_tables(jc), jl.init_cache(jc)
    trope, tcache = tl.rope_tables(tc, "cpu"), tl.init_cache(tc, device="cpu")
    steps = [(prompt, 0), (np.array([17], np.int32), len(prompt))]
    for toks, pos in steps:
        jlog, jcache = jl.forward(jc, jp, jrope, jnp.asarray(toks), jcache, jnp.int32(pos))
        tlog, tcache = tl.forward(tc, tp, trope, torch.from_numpy(toks).long(), tcache, pos)
        ref = np.asarray(jlog)
        assert tlog.shape == ref.shape == (len(toks), tc.vocab_size)
        err = np.abs(tlog.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (len(toks), err)


def _port_stream(model, tokens):
    with TReader(str(model)) as r:
        cfg = TConfig.from_spec(r.spec, dtype="float32")
        params = tl.quant_params_from_reader(r, cfg, "cpu", "q80")
    eng = tgen.Engine(cfg, params, tsampler.SamplerConfig(temperature=0.0), device="cpu")
    return [t for t, _ in eng.generate(tokens, STEPS, stop_tokens=(2,))]


def test_q80_greedy_stream_matches_jax(q80_files):
    model, tok = q80_files
    tokens = _tokens(tok)
    with JReader(str(model)) as r:
        cfg = JConfig.from_spec(r.spec, dtype="float32")
        params = jl.quant_params_from_reader(r, cfg, "q80")
    eng = jgen.Engine(cfg, params, jsampler.SamplerConfig(temperature=0.0), metrics=None)
    want = [t for t, _ in eng.generate(tokens, STEPS, stop_tokens=(2,))]
    assert len(want) > 1 and _port_stream(model, tokens) == want


def test_q80_cli_on_the_cpu_prints_the_engine_stream(q80_files):
    model, tok = q80_files
    want = _port_stream(model, _tokens(tok))
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch.cli", "generate", "--device", "cpu",
         "--weights-float-type", "q80", "--model", str(model), "--tokenizer", str(tok),
         "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0", "--seed", "0",
         "--dtype", "float32"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "weights resident as q80" in proc.stdout
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("Token ids:"))
    assert [int(t) for t in line.split(":", 1)[1].split()] == want
