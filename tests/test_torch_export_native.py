"""The port's native export (``dllama_tpu_torch.export_native``) and C++
runner (``dllama_tpu_torch/native``) against the JAX package's (CPU).

* The manifest obeys the JAX package's contract (``tests/test_native.py``):
  tight weight offsets, arguments weights -> caches -> token -> pos, the
  logits output, ``loop_steps`` and ``prefill_bucket``; ``weights.bin``
  holds the bytes of the JAX exporter's for the same f32 params, under the
  same names.
* The exported programs, run eagerly through ``torch.export.load(...)
  .module()``: the loop's 32 greedy tokens from ``[7]`` are the port's and
  JAX's ``Engine.generate_fused``; the prefill's first token and three
  continued step tokens are JAX's ``Engine.generate``; a 90-token prompt
  takes two prefill dispatches with the restart at the context end and
  gives JAX's tokens; the step's logits are within 1e-5 * max|logit| of
  JAX's ``llama.forward``; on bf16 weights and on a float8 cache, the port's.
* ``sample_traced`` is the Engine's ``sample_dynamic`` fed the same noise.
* One module-scoped AOTInductor compile for the CPU (``export_native.main``
  on a ``.m`` file the port's writer made): a sampled loop gives the same
  tokens eagerly, exported and compiled; ``native_launch generate`` prints
  the token ids of ``cli generate --device cpu``, its prompt in one
  dispatch.
* The runner's copied C++ unit tests exit 0 and its tokenizer is the
  port's Python one. ``--tp 2`` and a MoE model are refused.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import export_native as jexport
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import export_native as texport
from dllama_tpu_torch import native_launch
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import WeightFileReader, tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.tokenizer.bpe import Tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=128, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
GREEDY_T = tsampler.SamplerConfig(temperature=0.0)
GREEDY_J = jsampler.SamplerConfig(temperature=0.0)


def shape(seq_len):
    return dict(SHAPE, seq_len=seq_len)


@functools.lru_cache(maxsize=None)
def _params(seq_len, seed):
    """(JAX params, the port's copy of them) for the tiny f32 model."""
    jp = jl.random_params(JConfig(**shape(seq_len)), seed=seed, dtype=np.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TConfig(**shape(seq_len)), "cpu")


def i32(v):
    """An int32 tensor: [len(v)] from a list, 0-d from an int."""
    return torch.tensor(v, dtype=torch.int32)


def _export(tmp_path_factory, seq_len, seed):
    """The port's export (no compile) of the tiny model: (dir, weight
    leaves, {program: module})."""
    cfg = TConfig(**shape(seq_len))
    params = _params(seq_len, seed)[1]
    out = texport.export_model(cfg, params, str(tmp_path_factory.mktemp(f"export{seq_len}")),
                               cache_dtype=torch.float32, aot=False, device="cpu")
    leaves = texport.flatten_weights(params, tl.rope_tables(cfg, "cpu"))[1]
    progs = {what: torch.export.load(os.path.join(out, files[0])).module()
             for what, files in texport.PROGRAMS.items()}
    return out, leaves, progs


@pytest.fixture(scope="module")
def export64(tmp_path_factory):
    return _export(tmp_path_factory, 64, 1)


@pytest.fixture(scope="module")
def export96(tmp_path_factory):
    return _export(tmp_path_factory, 96, 4)


def _caches(seq_len):
    return tl.init_cache(TConfig(**shape(seq_len)), torch.float32, "cpu")


def test_manifest_contract(export64):
    out = export64[0]
    manifest = open(os.path.join(out, "manifest.txt")).read().splitlines()
    assert manifest[0] == "dllama_native_torch 1"
    keys = dict(line.split(" ", 1) for line in manifest
                if line and not line.startswith(("#", "input ", "output ")))
    assert keys["device"] == "cpu"
    assert int(keys["loop_steps"]) == texport.LOOP_STEPS == 32
    assert int(keys["prefill_bucket"]) == min(texport.PREFILL_BUCKET, 64)
    for what, (exported, package, key) in texport.PROGRAMS.items():
        assert keys[f"{what}_export_file"] == exported
        assert os.path.getsize(os.path.join(out, exported)) > 0
        assert key not in keys and not os.path.exists(os.path.join(out, package))  # no AOT

    inputs = [line.split() for line in manifest if line.startswith("input ")]
    outputs = [line.split() for line in manifest if line.startswith("output ")]
    kinds = [rec[2] for rec in inputs]
    assert kinds == ["weight"] * (len(kinds) - 4) + ["cache", "cache", "token", "pos"]
    offset = 0
    for rec in inputs:
        name, kind, dtype, off, nbytes = rec[1], rec[2], rec[3], int(rec[4]), int(rec[5])
        dims = [int(d) for d in rec[7:7 + int(rec[6])]]
        if kind == "weight":
            assert off == offset, name
            assert nbytes == int(np.prod(dims, initial=1)) * {"f32": 4, "bf16": 2}[dtype]
            offset += nbytes
    assert offset == os.path.getsize(os.path.join(out, "weights.bin"))
    assert [o[2] for o in outputs] == ["logits"]
    assert outputs[0][3:] == ["f32", "1", str(SHAPE["vocab_size"])]


def test_weights_bin_equals_the_jax_exporters(export64, tmp_path):
    jout = jexport.export_model(JConfig(**shape(64)), _params(64, 1)[0], str(tmp_path / "jax"),
                                cache_dtype=jnp.float32, aot=False)

    def weight_records(d):
        lines = open(os.path.join(d, "manifest.txt")).read().splitlines()
        return [line for line in lines if line.startswith("input ") and " weight " in line]

    assert weight_records(export64[0]) == weight_records(jout)
    with open(os.path.join(export64[0], "weights.bin"), "rb") as a, \
            open(os.path.join(jout, "weights.bin"), "rb") as b:
        assert a.read() == b.read()


def test_loop_program_greedy_tokens_are_both_engines(export64):
    _, leaves, progs = export64
    c = _caches(64)
    toks = progs["loop"](*leaves, c["k"], c["v"], i32([7]), i32(0), torch.tensor(0.0),
                         torch.tensor(0.9), i32(1)).tolist()
    jp, tp = _params(64, 1)
    want_t, _, _ = tgen.Engine(TConfig(**shape(64)), tp, GREEDY_T,
                               device="cpu").generate_fused([7], texport.LOOP_STEPS)
    want_j, _, _ = jgen.Engine(JConfig(**shape(64)), jp, GREEDY_J).generate_fused(
        [7], texport.LOOP_STEPS)
    assert toks == list(want_t) == list(want_j)
    # the loop left its caches in the inputs: position 31's K is written
    assert c["k"][:, 31].abs().sum() > 0 and c["k"][:, 32:].abs().sum() == 0


def _prefill_walk(progs, leaves, c, prompt, seq_len, bucket):
    """The runner's prompt walk: (last logits, dispatches)."""
    pos, dispatches, logits = 0, 0, None
    while pos < len(prompt):
        start = min(pos, seq_len - bucket)
        take = min(len(prompt) - start, bucket)
        padded = torch.zeros(bucket, dtype=torch.int32)
        padded[:take] = torch.tensor(prompt[start:start + take])
        logits = progs["prefill"](*leaves, c["k"], c["v"], padded, i32(start), i32(take))
        pos, dispatches = start + take, dispatches + 1
    return logits, dispatches


def _continue(progs, leaves, c, first, pos, n):
    """``n`` greedy step-program tokens after ``first`` at ``pos``."""
    toks, token = [], first
    for p in range(pos, pos + n):
        token = int(torch.argmax(progs["step"](*leaves, c["k"], c["v"], i32([token]), i32(p))))
        toks.append(token)
    return toks


def test_prefill_then_steps_give_jax_generate(export64):
    _, leaves, progs = export64
    prompt = [7, 3, 9, 4]
    c = _caches(64)
    logits, dispatches = _prefill_walk(progs, leaves, c, prompt, 64, 64)
    assert dispatches == 1 and logits.shape == (SHAPE["vocab_size"],)
    first = int(torch.argmax(logits))
    got = [first] + _continue(progs, leaves, c, first, len(prompt), 3)
    want = [t for t, _ in jgen.Engine(JConfig(**shape(64)), _params(64, 1)[0],
                                      GREEDY_J).generate(prompt, steps=4)]
    assert got == want


def test_two_dispatch_prefill_restarts_at_the_context_end(export96):
    _, leaves, progs = export96
    bucket = min(texport.PREFILL_BUCKET, 96)
    assert bucket == 64  # bucket < seq_len < 2 * bucket
    prompt = [int(t) for t in np.random.default_rng(7).integers(3, SHAPE["vocab_size"], 90)]
    c = _caches(96)
    logits, dispatches = _prefill_walk(progs, leaves, c, prompt, 96, bucket)
    assert dispatches == 2  # the second restarts at 32, re-feeding 32..63
    first = int(torch.argmax(logits))
    got = [first] + _continue(progs, leaves, c, first, len(prompt), 2)
    want = [t for t, _ in jgen.Engine(JConfig(**shape(96)), _params(96, 4)[0],
                                      GREEDY_J).generate(prompt, steps=3)]
    assert got == want


def test_step_logits_match_jax_forward(export64):
    _, leaves, progs = export64
    jcfg = JConfig(**shape(64))
    jp = jax.tree.map(jnp.asarray, _params(64, 1)[0])
    rope = jl.rope_tables(jcfg)
    jcache = jl.init_cache(jcfg, jnp.float32)
    c = _caches(64)
    for pos, token in enumerate([7, 3, 9, 4, 11, 60]):
        got = progs["step"](*leaves, c["k"], c["v"], i32([token]), i32(pos)).numpy()
        want, jcache = jl.forward(jcfg, jp, rope, jnp.asarray([token], jnp.int32), jcache,
                                  jnp.int32(pos))
        want = np.asarray(want)[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,cache,names", [("bfloat16", torch.bfloat16, ("bf16", "bf16")),
                                               ("float32", torch.float8_e4m3fn,
                                                ("f32", "f8e4m3fn"))])
def test_step_program_in_bf16_and_on_an_f8_cache(dtype, cache, names, tmp_path):
    """The exported step on bf16 weights and on a float8 cache: the port's
    ``llama.forward`` logits at T = 1 within 1e-5 * max|logit|, the caches
    written in place, the manifest naming the dtypes."""
    cfg = TConfig(**dict(SHAPE, dtype=dtype))
    params = tl.random_params(cfg, seed=3, device="cpu")
    out = texport.export_model(cfg, params, str(tmp_path), cache_dtype=cache, aot=False,
                               device="cpu")
    step = torch.export.load(os.path.join(out, "model_export.pt2")).module()
    leaves = texport.flatten_weights(params, tl.rope_tables(cfg, "cpu"))[1]
    c, ref = tl.init_cache(cfg, cache, "cpu"), tl.init_cache(cfg, cache, "cpu")
    for pos, token in enumerate([7, 3, 9, 4]):
        got = step(*leaves, c["k"], c["v"], i32([token]), i32(pos)).float()
        want = tl.forward(cfg, params, tl.rope_tables(cfg, "cpu"), torch.tensor([token]), ref,
                          pos)[0][0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(c["k"].view(torch.uint8), ref["k"].view(torch.uint8))
    records = [line.split() for line in open(os.path.join(out, "manifest.txt"))
               if line.startswith("input ")]
    assert {r[3] for r in records if r[1] == "params.wcls" or r[2] == "cache"} == set(names)


@pytest.mark.parametrize("temp,topp", [(0.0, 0.9), (0.8, 0.9), (1.0, 1.0)])
def test_sample_traced_is_sample_dynamic_on_the_same_noise(temp, topp):
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(128).astype(np.float32))
    for seed, step in ((1, 0), (5, 31), (2**31 - 1, 7)):
        noise = tsampler.hash_gumbel(i32(seed), i32(step), 128)
        assert torch.isfinite(noise).all()
        got = tsampler.sample_traced(logits, torch.tensor(temp), torch.tensor(topp), i32(seed),
                                     i32(step))
        want = tsampler.sample_dynamic(logits, temp, topp, gumbel=noise)
        assert int(got) == int(want)
    # different steps draw different noise; the same step the same
    a, b = (tsampler.hash_bits(i32(1), i32(s), 128) for s in (0, 1))
    assert not torch.equal(a, b) and torch.equal(a, tsampler.hash_bits(i32(1), i32(0), 128))


# ---------------------------------------------------------------------------
# The compiled export, the runner and the CLI
# ---------------------------------------------------------------------------

VOCAB = ([b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % b for b in range(256)]
         + [b" ", b"e", b"t", b"he", b" the", b"hello", b" world"])
PROMPT = "hello the world"


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """A tiny f32 ``.m`` and ``.t`` (the port's writers), exported by
    ``export_native.main`` and compiled for the CPU, and the runner built."""
    d = tmp_path_factory.mktemp("native")
    scores = [0.0] * 259 + [-1.0, -2.0, -2.0, -1.5, -1.2, -1.1, -1.1]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=VOCAB, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=len(VOCAB), seq_len=64)
    rng = np.random.default_rng(0)
    write_model(str(d / "m.m"), spec, {
        e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                 else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
        for e in tensor_plan(spec)})
    out = str(d / "export")
    assert texport.main(["--model", str(d / "m.m"), "--tokenizer", str(d / "t.t"), "--out", out,
                         "--dtype", "float32", "--cache-dtype", "float32",
                         "--device", "cpu"]) == 0
    native_launch.build()
    return d, out


def _run(cmd):
    # the runner writes each token's raw bytes: a piece may split a character
    proc = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                          errors="replace", cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ids = re.search(r"^Token ids:\s*([\d ]*)$", proc.stdout, re.M)
    return [int(t) for t in ids.group(1).split()], proc


def test_runner_prints_the_cli_tokens(compiled):
    d, out = compiled
    flags = ["--prompt", PROMPT, "--steps", "40", "--temperature", "0"]
    got, proc = _run(["dllama_tpu_torch.native_launch", "generate", "--export-dir", out,
                      *flags])
    want, _ = _run(["dllama_tpu_torch.cli", "generate", "--device", "cpu", "--dtype", "float32",
                    "--model", str(d / "m.m"), "--tokenizer", str(d / "t.t"), *flags])
    assert got == want and len(got) > texport.LOOP_STEPS  # a chunk and a tail, or a stop
    n, dispatches = map(int, re.search(r"prompt: (\d+) tokens in (\d+) dispatches",
                                       proc.stderr).groups())
    assert n == len(Tokenizer.from_file(str(d / "t.t")).encode(PROMPT, add_bos=True))
    assert dispatches < n - 1 and dispatches == 1
    assert "Generated tokens:    " in proc.stdout and "Avg generation time:" in proc.stdout


def test_sampled_loop_is_the_same_eager_exported_and_compiled(compiled):
    _, out = compiled
    with WeightFileReader(os.path.join(os.path.dirname(out), "m.m")) as reader:
        cfg = TConfig.from_spec(reader.spec, dtype="float32")
        params = tl.params_from_reader(reader, cfg, "cpu")
    names, leaves = texport.flatten_weights(params, tl.rope_tables(cfg, "cpu"))
    runs = {
        "eager": texport.LoopProgram(cfg, names),
        "exported": torch.export.load(os.path.join(out, "model_loop_export.pt2")).module(),
        "compiled": torch._inductor.aoti_load_package(os.path.join(out, "model_loop.pt2")),
    }
    got = {}
    for how, program in runs.items():
        c = tl.init_cache(cfg, torch.float32, "cpu")
        got[how] = program(*leaves, c["k"], c["v"], i32([1]), i32(0), torch.tensor(0.8),
                           torch.tensor(0.9), i32(5)).tolist()
    c = tl.init_cache(cfg, torch.float32, "cpu")
    greedy = runs["compiled"](*leaves, c["k"], c["v"], i32([1]), i32(0), torch.tensor(0.0),
                              torch.tensor(0.9), i32(5)).tolist()
    assert got["eager"] == got["exported"] == got["compiled"] != greedy


@pytest.mark.parametrize("binary", native_launch.UNIT_TESTS)
def test_cpp_unit_tests(compiled, binary):
    proc = subprocess.run([os.path.join(native_launch.BUILD, binary)], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpp_tokenizer_is_the_python_one(compiled, tmp_path):
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    extra = [b" ", b"t", b"h", b"e", b"th", b"the", b" the", b"c", b"a", b"at", b"cat", b" cat"]
    scores = [0.0] * 259 + [-3.0, -5.0, -5.0, -5.0, -2.0, -1.0, -0.5, -5.0, -5.0, -2.0, -1.0,
                            -0.5]
    path = str(tmp_path / "v.t")
    write_tokenizer(path, TokenizerData(vocab=vocab + extra, scores=scores, bos_id=1, eos_id=2))
    py = Tokenizer.from_file(path)
    for text in ["the cat", "the", "hello world", "xyz", "", "żółw"]:
        probe = subprocess.run([os.path.join(native_launch.BUILD, "tokenizer-probe"), path, text],
                               capture_output=True, text=True, timeout=60)
        assert probe.returncode == 0, probe.stderr
        assert [int(x) for x in probe.stdout.split()] == py.encode(text, add_bos=True), text


def test_tp_export_is_refused(tmp_path, capsys):
    assert texport.main(["--model", "absent.m", "--out", str(tmp_path), "--tp", "2"]) != 0
    assert "--tp" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_moe_export_is_refused(tmp_path):
    cfg = TConfig(**dict(shape(32), arch="mixtral", n_experts=4, n_active_experts=2))
    params = tl.random_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="mixtral"):
        texport.export_model(cfg, params, str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)
