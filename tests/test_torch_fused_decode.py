"""The port's ``Engine.generate_fused`` against the JAX package's (CPU),
mirroring ``tests/test_engine.py``'s fused-decode tests.

* On the same params (``from_jax_params``), float and Q40, the port's
  greedy ``generate_fused`` emits JAX's ``generate_fused`` tokens, for 8
  and 90 steps at seq_len 128 (one chunk; several, with a tail) and decode
  chunks of 4 and 64, and ends in the reference's ``final_session``: pos 3
  + 7 and 3 + 89, the last token pending.
* The reference's steps = 0, steps = 1, continuation and 1-token-prompt
  cases.
* Seeded sampling: reproducible, different across seeds, and the port's
  own ``generate`` stream for the same sampler. (JAX's streams differ by
  design: its fused loop splits its key chain once per chunk, and the
  port draws from a ``torch.Generator``, not JAX's keys.)
* A NaN in ``wcls`` raises ``NumericHealthError`` after the chunk.
* The cache after ``generate_fused`` equals the cache after ``generate``
  bit for bit in the slots [0, pos) a later step reads.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=128, head_size=16, kv_dim=32, dtype="float32")
PROMPT = [1, 5, 9]
GREEDY = tsampler.SamplerConfig(temperature=0.0)


@functools.lru_cache(maxsize=None)
def _params(quant):
    """(JAX params, the port's copy of them): one seeded model per quant."""
    jp = jl.random_params(JConfig(**SHAPE), seed=7, dtype=np.float32)
    if quant:
        jp = jl.quantize_params(jp, quant)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TConfig(**SHAPE), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_fused(quant, chunk, steps):
    """JAX's generate_fused tokens and final session (pos, pending)."""
    eng = jgen.Engine(JConfig(**SHAPE), _params(quant)[0],
                      jsampler.SamplerConfig(temperature=0.0), metrics=None, decode_chunk=chunk)
    toks, _, _ = eng.generate_fused(PROMPT, steps)
    return toks, eng.final_session.pos, eng.final_session.pending_token


def _engine(quant=None, **kw):
    return tgen.Engine(TConfig(**SHAPE), _params(quant)[1], GREEDY, device="cpu", **kw)


@pytest.mark.parametrize("chunk", [4, 64])
@pytest.mark.parametrize("steps", [8, 90])
@pytest.mark.parametrize("quant", [None, "q40"])
def test_generate_fused_matches_jax(quant, steps, chunk):
    want, jpos, jpending = _jax_fused(quant, chunk, steps)
    eng = _engine(quant, decode_chunk=chunk)
    got, prefill_ms, decode_ms = eng.generate_fused(PROMPT, steps)
    assert got == want and len(got) == steps
    # 3 prompt tokens + steps - 1 consumed generated tokens; the last is pending
    assert (eng.final_session.pos, eng.final_session.pending_token) == (jpos, jpending)
    assert eng.final_session.pos == 3 + steps - 1
    assert prefill_ms > 0 and decode_ms > 0
    assert got == [t for t, _ in _engine(quant).generate(PROMPT, steps)]


def test_generate_fused_steps_zero_and_one():
    eng = _engine()
    out, _, decode_ms = eng.generate_fused(PROMPT, 0)
    assert out == [] and decode_ms == 0.0
    assert (eng.final_session.pos, eng.final_session.pending_token) == (3, None)

    out1, _, _ = eng.generate_fused(PROMPT, 1)
    assert len(out1) == 1
    # the prefill-sampled token is pending: continuation must consume it
    assert eng.final_session.pending_token == out1[0]
    cont = [t for t, _ in eng.generate([7], 2, session=eng.final_session)]
    ref = [t for t, _ in _engine().generate(PROMPT + out1 + [7], 2)]
    assert cont == ref


def test_generate_fused_continuation_across_chunks():
    """90 steps in chunks of 64 and a tail of 25; a later generate() from
    final_session continues as one long prompt would."""
    eng = _engine()
    got, _, _ = eng.generate_fused(PROMPT, 90)
    cont = [t for t, _ in eng.generate([7], 3, session=eng.final_session)]
    ref = [t for t, _ in _engine().generate(PROMPT + got + [7], 3)]
    assert cont == ref


def test_generate_fused_one_token_prompt():
    eng = _engine(decode_chunk=4)
    got, _, _ = eng.generate_fused([2], 10)
    assert got == [t for t, _ in _engine().generate([2], 10)]
    assert (eng.final_session.pos, eng.final_session.pending_token) == (10, got[-1])
    out, _, _ = eng.generate_fused([2], 0)
    assert out == [] and (eng.final_session.pos, eng.final_session.pending_token) == (0, 2)


def test_generate_fused_seeded_sampler():
    eng = _engine(decode_chunk=4)
    s = tsampler.SamplerConfig(temperature=0.9, topp=0.95, seed=7)
    a, _, _ = eng.generate_fused(PROMPT, 12, sampler=s)
    b, _, _ = eng.generate_fused(PROMPT, 12, sampler=s)
    assert a == b and len(a) == 12
    c, _, _ = eng.generate_fused(PROMPT, 12, sampler=tsampler.SamplerConfig(0.9, 0.95, 8))
    assert c != a  # a different seed draws a different stream
    assert a == [t for t, _ in eng.generate(PROMPT, 12, sampler=s)]


def test_generate_fused_nan_raises():
    _, tp = _params(None)
    bad = dict(tp)
    bad["wcls"] = torch.full_like(tp["wcls"], float("nan"))
    eng = tgen.Engine(TConfig(**SHAPE), bad, GREEDY, device="cpu", decode_chunk=4)
    with pytest.raises(tgen.NumericHealthError, match="fused decode chunk starting at position 3"):
        eng.generate_fused(PROMPT, 10)


@pytest.mark.parametrize("quant", [None, "q40"])
def test_generate_fused_cache_equals_generate(quant):
    eng = _engine(quant, decode_chunk=8)
    eng.generate_fused(PROMPT, 20)
    fused = eng.final_session
    ref = _engine(quant)
    for _ in ref.generate(PROMPT, 20):
        pass
    plain = ref.final_session
    assert fused.pos == plain.pos == 3 + 19
    for n in ("k", "v"):
        assert torch.equal(fused.cache[n][:, :fused.pos], plain.cache[n][:, :plain.pos])
