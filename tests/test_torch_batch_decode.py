"""Batched decode in the port (``llama.forward_batched``,
``Engine.generate_batch``, ``sampler.sample_rows``) against the JAX package's
(CPU), mirroring ``tests/test_batch_decode.py``.

* ``forward_batched`` on the same params (``from_jax_params``), rows at
  mixed positions over a batch cache that holds stale values past each
  row's prefix: dense f32 logits and caches agree to 1e-5 abs (summation
  order only, as ``tests/test_torch_llama.py``); Q40, with the JAX side on
  its kernel route (``DLLAMA_FLASH_DECODE=1 DLLAMA_FUSE_ROPE_CACHE=1``),
  logits within 1e-3 of their magnitude and caches within 1e-5.
* Greedy ``generate_batch`` rows equal JAX's ``generate_batch`` rows and the
  port's own solo ``generate`` streams, for Q40 and Q80.
* The reference's batch semantics: per-row context clamps, stop tokens and
  row budgets ending the batch early, ``on_chunk`` bursts, bad input
  rejected.
* ``sample_rows`` picks, row by row, the token ``jax.vmap(sample_dynamic)``
  picks when fed JAX's noise.
* At a fixed batch size a row's tokens do not depend on its neighbours, bit
  for bit, sampled rows included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import kernels
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 11]]  # mixed lengths incl. 1
GREEDY = tsampler.SamplerConfig(temperature=0.0)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _params(quant=None, seed=0, shape=SHAPE):
    """(JAX params, the port's copy of them, JAX config, port config)."""
    jc, tc = JConfig(**shape), TConfig(**shape)
    jp = jl.random_params(jc, seed=seed, dtype=np.float32)
    if quant:
        jp = jl.quantize_params(jp, quant)
    return jp, from_jax_params(_np_tree(jp), tc, "cpu"), jc, tc


def _engine(tp, tc, **kw):
    return tgen.Engine(tc, tp, GREEDY, device="cpu", **kw)


def _solo(tp, tc, prompt, steps):
    return [t for t, _ in _engine(tp, tc).generate(list(prompt), steps)]


@pytest.mark.parametrize("quant", [None, "q40"])
def test_forward_batched_matches_jax(monkeypatch, quant):
    if quant:  # the JAX side on its kernel route, as the port always is
        monkeypatch.setenv("DLLAMA_FLASH_DECODE", "1")
        monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")
    shape = {**SHAPE, "seq_len": 256}  # the JAX kernel's 256-position blocks
    jp, tp, jc, tc = _params(quant, seed=1, shape=shape)
    if quant:
        jp, tp = jl.fuse_qkv_ffn(jp), tl.fuse_qkv_ffn(tp)
    rng = np.random.default_rng(4)
    B, S = 4, shape["seq_len"]
    stale = rng.standard_normal((2, jc.n_layers, B, S, jc.n_kv_heads, jc.head_size))
    stale = stale.astype(np.float32)
    jcache = {"k": jnp.asarray(stale[0]), "v": jnp.asarray(stale[1])}
    tcache = {"k": torch.from_numpy(stale[0].copy()), "v": torch.from_numpy(stale[1].copy())}
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    pos = np.array([0, 20, 130, S - 1], np.int32)  # first and last slots, across a block
    for step in range(3):
        toks = np.array([3 + step, 17, 40 + step, 90], np.int32)
        jlog, jcache = jl.forward_batched(jc, jp, jrope, jnp.asarray(toks), jcache,
                                          jnp.asarray(pos))
        tlog, tcache = tl.forward_batched(tc, tp, trope, torch.from_numpy(toks).long(), tcache,
                                          torch.from_numpy(pos))
        ref = np.asarray(jlog)
        assert tlog.shape == (B, tc.vocab_size) and tlog.dtype == torch.float32
        err = np.abs(tlog.numpy() - ref).max()
        assert err <= (1e-3 * np.abs(ref).max() if quant else 1e-5), (step, err)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), rtol=0,
                                       atol=1e-5, err_msg=f"step {step} cache {n}")
        pos = np.minimum(pos + 1, S - 1)


@pytest.fixture(scope="module", params=["q40", "q80"])
def quant_model(request):
    return _params(request.param, seed=0)


def test_greedy_rows_equal_jax_and_solo(quant_model):
    jp, tp, jc, tc = quant_model
    want = jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0),
                       metrics=None).generate_batch(PROMPTS, steps=10)
    kernels.reset_launches()
    got = _engine(tp, tc).generate_batch(PROMPTS, steps=10)
    assert got == want and all(len(r) == 10 for r in got)
    assert got == [_solo(tp, tc, p, 10) for p in PROMPTS]
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only


def test_steps_clamped_per_row():
    """A near-full row exhausts ITS context without truncating the others."""
    _, tp, _, tc = _params(seed=2)
    long_prompt = list(range(1, tc.seq_len - 3))  # 60 tokens -> pos 59
    got = _engine(tp, tc).generate_batch([[5], long_prompt], steps=50)
    assert len(got[0]) == 50 and len(got[1]) == 5  # slots 59..63: 5 feeds
    assert got[0] == _solo(tp, tc, [5], 50)


def test_stop_tokens_skip_remaining_chunks():
    _, tp, _, tc = _params(seed=5)
    eng = _engine(tp, tc, decode_chunk=4)
    full = eng.generate_batch(PROMPTS, steps=32)
    stops = tuple({row[2] for row in full})  # every row stops by chunk 1
    got = eng.generate_batch(PROMPTS, steps=32, stop_tokens=stops)
    for b in range(len(PROMPTS)):
        assert len(got[b]) < 32 and got[b] == full[b][: len(got[b])]


@pytest.mark.parametrize("stop", [True, False])
def test_row_budgets_drive_early_exit(stop):
    _, tp, _, tc = _params(seed=7)
    eng = _engine(tp, tc, decode_chunk=4)
    full = eng.generate_batch([[5, 9], [7, 3]], steps=32)
    if stop:  # row 1 stops in chunk 1, row 0 meets its budget of 4
        stops = (full[1][2],) if full[1][2] not in full[0][:4] else (full[1][2], full[0][0])
        got = eng.generate_batch([[5, 9], [7, 3]], steps=32, stop_tokens=stops,
                                 row_steps=[4, 32])
        assert len(got[0]) < 32 and len(got[1]) < 32
    else:  # no stop tokens: budgets alone end the batch after one chunk
        got = eng.generate_batch([[5, 9], [7, 3]], steps=32, row_steps=[3, 4])
        assert len(got[0]) == 4 and len(got[1]) == 4
    assert got[0] == full[0][: len(got[0])] and got[1] == full[1][: len(got[1])]


def test_on_chunk_streams_every_token_once():
    _, tp, _, tc = _params(seed=0)
    eng = _engine(tp, tc, decode_chunk=4)
    seen = [[] for _ in PROMPTS]

    def on_chunk(fresh):
        assert len(fresh) == len(PROMPTS)
        for b, burst in enumerate(fresh):
            seen[b].extend(burst)

    rows = eng.generate_batch(PROMPTS, steps=10, on_chunk=on_chunk)
    assert seen == rows and all(len(r) == 10 for r in rows)
    assert eng.row_health == [True] * 3 and eng.decode_ms > 0 and eng.prefill_ms > 0


@pytest.mark.parametrize("prompts,samplers", [
    ([[1], []], None),  # an empty prompt
    ([], None),  # no prompts
    (PROMPTS, []),  # no samplers for three rows
    (PROMPTS, [tsampler.SamplerConfig(temperature=0.0)]),  # the wrong count
])
def test_bad_batches_rejected(prompts, samplers):
    _, tp, _, tc = _params(seed=0)
    with pytest.raises(ValueError):
        _engine(tp, tc).generate_batch(prompts, steps=4, samplers=samplers)


def test_sample_rows_match_jax_given_its_noise():
    rng = np.random.default_rng(6)
    B, V = 6, 300
    temps = [0.0, 0.8, 1.3, 0.0, 0.5, 2.0]
    topps = [0.9, 0.9, 0.8, 1.0, 0.0, 0.95]
    jax_rows = jax.jit(jax.vmap(jsampler.sample_dynamic))
    for i in range(6):
        logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(i), B)
        want = np.asarray(jax_rows(jnp.asarray(logits), keys, jnp.asarray(temps, jnp.float32),
                                   jnp.asarray(topps, jnp.float32)))
        noise = np.stack([np.asarray(jax.random.gumbel(keys[b], (V,), jnp.float32))
                          for b in range(B)])
        got = tsampler.sample_rows(torch.from_numpy(logits), temps, topps,
                                   gumbel=torch.from_numpy(noise))
        assert got.tolist() == want.tolist(), i
    gens = [None, *(torch.Generator().manual_seed(s) for s in range(1, B))]
    draws = {tuple(tsampler.sample_rows(torch.from_numpy(logits), temps, topps, gens).tolist())
             for _ in range(10)}
    assert len(draws) > 1  # sampled rows draw fresh noise from their own generators
    assert {d[0] for d in draws} == {int(np.argmax(logits[0]))}  # the greedy row


def test_rows_do_not_depend_on_their_neighbours():
    """Row 0, sampled with its own seed, emits the same tokens bit for bit
    in two batches of three whose other rows differ in every way."""
    _, tp, _, tc = _params(seed=3)
    mine = tsampler.SamplerConfig(temperature=0.9, topp=0.95, seed=7)
    a = _engine(tp, tc, decode_chunk=4).generate_batch(
        PROMPTS, steps=12, samplers=[mine, GREEDY, tsampler.SamplerConfig(1.3, 0.8, 42)])
    b = _engine(tp, tc, decode_chunk=4).generate_batch(
        [PROMPTS[0], [60, 61, 62, 63, 1, 2, 3, 4, 5], [9]], steps=12,
        samplers=[mine, tsampler.SamplerConfig(0.7, 0.5, 3), GREEDY])
    assert a[0] == b[0] and len(a[0]) == 12
    assert a[1] == _solo(tp, tc, PROMPTS[1], 12)  # the greedy row is its solo stream


def test_one_sampler_seeds_each_row():
    """With one SamplerConfig the rows draw from seeds ``row_seed(seed, b)``:
    valid tokens, reproducible, row 0 on the config's own seed."""
    _, tp, _, tc = _params(seed=3)
    scfg = tsampler.SamplerConfig(temperature=0.9, seed=7)
    eng = _engine(tp, tc)
    got = eng.generate_batch(PROMPTS, steps=6, sampler=scfg)
    assert all(len(r) == 6 and all(0 <= t < tc.vocab_size for t in r) for r in got)
    assert eng.generate_batch(PROMPTS, steps=6, sampler=scfg) == got
    seeded = [tsampler.SamplerConfig(0.9, scfg.topp, tsampler.row_seed(7, b)) for b in range(3)]
    assert eng.generate_batch(PROMPTS, steps=6, samplers=seeded) == got
    assert tsampler.row_seed(7, 0) == 7
