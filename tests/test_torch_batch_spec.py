"""Batched speculative decoding in the port (``rope_cache_update_verify``,
``gqa_attention_batched``, ``llama.forward_batched_verify``,
``Engine.generate_batch_spec``) against the JAX package's (CPU), mirroring
``tests/test_batch_spec.py`` without its MoE and mesh cases.

* ``rope_cache_update_verify`` on CPU tensors rotates q as JAX's
  ``apply_rope`` does and writes the caches bit for bit as JAX's
  ``rope_cache_update_verify`` (Pallas, interpret mode) does, for f32, bf16
  and f8 caches, both rope styles, a row clamped to S - T.
* ``gqa_attention_batched`` equals JAX's ``vmap(gqa_attention)`` (the
  reference's verify attention) to 1e-5 of the output's magnitude (f32;
  the einsum and softmax sums run in another order), and a row never reads
  its slab past pos[b] + t.
* ``forward_batched_verify``: logits within 1e-5 abs of JAX's dense f32
  verify step and 1e-3 of their magnitude for Q40 (JAX on its rope + cache
  kernel route, ``DLLAMA_FUSE_ROPE_CACHE=1``), caches within 1e-5; each row
  within 2e-4 of the solo ``forward`` at (T, pos[b]), the reference test's
  tolerance.
* ``generate_batch_spec`` rows equal ``generate_batch``'s greedy rows cut
  at the first stop token (and JAX's ``generate_batch_spec`` rows), with
  drafts accepted; budgets, ``row_cancel``, ``on_step``; sampled settings
  raise; the engine's generator ends where ``generate_batch`` leaves it; a
  step feeds T = 1 + its longest draft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.ops import attention as j_att
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.ops import fused_rope_cache as j_frc
from dllama_tpu.ops.rope import HALF, INTERLEAVED, rope_table
from dllama_tpu.ops.rope import apply_rope as j_apply_rope
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import kernels
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops import fused_rope_cache as t_frc
from dllama_tpu_torch.ops.attention import gqa_attention_batched
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime.sampler import SamplerConfig

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
GREEDY = SamplerConfig(temperature=0.0)
PROMPTS = [[5, 9, 3, 5, 9, 3, 5, 9], [7, 7, 7, 7, 7], [4, 2]]  # repetition drafts well
ACT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
         "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _params(quant=None, seed=0):
    """(JAX params, the port's copy of them, JAX config, port config)."""
    jc, tc = JConfig(**SHAPE), TConfig(**SHAPE)
    jp = jl.random_params(jc, seed=seed, dtype=np.float32)
    if quant:
        jp = jl.quantize_params(jp, quant)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu"), jc, tc


def _engine(tp, tc, scfg=GREEDY):
    return tgen.Engine(tc, tp, scfg, device="cpu")


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
def test_rope_cache_verify_ref_bit_equal_to_jax_kernel(style, act, cache):
    rng = np.random.default_rng(len(style) + len(act) + len(cache))
    L, B, S, kv, hd, T = 2, 4, 32, 2, 32, 5
    pos = np.array([0, 13, S - T, S - 2], np.int32)  # the last row clamps to S - T
    k = rng.standard_normal((B, T, kv, hd)).astype(np.float32) * 4
    v = rng.standard_normal((B, T, kv, hd)).astype(np.float32) * 4
    cos_t, sin_t = rope_table(S, hd, 10000.0)
    idx = np.minimum(pos[:, None] + np.arange(T), S - 1)
    c, s = cos_t[idx][:, :, None], sin_t[idx][:, :, None]
    base = rng.standard_normal((L, B, S, kv, hd)).astype(np.float32)
    ja, ta = ACT[act]
    jc, tc = CACHE[cache]
    kj, vj = j_frc.rope_cache_update_verify(
        jnp.asarray(k).astype(ja), jnp.asarray(v).astype(ja), jnp.asarray(c), jnp.asarray(s),
        jnp.array(base).astype(jc), jnp.array(base + 1).astype(jc), jnp.asarray(pos),
        jnp.int32(1), style)
    kt, vt = torch.from_numpy(base).to(tc), torch.from_numpy(base + 1).to(tc)
    q = rng.standard_normal((B, T, 2 * kv, hd)).astype(np.float32) * 4
    qj = jax.jit(j_apply_rope, static_argnums=3)(jnp.asarray(q).astype(ja), jnp.asarray(c),
                                                 jnp.asarray(s), style)
    before = dict(kernels.launches)
    qt = t_frc.rope_cache_update_verify(
        torch.from_numpy(q).to(ta), torch.from_numpy(k).to(ta), torch.from_numpy(v).to(ta),
        torch.from_numpy(cos_t), torch.from_numpy(sin_t), kt, vt, torch.from_numpy(pos), 1,
        style)
    assert kernels.launches == before  # CPU tensors: the plain version, no launch
    np.testing.assert_array_equal(_bits(qj), _bits(qt))
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))


def test_gqa_attention_batched_matches_jax_vmap():
    rng = np.random.default_rng(2)
    B, T, S, kv, group, hd = 3, 5, 40, 2, 3, 16
    q = rng.standard_normal((B, T, kv * group, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    p = np.array([0, 17, S - T], dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(j_att.gqa_attention))(q, k, v, p))
    q, kc, vc, pos = (torch.from_numpy(a) for a in (q, k, v, p))
    got = gqa_attention_batched(q, kc, vc, pos)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # a row never sees its slab past pos + t
    poisoned = kc.clone(), vc.clone()
    for b in range(B):
        for c in poisoned:
            c[b, int(pos[b]) + T:] = 1e4
    torch.testing.assert_close(gqa_attention_batched(q, *poisoned, pos), got, rtol=0, atol=0)


@pytest.mark.parametrize("quant", [None, "q40"])
def test_forward_batched_verify_matches_jax_and_solo(monkeypatch, quant):
    if quant:  # the JAX side on its rope + cache kernel route, as the port always is
        monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")
    jp, tp, jc, tc = _params(quant, seed=1)
    if quant:
        jp, tp = jl.fuse_qkv_ffn(jp), tl.fuse_qkv_ffn(tp)
    rng = np.random.default_rng(4)
    B, T, S = 3, 4, SHAPE["seq_len"]
    stale = rng.standard_normal((2, jc.n_layers, B, S, jc.n_kv_heads, jc.head_size))
    stale = stale.astype(np.float32)
    jcache = {"k": jnp.asarray(stale[0]), "v": jnp.asarray(stale[1])}
    tcache = {"k": torch.from_numpy(stale[0].copy()), "v": torch.from_numpy(stale[1].copy())}
    solo = {n: c.clone() for n, c in tcache.items()}
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    pos = np.array([0, 7, S - T], np.int32)
    toks = rng.integers(1, jc.vocab_size, (B, T)).astype(np.int32)
    jlog, jcache = jl.forward_batched_verify(jc, jp, jrope, jnp.asarray(toks), jcache,
                                             jnp.asarray(pos))
    kernels.reset_launches()
    tlog, tcache = tl.forward_batched_verify(tc, tp, trope, torch.from_numpy(toks).long(),
                                             tcache, torch.from_numpy(pos))
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only
    ref = np.asarray(jlog)
    assert tlog.shape == (B, T, tc.vocab_size) and tlog.dtype == torch.float32
    err = np.abs(tlog.numpy() - ref).max()
    assert err <= (1e-3 * np.abs(ref).max() if quant else 1e-5), err
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), rtol=0, atol=1e-5)
    for b in range(B):
        row = {n: c[:, b].contiguous() for n, c in solo.items()}
        want, _ = tl.forward(tc, tp, trope, torch.from_numpy(toks[b]).long(), row, int(pos[b]))
        torch.testing.assert_close(tlog[b], want, rtol=2e-4, atol=2e-4)


def _cut(row, stop):
    return row[: row.index(stop) + 1] if stop in row else row


@pytest.mark.parametrize("quant", [None, "q40", "q80"])
def test_batch_spec_rows_equal_generate_batch(quant):
    _, tp, _, tc = _params(quant, seed=1)
    want = _engine(tp, tc).generate_batch(PROMPTS, steps=12)
    got, stats = _engine(tp, tc).generate_batch_spec(PROMPTS, steps=12, draft_len=4)
    assert got == want and all(len(r) == 12 for r in got)
    assert stats["accepted_drafts"] > 0 and stats["emitted"] == 36


def test_batch_spec_rows_equal_jax():
    jp, tp, jc, tc = _params("q40", seed=1)
    want, jstats = jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0),
                               metrics=None).generate_batch_spec(PROMPTS, 12, draft_len=4)
    got, stats = _engine(tp, tc).generate_batch_spec(PROMPTS, 12, draft_len=4)
    assert got == want and stats == jstats


def test_batch_spec_stop_token_and_budgets():
    _, tp, _, tc = _params("q40", seed=2)
    plain = _engine(tp, tc).generate_batch([[5, 9, 3], [7]], steps=10)
    spec, _ = _engine(tp, tc).generate_batch_spec([[5, 9, 3], [7]], steps=10,
                                                  row_steps=[3, 10], draft_len=4)
    assert spec == [plain[0][:3], plain[1]]
    stop = plain[0][4]
    spec, _ = _engine(tp, tc).generate_batch_spec([[5, 9, 3], [7]], steps=10, draft_len=4,
                                                  stop_tokens=(stop,))
    assert spec == [_cut(plain[0], stop), _cut(plain[1], stop)]
    assert len(spec[0]) == plain[0].index(stop) + 1


def test_batch_spec_row_cancel_and_on_step():
    _, tp, _, tc = _params("q40", seed=1)
    full = _engine(tp, tc).generate_batch(PROMPTS, steps=12)
    seen = [[] for _ in PROMPTS]
    launches = []

    def on_step(fresh):
        assert len(fresh) == len(PROMPTS)
        launches.append([len(f) for f in fresh])
        for b, burst in enumerate(fresh):
            seen[b].extend(burst)

    def row_cancel(b):  # row 1 stops after its first step's tokens
        return b == 1 and len(launches) >= 1

    got, stats = _engine(tp, tc).generate_batch_spec(PROMPTS, 12, draft_len=4,
                                                     on_step=on_step, row_cancel=row_cancel)
    assert seen == got and stats["verify_steps"] == len(launches)
    assert got[0] == full[0] and got[2] == full[2]
    assert got[1] == full[1][:launches[0][1]] and all(n[1] == 0 for n in launches[1:])


def test_batch_spec_context_limit_shrinks_T():
    """A row near the end of its context shrinks the shared T; every row
    still ends at its own room."""
    _, tp, _, tc = _params(seed=2)
    long_prompt = list(range(1, tc.seq_len - 3))  # 60 tokens: 5 feeds left
    want = _engine(tp, tc).generate_batch([[5, 9, 3, 5, 9, 3], long_prompt], steps=20)
    got, _ = _engine(tp, tc).generate_batch_spec([[5, 9, 3, 5, 9, 3], long_prompt], 20,
                                                 draft_len=8)
    assert got == want and len(got[1]) == 5 and len(got[0]) == 20


def test_batch_spec_rejects_sampled_and_bad_prompts():
    _, tp, _, tc = _params("q40", seed=3)
    eng = _engine(tp, tc)
    with pytest.raises(ValueError, match="greedy only"):
        eng.generate_batch_spec([[1]], 4, sampler=SamplerConfig(temperature=0.8))
    with pytest.raises(ValueError, match="greedy only"):
        _engine(tp, tc, SamplerConfig(temperature=0.8)).generate_batch_spec([[1]], 4)
    with pytest.raises(ValueError, match="non-empty"):
        eng.generate_batch_spec([[1], []], 4)


def test_batch_spec_leaves_the_generator_as_generate_batch_does():
    _, tp, _, tc = _params("q40", seed=4)
    scfg = SamplerConfig(temperature=0.0, seed=11)
    a, b = _engine(tp, tc, scfg), _engine(tp, tc, scfg)
    a.generate_batch([[5, 9, 3], [7]], steps=4)
    b.generate_batch_spec([[5, 9, 3], [7]], steps=4)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_batch_spec_feeds_one_row_past_the_longest_draft(monkeypatch):
    """A verify step feeds T = 1 + the step's longest draft (shorter drafts
    padded to it), not draft_len + 1: a step whose rows drafted nothing is
    a T = 1 step."""
    _, tp, _, tc = _params("q40", seed=1)
    drafted, steps = [], []
    draft, fwd = tgen._NgramIndex.draft, tl.forward_batched_verify

    def rec_draft(self, pending, k):
        drafted.append(draft(self, pending, k))
        return drafted[-1]

    def rec_fwd(cfg, params, rope, tokens, cache, pos):
        steps.append((tokens.shape[1], [len(d) for d in drafted]))
        drafted.clear()
        return fwd(cfg, params, rope, tokens, cache, pos)

    monkeypatch.setattr(tgen._NgramIndex, "draft", rec_draft)
    monkeypatch.setattr(tl, "forward_batched_verify", rec_fwd)
    got, stats = _engine(tp, tc).generate_batch_spec(PROMPTS + [[11, 3]], 12, draft_len=4)
    assert got == _engine(tp, tc).generate_batch(PROMPTS + [[11, 3]], steps=12)
    assert len(steps) == stats["verify_steps"]
    assert all(T == 1 + max(lens, default=0) for T, lens in steps)
    assert {T for T, _ in steps} > {1} and max(T for T, _ in steps) <= 5

