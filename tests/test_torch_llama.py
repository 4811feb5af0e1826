"""The port's model against the JAX package's on the same parameters (CPU).

* ``from_jax_params`` carries the JAX parameter dict across unchanged —
  dense, and quantized + fused.
* ``forward`` matches: prefill (T > 16: rope, slice write and dense
  attention on both sides) then decode steps (T = 1: the port's rope +
  cache-write and flash-decode plain versions), comparing logits and caches.
  Dense f32 agrees to 1e-5 abs (summation order and last-ulp transcendental
  differences only). For Q40 the JAX side runs with
  ``DLLAMA_FLASH_DECODE=1 DLLAMA_FUSE_ROPE_CACHE=1`` so both sides take the
  kernel route; logits agree to 1e-3 of their magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops.qmatmul import QuantTensor

SHAPE = dict(arch="llama", dim=128, hidden_dim=192, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=256, head_size=32, kv_dim=64)
PROMPT = np.array([1, 5, 9, 13, 2, 7, 3, 4, 11, 12, 40, 41, 42, 43, 44, 45, 46, 47, 48],
                  np.int32)  # 19 tokens: the prefill route


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _leaf_equal(j, t):
    if isinstance(t, QuantTensor):
        for n in ("w", "s", "s2"):
            np.testing.assert_array_equal(np.asarray(getattr(j, n)), getattr(t, n).numpy())
        assert (j.kind, j.k_logical) == (t.kind, t.k_logical)
    else:
        np.testing.assert_array_equal(np.asarray(j).astype(np.float32), t.float().numpy())


def test_from_jax_params_carries_dense_and_quantized_params():
    jc, tc = JConfig(**SHAPE), TConfig(**SHAPE)
    jp = jl.random_params(jc, seed=3)
    tp = from_jax_params(_np_tree(jp), tc, "cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    for k in ("embedding", "rms_final", "wcls"):
        _leaf_equal(jp[k], tp[k])
    for k in jp["layers"]:
        _leaf_equal(jp["layers"][k], tp["layers"][k])
    # the port's own seeded params are the same numbers
    own = tl.random_params(tc, seed=3, device="cpu")
    for k in own["layers"]:
        assert torch.equal(own["layers"][k], tp["layers"][k])

    jq = jl.fuse_qkv_ffn(jl.quantize_params(jp, "q40"))
    tq = from_jax_params(_np_tree(jq), tc, "cpu")
    assert set(tq["layers"]) == {"wqkv", "wo", "w13", "w2", "rms_att", "rms_ffn"}
    _leaf_equal(jq["wcls"], tq["wcls"])
    for k in jq["layers"]:
        _leaf_equal(jq["layers"][k], tq["layers"][k])
    # the port's own quantize + fuse lands on the same planes
    mine = tl.fuse_qkv_ffn(tl.quantize_params(own, "q40"))
    for k in jq["layers"]:
        _leaf_equal(jq["layers"][k], mine["layers"][k])


def _run_both(jc, tc, jp, tp, steps=3):
    """Prefill PROMPT then ``steps`` single-token decodes on both sides;
    yields (stage, jax logits, port logits, jax cache, port cache)."""
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    jcache, tcache = jl.init_cache(jc), tl.init_cache(tc, device="cpu")
    jlog, jcache = jl.forward(jc, jp, jrope, jnp.asarray(PROMPT), jcache, jnp.int32(0))
    tlog, tcache = tl.forward(tc, tp, trope, torch.from_numpy(PROMPT).long(), tcache, 0)
    yield "prefill", jlog, tlog, jcache, tcache
    for i in range(steps):
        tok = np.array([17 + 5 * i], np.int32)
        pos = len(PROMPT) + i
        jlog, jcache = jl.forward(jc, jp, jrope, jnp.asarray(tok), jcache, jnp.int32(pos))
        tlog, tcache = tl.forward(tc, tp, trope, torch.from_numpy(tok).long(), tcache, pos)
        yield f"decode {i}", jlog, tlog, jcache, tcache


def test_dense_f32_forward_matches():
    jc, tc = JConfig(**SHAPE), TConfig(**SHAPE)
    jp = jl.random_params(jc, seed=0)
    tp = from_jax_params(_np_tree(jp), tc, "cpu")
    for stage, jlog, tlog, jcache, tcache in _run_both(jc, tc, jp, tp):
        assert tlog.shape == jlog.shape and tlog.dtype == torch.float32, stage
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5,
                                   err_msg=stage)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), rtol=0,
                                       atol=1e-5, err_msg=f"{stage} cache {n}")


def test_q40_forward_matches_the_kernel_route(monkeypatch):
    monkeypatch.setenv("DLLAMA_FLASH_DECODE", "1")
    monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")
    jc, tc = JConfig(**SHAPE), TConfig(**SHAPE)
    jp = jl.fuse_qkv_ffn(jl.quantize_params(jl.random_params(jc, seed=1), "q40"))
    tp = from_jax_params(_np_tree(jp), tc, "cpu")
    for stage, jlog, tlog, jcache, tcache in _run_both(jc, tc, jp, tp):
        ref = np.asarray(jlog)
        err = np.abs(tlog.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max(), (stage, err)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), rtol=0,
                                       atol=1e-5, err_msg=f"{stage} cache {n}")


def test_last_pos_and_moe_refusal():
    tc = TConfig(**SHAPE)
    tp = tl.random_params(tc, seed=2, device="cpu")
    toks = torch.from_numpy(PROMPT).long()
    rope = tl.rope_tables(tc, "cpu")
    full, _ = tl.forward(tc, tp, rope, toks, tl.init_cache(tc, device="cpu"), 0)
    last, _ = tl.forward(tc, tp, rope, toks, tl.init_cache(tc, device="cpu"), 0, last_pos=7)
    assert last.shape == (1, tc.vocab_size)
    torch.testing.assert_close(last[0], full[7], rtol=1e-5, atol=1e-6)
    # MoE is no longer refused: a Mixtral config builds the JAX package's
    # params (expert stacks in place of w1/w2/w3) and runs the forward
    moe = TConfig(**{**SHAPE, "arch": "mixtral", "n_experts": 4, "n_active_experts": 2})
    mp = tl.random_params(moe, seed=2, device="cpu")
    assert {"moe_router", "moe_up", "moe_gate", "moe_down"} <= set(mp["layers"])
    assert not {"w1", "w2", "w3"} & set(mp["layers"])
    logits, _ = tl.forward(moe, mp, rope, toks, tl.init_cache(moe, device="cpu"), 0, last_pos=7)
    assert logits.shape == (1, moe.vocab_size) and bool(torch.isfinite(logits).all())
