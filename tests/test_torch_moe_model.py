"""Tiny Mixtral and Grok-1 models (2 layers, E = 8 and 4, k = 2) in the
port against the JAX package, on the CPU: ``forward`` (prefill, then
decode, with ``forward_decode`` bit-equal to it), ``forward_batched`` and
``forward_batched_verify``. Params come from ``from_jax_params`` or from a
``.m`` file the port's writer wrote, which both packages load (the loaders
give the same planes bit for bit). The JAX side of a quantized model runs
its kernel route (``DLLAMA_FLASH_DECODE=1 DLLAMA_FUSE_ROPE_CACHE=1``), Pallas
in interpret mode, as the port always runs its kernels' plain versions.

Tolerances (f32 activations):

* Dense params: logits and caches 1e-5 abs, the dense model's bound
  (``tests/test_torch_llama.py``; summation order only).
* Q40/Q80 params: logits within 5e-3 of their magnitude, caches within 1e-3
  of theirs. The dense model's 1e-3 of the logits assumes one bf16
  rounding per matmul input that both sides take on the same f32 value. A
  MoE layer feeds its down kernels a hidden activation whose f32 value
  differs between the two sides by an ulp (summation order); at a bf16
  rounding boundary that element flips by 2^-8 of itself, and through the
  router's renormalized weights and the next layer's projections a flip
  reaches ~2e-3 of the logits (measured on these models); the next layer's
  cache rows move by up to ~3e-4 of the cache's magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.weights import WeightFileReader as JReader
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu_torch import kernels
from dllama_tpu_torch.formats.spec import ArchType, HiddenAct, ModelSpec
from dllama_tpu_torch.formats.weights import WeightFileReader as TReader
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.quants import blocks
from tests.test_torch_moe import PROMPT, SHAPES, _params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (several test processes share the
    CPU, and spinning thread pools would oversubscribe it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_moe_model(path: str, arch: str, quant: str, seed: int = 9, **kw) -> None:
    """A ``.m`` file of ``arch`` (SHAPES, ``kw`` overriding) in ``quant``
    weights, written by the port's writer: norms 1, the rest N(0, 0.05)."""
    shape = {**SHAPES[arch], **kw}
    spec = ModelSpec(arch=ArchType.MIXTRAL if arch == "mixtral" else ArchType.GROK1,
                     dim=shape["dim"], hidden_dim=shape["hidden_dim"],
                     n_layers=shape["n_layers"], n_heads=shape["n_heads"],
                     n_kv_heads=shape["n_kv_heads"], vocab_size=shape["vocab_size"],
                     seq_len=shape["seq_len"], n_experts=shape["n_experts"],
                     n_active_experts=shape["n_active_experts"],
                     hidden_act=HiddenAct.SILU if arch == "mixtral" else HiddenAct.GELU,
                     weights_float_type=blocks.Q40 if quant == "q40" else blocks.Q80)
    rng = np.random.default_rng(seed)
    tensors = {e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                        else (0.05 * rng.standard_normal(e.d * e.n)).astype(np.float32))
               for e in tensor_plan(spec)}
    write_model(path, spec, tensors)


def _model_pair(source, arch, quant, tmp_path):
    """(jp, tp, jc, tc): carried by ``from_jax_params``, or both packages
    loading one ``.m`` file."""
    if source == "jax":
        return _params(arch, quant, seed=1)
    path = str(tmp_path / f"{arch}.m")
    write_moe_model(path, arch, quant)
    with JReader(path) as r:
        jc = JConfig.from_spec(r.spec)
        jp = jl.quant_params_from_reader(r, jc, quant)
    with TReader(path) as r:
        tc = TConfig.from_spec(r.spec)
        tp = tl.quant_params_from_reader(r, tc, "cpu", quant)
    return jp, tp, jc, tc


def _kernel_route(monkeypatch, quant):
    if quant:  # the JAX side on its kernel route, as the port always is
        monkeypatch.setenv("DLLAMA_FLASH_DECODE", "1")
        monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")


def _stale(jc, B, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, jc.n_layers, B, jc.seq_len, jc.n_kv_heads, jc.head_size))
    a = a.astype(np.float32)
    return ({"k": jnp.asarray(a[0]), "v": jnp.asarray(a[1])},
            {"k": torch.from_numpy(a[0].copy()), "v": torch.from_numpy(a[1].copy())})


def _check(tlog, jlog, tcache, jcache, quant, what):
    ref = np.asarray(jlog)
    assert tlog.shape == ref.shape and tlog.dtype == torch.float32, what
    err = np.abs(tlog.numpy() - ref).max()
    assert err <= (5e-3 * np.abs(ref).max() if quant else 1e-5), (what, err)
    for n in ("k", "v"):
        want = np.asarray(jcache[n])
        tol = 1e-3 * np.abs(want).max() if quant else 1e-5
        np.testing.assert_allclose(tcache[n].numpy(), want, rtol=0, atol=tol,
                                   err_msg=f"{what} cache {n}")


@pytest.mark.parametrize("source,quant,arch", [
    ("jax", None, "mixtral"), ("jax", None, "grok1"), ("jax", "q40", "mixtral"),
    ("file", "q40", "grok1"), ("file", "q80", "mixtral")])
def test_forward_prefill_then_decode_matches_jax(monkeypatch, tmp_path, source, quant, arch):
    _kernel_route(monkeypatch, quant)
    jp, tp, jc, tc = _model_pair(source, arch, quant, tmp_path)
    if source == "file":  # both loaders repack losslessly and fuse: the same bits
        for n in ("wqkv", "wo", "moe_upgate", "moe_down"):
            for a in ("w", "s", "s2"):
                np.testing.assert_array_equal(getattr(tp["layers"][n], a).numpy(),
                                              np.asarray(getattr(jp["layers"][n], a)))
        for n in ("moe_router", *(("rms_moe", "rms_ffn2") if arch == "grok1" else ())):
            np.testing.assert_array_equal(tp["layers"][n].numpy(), np.asarray(jp["layers"][n]))
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    jcache, tcache = jl.init_cache(jc), tl.init_cache(tc, device="cpu")
    jlog, jcache = jl.forward(jc, jp, jrope, jnp.asarray(PROMPT), jcache, jnp.int32(0))
    kernels.reset_launches()
    tlog, tcache = tl.forward(tc, tp, trope, torch.from_numpy(PROMPT).long(), tcache, 0)
    _check(tlog, jlog, tcache, jcache, quant, "prefill")
    for i in range(2):
        tok, pos = np.array([17 + 5 * i], np.int32), len(PROMPT) + i
        jlog, jcache = jl.forward(jc, jp, jrope, jnp.asarray(tok), jcache, jnp.int32(pos))
        twin = {n: c.clone() for n, c in tcache.items()}
        tlog, tcache = tl.forward(tc, tp, trope, torch.from_numpy(tok).long(), tcache, pos)
        _check(tlog, jlog, tcache, jcache, quant, f"decode {i}")
        # forward_decode (the graphed step's body) is forward at T = 1, bit for bit
        dlog, twin = tl.forward_decode(tc, tp, trope, torch.from_numpy(tok).long(), twin,
                                       torch.tensor([pos], dtype=torch.int32))
        assert torch.equal(dlog, tlog) and all(torch.equal(twin[n], tcache[n]) for n in twin)
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only


@pytest.mark.parametrize("source,quant,arch,B", [
    ("jax", None, "mixtral", 4), ("jax", None, "grok1", 4),
    ("jax", "q40", "mixtral", 2),  # the selected path: 2 rows x k 2 < 8 experts
    ("jax", "q40", "grok1", 4),  # the dense combine
    ("file", "q80", "mixtral", 2)])
def test_forward_batched_matches_jax(monkeypatch, tmp_path, source, quant, arch, B):
    _kernel_route(monkeypatch, quant)
    jp, tp, jc, tc = _model_pair(source, arch, quant, tmp_path)
    jcache, tcache = _stale(jc, B)
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    S = jc.seq_len
    pos = np.array([0, 20, 130, S - 1][:B], np.int32)
    for step in range(2):
        toks = np.array([3 + step, 17, 40 + step, 90][:B], np.int32)
        jlog, jcache = jl.forward_batched(jc, jp, jrope, jnp.asarray(toks), jcache,
                                          jnp.asarray(pos))
        tlog, tcache = tl.forward_batched(tc, tp, trope, torch.from_numpy(toks).long(), tcache,
                                          torch.from_numpy(pos))
        _check(tlog, jlog, tcache, jcache, quant, f"B={B} step {step}")
        pos = np.minimum(pos + 1, S - 1)


@pytest.mark.parametrize("source,quant,arch,B,T", [
    ("jax", None, "mixtral", 3, 4),
    ("jax", "q40", "mixtral", 1, 3),  # a verify step on the selected path: 3 rows x 2 < 8
    ("jax", "q40", "grok1", 3, 4),  # the dense combine over 12 rows
    ("file", "q40", "grok1", 2, 2)])
def test_forward_batched_verify_matches_jax(monkeypatch, tmp_path, source, quant, arch, B, T):
    if quant:
        monkeypatch.setenv("DLLAMA_FUSE_ROPE_CACHE", "1")
    jp, tp, jc, tc = _model_pair(source, arch, quant, tmp_path)
    jcache, tcache = _stale(jc, B)
    jrope, trope = jl.rope_tables(jc), tl.rope_tables(tc, "cpu")
    pos = np.array([0, 7, jc.seq_len - T][:B], np.int32)
    toks = np.random.default_rng(4).integers(1, jc.vocab_size, (B, T)).astype(np.int32)
    jlog, jcache = jl.forward_batched_verify(jc, jp, jrope, jnp.asarray(toks), jcache,
                                             jnp.asarray(pos))
    tlog, tcache = tl.forward_batched_verify(tc, tp, trope, torch.from_numpy(toks).long(),
                                             tcache, torch.from_numpy(pos))
    _check(tlog, jlog, tcache, jcache, quant, f"verify B={B} T={T}")
