"""The port's elementwise and attention ops against the JAX package's, on the
same numpy inputs (CPU).

Where the two frameworks do the same arithmetic the results are bit-equal:
the rope rotation (both sides compute the single-rounding fma forms XLA
contracts the jitted rotation into), and the bf16 results of rmsnorm, silu
(the logistic rounded per op, as XLA lowers it) and gqa_attention. Where
they do not, the tolerance is the cause's size:

* f32 rmsnorm: the mean's reduction order (XLA's vs ATen's) — a few ulp.
* f32 silu / gelu and bf16 gelu: XLA's and ATen's exp/tanh approximations
  differ in the last f32 bit, which can flip one bf16 rounding.
* f32 gqa_attention: the einsum and softmax sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import activations as j_act
from dllama_tpu.ops import attention as j_att
from dllama_tpu.ops import norms as j_norms
from dllama_tpu.ops import rope as j_rope
from dllama_tpu_torch.ops import activations as t_act
from dllama_tpu_torch.ops import attention as t_att
from dllama_tpu_torch.ops import norms as t_norms
from dllama_tpu_torch.ops import rope as t_rope

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bits_equal(j, t):
    np.testing.assert_array_equal(_np(j), _np(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    xj, xt = _pair(x, dtype)
    j = jax.jit(j_norms.rmsnorm)(xj, jnp.asarray(w))
    t = t_norms.rmsnorm(xt, torch.from_numpy(w))
    assert t.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16":
        _bits_equal(j, t)
    else:
        np.testing.assert_allclose(_np(t), _np(j), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("style", [j_rope.INTERLEAVED, j_rope.HALF])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_bit_equal(style, dtype):
    rng = np.random.default_rng(2)
    T, H, hd = 3, 4, 64
    x = rng.standard_normal((T, H, hd)).astype(np.float32)
    cos, sin = j_rope.rope_table(32, hd, 10000.0)
    t_cos, t_sin = t_rope.rope_table(32, hd, 10000.0)
    np.testing.assert_array_equal(cos, t_cos)
    np.testing.assert_array_equal(sin, t_sin)
    c, s = cos[7:7 + T, None], sin[7:7 + T, None]
    xj, xt = _pair(x, dtype)
    j = jax.jit(j_rope.apply_rope, static_argnums=3)(xj, jnp.asarray(c), jnp.asarray(s), style)
    t = t_rope.apply_rope(xt, torch.from_numpy(c), torch.from_numpy(s), style)
    _bits_equal(j, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    xj, xt = _pair(x, dtype)
    j, t = jax.jit(j_act.silu)(xj), t_act.silu(xt)
    if dtype == "bfloat16":
        _bits_equal(j, t)
    else:
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_tanh(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    xj, xt = _pair(x, dtype)
    j, t = jax.jit(j_act.gelu_tanh)(xj), t_act.gelu_tanh(xt)
    if dtype == "bfloat16":  # one bf16 ulp where the f32 tanh bits differ
        np.testing.assert_allclose(_np(t), _np(j), rtol=2.0 ** -7, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(t), _np(j), rtol=2e-6, atol=1e-6)
    assert set(j_act.ACTIVATIONS) == set(t_act.ACTIVATIONS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,pos", [(1, 9), (5, 0), (4, 12)])
def test_gqa_attention(dtype, T, pos):
    rng = np.random.default_rng(5 + T + pos)
    S, kv, group, hd = 16, 2, 3, 32
    q = rng.standard_normal((T, kv * group, hd)).astype(np.float32)
    k = rng.standard_normal((S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((S, kv, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    j = jax.jit(j_att.gqa_attention)(qj, kj, vj, jnp.int32(pos))
    t = t_att.gqa_attention(qt, kt, vt, pos)
    assert t.shape == (T, kv * group, hd) and t.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16":
        _bits_equal(j, t)
    else:
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6)
