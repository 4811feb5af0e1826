"""Rope + cache write's plain version against the JAX package's fused kernel
(interpret mode on the CPU): the same single-rounding rotation and the same
cast chain (f32 -> activation dtype -> cache dtype, float8 overflow to NaN),
so the caches must be bit-equal, the end clamp included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import fused_rope_cache as j_frc
from dllama_tpu.ops.rope import HALF, INTERLEAVED, rope_table
from dllama_tpu_torch.ops import fused_rope_cache as t_frc

ACT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
         "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("T,pos", [(1, 5), (3, 14)])  # 14 + 3 > S=16: start clamps to 13
def test_rope_cache_ref_bit_equal_to_jax_kernel(style, act, cache, T, pos):
    rng = np.random.default_rng(T + pos)
    L, S, kv, hd = 2, 16, 2, 32
    k = rng.standard_normal((T, kv, hd)).astype(np.float32) * 4
    v = rng.standard_normal((T, kv, hd)).astype(np.float32) * 4
    cos, sin = rope_table(S + T, hd, 10000.0)
    c, s = cos[pos:pos + T, None], sin[pos:pos + T, None]
    base = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    ja, ta = ACT[act]
    jc, tc = CACHE[cache]
    kj, vj = j_frc.rope_cache_update(
        jnp.asarray(k).astype(ja), jnp.asarray(v).astype(ja), jnp.asarray(c), jnp.asarray(s),
        jnp.array(base).astype(jc), jnp.array(base + 1).astype(jc), jnp.int32(pos), jnp.int32(1),
        style)
    kt = torch.from_numpy(base).to(tc)
    vt = torch.from_numpy(base + 1).to(tc)
    t_frc.rope_cache_update_ref(torch.from_numpy(k).to(ta), torch.from_numpy(v).to(ta),
                                torch.from_numpy(c), torch.from_numpy(s), kt, vt, pos, 1, style)
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))


def test_f8_cast_overflows_to_nan_like_the_reference():
    vals = np.array([1.0, 447.0, 448.0, 460.0, 464.0, 465.0, 480.0, 1e6, -1e6, np.inf,
                     np.nan, 1e-10, 0.0019], np.float32)
    j = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    t = t_frc.cast_cache(torch.from_numpy(vals), torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    np.testing.assert_array_equal(j[~np.isnan(j)], t[~np.isnan(t)])
