"""Flash decode's plain version against the JAX package's flash-decode kernel
(interpret mode on the CPU) and against its own dense attention.

Both sides run the same online softmax over 256-position blocks in f32; only
dot-product summation order differs, so the f32 output agrees to 1e-5 of its
magnitude and the bf16 output to one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_decode as j_fd
from dllama_tpu_torch.ops import flash_decode as t_fd
from dllama_tpu_torch.ops.attention import gqa_attention

CACHES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("T,pos", [(1, 255), (1, 300), (4, 254)])  # on / past / across 256
def test_flash_decode_ref_matches_jax_kernel(cache, T, pos):
    rng = np.random.default_rng(T * 1000 + pos)
    L, S, kv, group, hd = 2, 512, 2, 3, 32
    q = rng.standard_normal((T, kv * group, hd)).astype(np.float32)
    kc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    jd, td = CACHES[cache]
    kj, vj = jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd)
    kt, vt = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    np.testing.assert_array_equal(np.asarray(kj.astype(jnp.float32)), kt.float().numpy())
    for qdt_j, qdt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(j_fd.flash_decode_attention(
            jnp.asarray(q).astype(qdt_j), kj, vj, jnp.int32(pos), jnp.int32(1))).astype(np.float32)
        got = t_fd.flash_decode_attention_ref(torch.from_numpy(q).to(qdt_t), kt, vt, pos, 1)
        assert got.dtype == qdt_t and got.shape == q.shape
        tol = (1e-5 if qdt_t == torch.float32 else 2.0 ** -7) * np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("T,pos,S", [(1, 40, 64), (3, 60, 100)])  # S=100: a ragged block
def test_flash_decode_ref_matches_dense_attention(T, pos, S):
    rng = np.random.default_rng(S + pos)
    L, kv, group, hd = 2, 2, 2, 16
    q = torch.from_numpy(rng.standard_normal((T, kv * group, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((L, S, kv, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((L, S, kv, hd)).astype(np.float32))
    got = t_fd.flash_decode_attention(q, kc, vc, pos, 0)  # CPU tensors: the plain version
    dense = gqa_attention(q, kc[0], vc[0], pos)
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-6)
