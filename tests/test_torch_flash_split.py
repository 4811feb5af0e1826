"""Flash decode's split-sequence form (csrc/flash_decode.cu's grid) on the CPU.

``flash_decode_split_ref`` is the kernel's computation step by step: the live
prefix cut into chunks, one online-softmax partial ``(m, l, acc)`` per chunk
over 32-position tiles, the partials merged in split order. It is held
against the JAX package's flash-decode kernel (interpret mode on the CPU):
only the order of the f32 sums differs, so the f32 output agrees to 1e-5 of
its magnitude and the bf16 output to 2^-7 of it (one bf16 ulp). The plan
that picks the kernel's chunks is checked for its invariants.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_decode as j_fd
from dllama_tpu_torch.ops import flash_decode as t_fd

CACHES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}

# (T, pos, n_split): pos 0 (one position, one chunk); chunks of 43 and 51
# positions (not multiples of 32); T 16 at pos 40 in 7 chunks of 8, whose
# last chunk [48, 56) lies past pos + t for rows t < 8 (fully masked there)
SPLITS = [(1, 0, 1), (1, 300, 7), (4, 254, 5), (16, 40, 7), (16, 250, 3), (1, 1000, 32)]


def _inputs(T, pos, S, cache, seed):
    rng = np.random.default_rng(seed)
    L, kv, group, hd = 2, 2, 3, 32
    q = rng.standard_normal((T, kv * group, hd)).astype(np.float32)
    kc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    jd, td = CACHES[cache]
    return (q, (jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd)),
            (torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)))


@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("T,pos,n_split", SPLITS)
def test_split_ref_matches_jax_kernel(cache, T, pos, n_split):
    S = 1024 if pos + T > 512 else 512
    q, (kj, vj), (kt, vt) = _inputs(T, pos, S, cache, T * 1000 + pos + n_split)
    for qdt_j, qdt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(j_fd.flash_decode_attention(
            jnp.asarray(q).astype(qdt_j), kj, vj, jnp.int32(pos), jnp.int32(1))).astype(np.float32)
        got = t_fd.flash_decode_split_ref(torch.from_numpy(q).to(qdt_t), kt, vt, pos, 1, n_split)
        assert got.dtype == qdt_t and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all())
        tol = (1e-5 if qdt_t == torch.float32 else 2.0 ** -7) * np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("n_split", [1, 2, 3, 9, 56])
def test_split_count_moves_only_rounding(n_split):
    """Any cut of the live prefix gives the unsplit online softmax's answer
    to f32 rounding."""
    T, pos, S = 16, 40, 64
    q, _, (kt, vt) = _inputs(T, pos, S, "f32", 5)
    qt = torch.from_numpy(q)
    ref = t_fd.flash_decode_attention_ref(qt, kt, vt, pos, 0)
    got = t_fd.flash_decode_split_ref(qt, kt, vt, pos, 0, n_split)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("kv", [1, 2, 8, 32])
@pytest.mark.parametrize("n_sm", [1, 8, 132])
def test_split_plan_invariants(kv, n_sm):
    for live in list(range(1, 300)) + [1001, 1016, 4001, 8192, 131072]:
        n, chunk = t_fd.split_plan(live, kv, n_sm)
        assert 1 <= n <= min(t_fd.MAX_SPLITS, math.ceil(live / t_fd.TILE))
        # every chunk holds at least one live position, together all of them
        assert chunk * (n - 1) < live <= chunk * n
        if live >= t_fd.TILE * n:  # no more chunks than 32-position tiles
            assert chunk >= t_fd.TILE


def test_split_plan_fills_the_h100_at_the_decode_shape():
    n, chunk = t_fd.split_plan(1001, 8, 132)  # Llama-3-8B: kv 8, pos 1000
    assert 8 * n >= 132 and chunk <= t_fd.TILE
    assert t_fd.split_plan(1, 8, 132) == (1, 1)  # pos 0: one position, one chunk
