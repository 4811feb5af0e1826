"""The batched launch forms of flash decode (K4) and rope + cache write (K5)
against the JAX package's (CPU; Pallas in interpret mode).

* ``flash_decode_attention_batched_ref`` — row b attends only over its own
  prefix 0..pos[b] of the batch cache [L, B, S, kv, hd] — agrees with JAX's
  ``flash_decode_attention_batched`` to 1e-5 of the output's magnitude in
  f32 and to 2^-7 of it (one bf16 ulp) in bf16: the same online softmax,
  other summation orders. NaN past a row's own prefix never reaches it.
* ``flash_decode_split_batched_ref``, the batched kernel's arithmetic step
  by step (each row cut into its own chunks), agrees with the unsplit plain
  version to f32 rounding for any chunk cap; each row's plan is
  ``split_plan`` of its own live length.
* ``rope_cache_update_batched`` on CPU tensors rotates q as JAX's
  ``apply_rope`` does and writes the caches bit for bit as JAX's
  ``rope_cache_update_batched`` does, a row at pos >= S clamped to S - 1.
* The solo wrappers, the one-row launches of the same kernels, still equal
  their JAX counterparts on CPU tensors and launch nothing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_decode as j_fd
from dllama_tpu.ops import fused_rope_cache as j_frc
from dllama_tpu.ops.rope import HALF, INTERLEAVED, rope_table
from dllama_tpu.ops.rope import apply_rope as j_apply_rope
from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops import flash_decode as t_fd
from dllama_tpu_torch.ops import fused_rope_cache as t_frc

CACHES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
ACTS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
POS = [0, 300, 700]


def _batch(cache: str, B: int = 3, S: int = 1024, seed: int = 7):
    rng = np.random.default_rng(seed)
    L, kv, group, hd = 2, 2, 3, 32
    q = rng.standard_normal((B, kv * group, hd)).astype(np.float32)
    kc = rng.standard_normal((L, B, S, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, kv, hd)).astype(np.float32)
    jd, td = CACHES[cache]
    return (q, (jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd)),
            (torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_flash_decode_batched_ref_matches_jax_kernel(cache, act):
    q, (kj, vj), (kt, vt) = _batch(cache)
    qj, qt = ACTS[act]
    pos_j, pos_t = jnp.asarray(POS, jnp.int32), torch.tensor(POS, dtype=torch.int32)
    kernels.reset_launches()
    for layer in (0, 1):
        ref = np.asarray(j_fd.flash_decode_attention_batched(
            jnp.asarray(q).astype(qj), kj, vj, pos_j, jnp.int32(layer))).astype(np.float32)
        got = t_fd.flash_decode_attention_batched(torch.from_numpy(q).to(qt), kt, vt, pos_t,
                                                  layer)  # CPU tensors: the plain version
        assert got.dtype == qt and got.shape == q.shape
        tol = (1e-5 if qt == torch.float32 else 2.0 ** -7) * np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= tol, layer
    assert set(kernels.launches.values()) == {0}


def test_flash_decode_batched_ref_ignores_nan_past_each_prefix():
    """NaN beyond each row's own prefix (rows with more history than this
    one included) never leaks into it."""
    q, _, (kt, vt) = _batch("f32", seed=8)
    pos = torch.tensor([10, 400, 1023], dtype=torch.int32)
    clean = t_fd.flash_decode_attention_batched_ref(torch.from_numpy(q), kt, vt, pos, 0)
    kn, vn = kt.clone(), vt.clone()
    for b, p in enumerate(pos.tolist()):
        kn[:, b, p + 1:] = float("nan")
        vn[:, b, p + 1:] = float("nan")
    for fn in (t_fd.flash_decode_attention_batched_ref,
               lambda *a: t_fd.flash_decode_split_batched_ref(*a, max_split=5)):
        got = fn(torch.from_numpy(q), kn, vn, pos, 0)
        assert bool(torch.isfinite(got).all())
        assert (got - clean).abs().max().item() <= 1e-5 * clean.abs().max().item()


@pytest.mark.parametrize("max_split", [1, 2, 3, 9, 64])
def test_batched_split_ref_matches_unsplit(max_split):
    """Any chunk cap gives the unsplit online softmax's answer to f32
    rounding, row by row at mixed positions (a first slot, a last slot)."""
    q, _, (kt, vt) = _batch("f32", B=4, seed=9)
    pos = torch.tensor([0, 31, 300, 1023], dtype=torch.int32)
    ref = t_fd.flash_decode_attention_batched_ref(torch.from_numpy(q), kt, vt, pos, 1)
    got = t_fd.flash_decode_split_batched_ref(torch.from_numpy(q), kt, vt, pos, 1, max_split)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("B,kv", [(1, 8), (4, 8), (8, 8), (3, 2)])
def test_each_row_plans_its_own_chunks(B, kv):
    """The kernel's per-row plan: ``split_plan`` of the row's own live
    length with the chunk cap of B * kv heads. The one-row cap is the solo
    plan's, and the batched grid (n_split from the host bound) covers every
    row that bound allows."""
    n_sm = 132
    cap = t_fd.max_splits(B * kv, n_sm)
    assert cap == t_fd.max_splits(kv * B, n_sm) and 1 <= cap <= t_fd.MAX_SPLITS
    assert B * kv * cap >= min(2 * n_sm, B * kv * t_fd.MAX_SPLITS)
    for bound in (1, 33, 117, 1001, 1024):
        grid = max(1, min(math.ceil(bound / t_fd.TILE), cap))
        for live in range(1, bound + 1):
            n, chunk = t_fd.split_plan(live, B * kv, n_sm)
            assert n <= grid and chunk * (n - 1) < live <= chunk * n


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
def test_rope_cache_batched_ref_bit_equal_to_jax_kernel(style, act, cache):
    rng = np.random.default_rng(len(style) + len(act) + len(cache))
    L, B, S, kv, hd = 2, 4, 16, 2, 32
    pos = np.array([0, 5, S - 1, S + 2], np.int32)  # the last row clamps to S - 1
    k = rng.standard_normal((B, kv, hd)).astype(np.float32) * 4
    v = rng.standard_normal((B, kv, hd)).astype(np.float32) * 4
    cos, sin = rope_table(S, hd, 10000.0)
    c, s = cos[np.minimum(pos, S - 1)][:, None], sin[np.minimum(pos, S - 1)][:, None]
    base = rng.standard_normal((L, B, S, kv, hd)).astype(np.float32)
    ja, ta = ACTS[act]
    jc, tc = CACHES[cache]
    kj, vj = j_frc.rope_cache_update_batched(
        jnp.asarray(k).astype(ja), jnp.asarray(v).astype(ja), jnp.asarray(c), jnp.asarray(s),
        jnp.array(base).astype(jc), jnp.array(base + 1).astype(jc), jnp.asarray(pos),
        jnp.int32(1), style)
    kt, vt = torch.from_numpy(base).to(tc), torch.from_numpy(base + 1).to(tc)
    q = rng.standard_normal((B, 2 * kv, hd)).astype(np.float32) * 4
    qj = jax.jit(j_apply_rope, static_argnums=3)(jnp.asarray(q).astype(ja), jnp.asarray(c),
                                                 jnp.asarray(s), style)
    kernels.reset_launches()
    qt = t_frc.rope_cache_update_batched(
        torch.from_numpy(q).to(ta), torch.from_numpy(k).to(ta), torch.from_numpy(v).to(ta),
        torch.from_numpy(cos), torch.from_numpy(sin), kt, vt, torch.from_numpy(pos), 1, style)
    assert set(kernels.launches.values()) == {0}  # CPU tensors: the plain version
    np.testing.assert_array_equal(_bits(qj), _bits(qt))
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))


@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
def test_solo_wrappers_still_equal_jax(cache):
    """The solo forms on CPU tensors: flash decode within 1e-5 of its magnitude,
    rope + cache write bit for bit, nothing launched."""
    rng = np.random.default_rng(11)
    L, S, kv, group, hd, T, pos = 2, 512, 2, 3, 32, 4, 300
    jd, td = CACHES[cache]
    q = rng.standard_normal((T, kv * group, hd)).astype(np.float32)
    kc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    kernels.reset_launches()
    ref = np.asarray(j_fd.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd), jnp.int32(pos),
        jnp.int32(1)))
    got = t_fd.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(kc).to(td),
                                      torch.from_numpy(vc).to(td), pos, 1)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()

    k = rng.standard_normal((T, kv, hd)).astype(np.float32)
    cos, sin = rope_table(S, hd, 10000.0)
    c, s = cos[pos:pos + T, None], sin[pos:pos + T, None]
    kj, vj = j_frc.rope_cache_update(
        jnp.asarray(k), jnp.asarray(k + 1), jnp.asarray(c), jnp.asarray(s),
        jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd), jnp.int32(pos), jnp.int32(1))
    kt, vt = torch.from_numpy(kc).to(td, copy=True), torch.from_numpy(vc).to(td, copy=True)
    qt = t_frc.rope_cache_update(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(k + 1), torch.from_numpy(cos),
                                 torch.from_numpy(sin), kt, vt, pos, 1)
    qj = jax.jit(j_apply_rope, static_argnums=3)(jnp.asarray(q), jnp.asarray(c), jnp.asarray(s),
                                                 INTERLEAVED)
    np.testing.assert_array_equal(_bits(qj), _bits(qt))
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))
    assert set(kernels.launches.values()) == {0}
