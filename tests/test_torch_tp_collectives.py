"""The port's tensor-parallel gathers (``parallel.collectives``) against the
JAX package's (``dllama_tpu/parallel/collectives.py``), on the CPU.

* The Q80 wire codec is bit-equal to JAX's ``_q80_encode``/``_q80_decode``:
  the same int8 payload (quants, then each block's f32 scale bytes) and the
  same decoded f32 bits, all-zero blocks and round-half-to-even ties
  included.
* In a real gloo world of 2 and of 4 processes (started once for the
  module), a plain gather equals the ranks' inputs concatenated in rank
  order exactly, in f32 and bf16; a Q80 gather equals each rank's
  encode-then-decode (JAX's codec) concatenated, bit for bit; the byte
  counter equals what the gather sent: (size - 1) x the local payload. A
  world of one still gathers through gloo.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.parallel import collectives as jc
from dllama_tpu_torch.parallel import collectives as tc
from dllama_tpu_torch.parallel.group import LocalWorld, TPGroup
from tests import torch_tp_ranks as R


@pytest.fixture(scope="module")
def world():
    with LocalWorld(4, threads=1, timeout_s=120) as w:
        yield w


def _wire_input(lead: tuple, f: int, seed: int) -> np.ndarray:
    """f32 [*lead, f] of 32-value blocks at scales from 1e-30 to 1e4, the
    first block all zero and the second one of exact halves (ties at
    scale 1)."""
    rng = np.random.default_rng(seed)
    scales = 10.0 ** rng.uniform(-30, 4, size=(*lead, f // 32, 1))
    x = (rng.standard_normal((*lead, f // 32, 32)) * scales).astype(np.float32)
    x[..., 0, :] = 0.0
    if f >= 64:
        x[..., 1, :] = np.concatenate([[127.0], np.arange(31) - 14.5]).astype(np.float32)
    return x.reshape(*lead, f)


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
@pytest.mark.parametrize("f", [32, 256])
def test_q80_wire_bit_equal_to_jax(lead, f):
    x = _wire_input(lead, f, seed=f + len(lead))
    want = np.asarray(jc._q80_encode(jnp.asarray(x)))
    got = tc.q80_encode(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int8 and got.shape == (*lead, f + f // 8)
    np.testing.assert_array_equal(got, want)
    back_j = np.asarray(jc._q80_decode(jnp.asarray(want), f))
    back_t = tc.q80_decode(torch.from_numpy(got), f).numpy()
    np.testing.assert_array_equal(back_t.view(np.uint32), back_j.view(np.uint32))
    assert not back_t[..., :32].any()  # the all-zero block decodes to exact zeros
    if f >= 64:  # ties round half to even: -14.5 -> -14, -13.5 -> -14, 0.5 -> 0
        q = got[..., 32:64].reshape(-1, 32)[0]
        np.testing.assert_array_equal(q[1:4], [-14, -14, -12])


def test_compressed_gather_refuses_a_ragged_block_before_any_collective():
    group = TPGroup(0, 2, torch.device("cpu"), "gloo")  # never joined: nothing is sent
    with pytest.raises(ValueError, match="multiple of the 32-value"):
        tc.gather_columns(torch.zeros(1, 48), group, compress=True)
    assert group.sent_bytes == 0


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_gather_columns_in_a_gloo_world(world, size, compress):
    rows, f, seed = 3, 64, 7
    dtype = torch.float32
    results = world.run(R.gather_case, seed, rows, f, compress, dtype, size=size)
    shards = [R.shard_input(seed, r, rows, f).numpy() for r in range(size)]
    if compress:
        shards = [np.asarray(jc._q80_decode(jc._q80_encode(jnp.asarray(s)), f)) for s in shards]
    want = np.concatenate(shards, axis=-1)
    payload = rows * ((f + f // 8) if compress else f * 4)
    for out, sent in results:
        np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))
        assert sent == (size - 1) * payload


@pytest.mark.parametrize("size", [2, 4])
def test_bf16_gather_is_exact_and_counts_two_bytes_a_value(world, size):
    rows, f, seed = 2, 96, 11
    results = world.run(R.gather_case, seed, rows, f, False, torch.bfloat16, size=size)
    want = np.concatenate([R.shard_input(seed, r, rows, f, torch.bfloat16).float().numpy()
                           for r in range(size)], axis=-1)
    for out, sent in results:
        np.testing.assert_array_equal(out, want)
        assert sent == (size - 1) * rows * f * 2
