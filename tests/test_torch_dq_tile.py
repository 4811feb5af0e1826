"""The tensor-core prefill tile's host side, on the CPU (the kernel itself
runs only on the card: tests/test_torch_cuda_kernels.py).

* ``tile_plan`` is a pure function of the shape: every 64-row k-tile lies
  in exactly one split, the splits in order, every (T, O) output in exactly
  one block; it takes neither x's dtype nor the fused-norm flag, so a fused
  launch sums in the unfused launch's order; at the Llama-3-8B widths every
  one of an H100's 132 SMs gets a block, and K is split only where the
  output tiles leave a wave of resident blocks unfilled, and no further.
* ``q40_plan`` and ``q80_plan`` send up to ``GEMV_MAX_T`` rows to the decode
  kernels and more to the tile.
* At the prefill bucket (T = 128) on a narrow, ragged width, the plain
  versions the tile is held to on the card match the JAX package's Pallas
  kernels (interpret mode) within 1e-5 * max|ref|: summation order only.
  With the fused norm both sides take the same ``rmsnorm_inv`` (XLA's and
  ATen's f32 means may differ in the last ulp, which can flip the bf16
  rounding of a normalized element: tests/test_torch_q80.py holds that
  difference separately).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import qmatmul as jq
from dllama_tpu_torch.ops import qmatmul as tq

#: Llama-3-8B projection widths (K, O)
LLAMA3_8B = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
             "w2": (14336, 4096), "wcls": (4096, 128256)}
SHAPES = [(9, 512, 136), (17, 1024, 100), (100, 4096, 40), (128, 4096, 4096),
          (128, 14336, 4096), (200, 512, 516), (512, 4096, 6144), (128, 64, 8)]


@pytest.mark.parametrize("n_sm", [1, 8, 132])
@pytest.mark.parametrize("T,K,O", SHAPES)
def test_tile_plan_covers_every_k_tile_and_output_once(T, K, O, n_sm):
    m_tiles, n_tiles, ksplit, per = tq.tile_plan(T, K, O, n_sm)
    nsb = K // tq.TILE_K
    covered = [s for split in range(ksplit)
               for s in range(split * per, min((split + 1) * per, nsb))]
    assert covered == list(range(nsb))  # once each, in split order, none empty
    assert all(split * per < nsb for split in range(ksplit))
    rows = np.zeros(T, int)
    cols = np.zeros(O, int)
    for m in range(m_tiles):
        rows[m * tq.TILE_M:(m + 1) * tq.TILE_M] += 1
    for n in range(n_tiles):
        cols[n * tq.TILE_N:(n + 1) * tq.TILE_N] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert ksplit <= 65535 and m_tiles <= 65535  # grid.y, grid.z


def test_tile_plan_depends_on_the_shape_alone():
    assert list(inspect.signature(tq.tile_plan).parameters) == ["T", "K", "O", "n_sm"]
    # the Q80 GEMV's residency (which depends on x's dtype) never reaches the tile
    for T in (9, 20, 128, 512):
        plans = {tq.q80_plan(T, 4096, 6144, 132, per_sm) for per_sm in (1, 2, 3, 4)}
        assert len(plans) == 1, T


@pytest.mark.parametrize("T", [128, 512])
@pytest.mark.parametrize("name", list(LLAMA3_8B))
def test_tile_plan_fills_one_wave_at_llama3_8b_widths(name, T):
    K, O = LLAMA3_8B[name]
    m_tiles, n_tiles, ksplit, per = tq.tile_plan(T, K, O, 132)
    assert m_tiles == math.ceil(T / 128)  # one M tile covers the 128-bucket
    blocks, slots = m_tiles * n_tiles * ksplit, 132 * tq.TILE_BLOCKS_PER_SM
    assert blocks >= 132, (name, m_tiles, n_tiles, ksplit)  # every SM gets a block
    if m_tiles * n_tiles >= slots:
        assert ksplit == 1  # no split where the tiles fill a wave of resident blocks
    elif ksplit > 1:
        assert blocks <= slots  # a split grid stays within one wave


@pytest.mark.parametrize("T", list(range(1, 20)) + [100, 128, 200, 512])
def test_plans_route_decode_rows_to_the_decode_kernels_and_more_to_the_tile(T):
    want = "gemv" if T <= tq.GEMV_MAX_T else "tile"
    route40, ksplit40, rows40 = tq.q40_plan(T, 4096, 6144, 132, 2)
    route80, ksplit80, rows80 = tq.q80_plan(T, 4096, 6144, 132, 2)
    assert (route40, route80) == (want, want)
    if want == "gemv":
        assert (ksplit40, rows40) == tq.gemv_plan(T, 4096, 6144, 132, 2, tq.q40_gemv_cols())
        assert (ksplit80, rows80) == tq.gemv_plan(T, 4096, 6144, 132, 2)
    else:
        assert (ksplit40, rows40 // tq.TILE_K) == tq.tile_plan(T, 4096, 6144, 132)[2:]
        assert (ksplit80, rows80 // tq.TILE_K) == tq.tile_plan(T, 4096, 6144, 132)[2:]


def _port_qt(qt_j, kind, K):
    return tq.QuantTensor(*(np.asarray(getattr(qt_j, n)) for n in ("w", "s", "s2")),
                          kind=kind, k_logical=K).to("cpu")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,nosub", [("q40", True), ("q40", False), ("q80", None)])
def test_plain_versions_match_jax_kernels_at_the_prefill_bucket(kind, nosub, fused):
    T, K, O = 128, 512, 136
    rng = np.random.default_rng(K + O + (nosub is True) + 2 * fused)
    qt_j = jq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), kind)
    qt_t = _port_qt(qt_j, kind, K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jkw, tkw = {}, {}
    if fused:  # bf16 activations, as the model's residual stream holds them
        nw = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
        inv = jq.rmsnorm_inv(xj, 1e-5)  # one inv for both: the epilogue is under test
        jkw = dict(norm_w=jnp.asarray(nw), norm_inv=inv)
        tkw = dict(norm_w=torch.from_numpy(nw), norm_inv=torch.tensor(np.asarray(inv)))
    if kind == "q40":
        ref = jq.q40_matmul(xj, qt_j.w, qt_j.s, qt_j.s2, nosub=nosub, **jkw)
        got = tq.q40_matmul_ref(xt, qt_t.w, qt_t.s, qt_t.s2, nosub=nosub, **tkw)
    else:
        ref = jq.q80_matmul(xj, qt_j.w, qt_j.s, **jkw)
        got = tq.q80_matmul_ref(xt, qt_t.w, qt_t.s, **tkw)
    ref = np.asarray(ref, np.float32)
    assert got.shape == (T, O) and ref.shape == (T, O)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
