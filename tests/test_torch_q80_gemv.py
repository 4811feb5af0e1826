"""The Q80 decode GEMV's plan and its dispatch by T (csrc/q80_matmul.cu), on
the CPU: pure functions of the shapes, so checked here exhaustively.
"""

import math

import numpy as np
import pytest
import torch

from dllama_tpu_torch.models.llama import DECODE_MAX_T
from dllama_tpu_torch.ops import qmatmul as tq

#: Llama-3-8B projection widths (K, O) and the small widths of the CPU tests
WIDTHS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256),
          (256, 24), (512, 40), (1024, 16), (256, 102), (1024, 516), (64, 8)]


@pytest.mark.parametrize("K,O", WIDTHS)
@pytest.mark.parametrize("n_sm,per_sm", [(1, 1), (8, 2), (132, 1), (132, 2), (132, 3)])
def test_gemv_plan_puts_every_scale_block_in_one_split(K, O, n_sm, per_sm):
    for T in range(1, tq.GEMV_MAX_T + 1):
        ksplit, rows = tq.gemv_plan(T, K, O, n_sm, per_sm)
        assert ksplit >= 1 and rows % 64 == 0
        starts = [s * rows for s in range(ksplit)]
        assert starts[-1] < K <= starts[-1] + rows  # no empty split, K covered
        owner = np.full(K // 32, -1)
        for s, k0 in enumerate(starts):
            blocks = range(k0 // 32, min(k0 + rows, K) // 32)
            assert (owner[blocks] == -1).all()
            owner[blocks] = s
        assert (owner >= 0).all()
        tt = 1 << (T - 1).bit_length()
        assert rows * tt <= tq._GEMV_X_FLOATS  # the staged activation fits


@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_gemv_plan_fills_one_wave_at_llama3_8b_widths(per_sm):
    """At T = 1 the blocks fit one wave of resident blocks (a second would
    take as long as the first) and fill more than half of it."""
    cap = 132 * per_sm
    for K, O in WIDTHS[:5]:
        ksplit, _ = tq.gemv_plan(1, K, O, 132, per_sm)
        blocks = math.ceil(O / tq._GEMV_COLS) * ksplit
        assert cap / 2 < blocks <= cap or ksplit == 1, (K, O, blocks)


def test_q80_dispatch_threshold():
    assert 1 <= tq.GEMV_MAX_T <= DECODE_MAX_T
    for T in range(1, 130):
        route, ksplit, rows = tq.q80_plan(T, 4096, 4096, 132, 2)
        assert route == ("gemv" if T <= tq.GEMV_MAX_T else "tile"), T
        assert ksplit >= 1 and rows % 64 == 0 and (ksplit - 1) * rows < 4096
    assert tq.q80_plan(1, 4096, 6144, 132, 2)[0] == "gemv"  # decode takes the GEMV


def test_q80_wrapper_refuses_other_devices():
    w = torch.zeros((64, 8), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tq.q80_matmul(torch.zeros((1, 64), device="meta"), w, s)


def test_split_sweep_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the sweep would run")
    from dllama_tpu_torch import split_sweep

    with pytest.raises(SystemExit, match="CUDA GPU"):
        split_sweep.main([])
