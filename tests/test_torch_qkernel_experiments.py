"""The port's Q40 kernel-variant shootout against the JAX script (CPU).

``scripts/qkernel_experiments.py`` is imported by path with
``DLLAMA_PLATFORM=cpu`` (its Pallas kernels run in interpret mode). The
port's variants B, E, F and G run their plain versions on CPU tensors and
must agree with the script's functions on the same matrix and activation
(K = 512, O = 256, T = 2): every dot operand is rounded alike (bf16, or the
same int8 quantization of x for E), so the outputs differ only by summation
order, within 1e-5 of their magnitude. ``check`` passes for every variant,
and the entry point runs them all.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import qmatmul as jq
from dllama_tpu_torch import kernels, qkernel_experiments as qe
from dllama_tpu_torch.ops import qmatmul as tq

ROOT = Path(__file__).resolve().parent.parent
K, O, T = 512, 256, 2


@pytest.fixture(scope="module")
def jax_script():
    saved = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLLAMA_PLATFORM", "cpu")
        spec = importlib.util.spec_from_file_location(
            "jax_qkernel_experiments", ROOT / "scripts" / "qkernel_experiments.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    sys.path[:] = saved  # the script puts scripts/ first on the path
    return mod


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(3)
    qt_j = jq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), "q40")
    qt_t = tq.QuantTensor(*(np.asarray(getattr(qt_j, n)) for n in ("w", "s", "s2")),
                          kind="q40", k_logical=K).to("cpu")
    x = rng.standard_normal((T, K)).astype(np.float32)
    return qt_j, qt_t, x


@pytest.mark.parametrize("name", ["B", "E", "F", "G"])
def test_variant_plain_version_matches_the_jax_script(jax_script, matrix, name):
    qt_j, qt_t, x = matrix
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jax_script.VARIANTS[name][0](xj, qt_j))
    kernels.reset_launches()
    got = qe.VARIANTS[name][0](xt, qt_t)
    assert got.dtype == torch.float32 and got.shape == (T, O)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only


def test_variant_tables_agree(jax_script):
    assert list(qe.VARIANTS) == list(jax_script.VARIANTS)
    assert {n: m for n, (_, m) in qe.VARIANTS.items()} == {
        n: m for n, (_, m) in jax_script.VARIANTS.items()}


def test_every_variant_passes_check_on_the_cpu(capsys):
    rows = qe.main(["all", str(K), str(O)], device="cpu")
    assert [r["variant"] for r in rows] == list(qe.VARIANTS)
    assert all(r["ok"] and "ms" not in r for r in rows)  # no timing off the card
    assert "stacked A/B skipped" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown variant"):
        qe.main(["Z"], device="cpu")


def test_k7_activation_quantization_pads_and_scales_per_block():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 100)).astype(np.float32))
    x[1, 64:96] = 0.0  # an all-zero block: scale 0, quants 0
    xq, sx = qe.quantize_q80_rows(x, 128)
    assert xq.dtype == torch.int8 and xq.shape == (3, 128) and sx.shape == (3, 4)
    assert bool((xq[:, 100:] == 0).all()) and bool((xq[1, 64:96] == 0).all())
    assert float(sx[1, 2]) == 0.0
    padded = torch.nn.functional.pad(x, (0, 28)).reshape(3, 4, 32)
    assert torch.equal(sx, padded.abs().amax(-1) / 127.0)
    assert torch.equal(xq.abs().reshape(3, 4, 32).amax(-1)[sx > 0],
                       torch.full_like(sx[sx > 0], 127, dtype=torch.int8))


@pytest.mark.parametrize("rows", [12])
def test_variant_f_past_the_decode_rows_matches_the_jax_script(jax_script, matrix, rows):
    """K6's wide mode takes any T, as the script's ``variant_f`` does: past
    ``GEMV_MAX_T`` rows both of the port's modes take the tile on the card,
    and on the CPU the plain version."""
    qt_j, qt_t, _ = matrix
    assert rows > tq.GEMV_MAX_T
    x = np.random.default_rng(rows).standard_normal((rows, K)).astype(np.float32)
    ref = np.asarray(jax_script.variant_f(jnp.asarray(x, jnp.bfloat16), qt_j))
    got = qe.VARIANTS["F"][0](torch.from_numpy(x).to(torch.bfloat16), qt_t)
    assert got.shape == (rows, O)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("rows", [3, 8, 12])
def test_variant_e_at_more_rows_matches_the_jax_script(jax_script, matrix, rows):
    """K7 takes any T, as the script's ``variant_e`` does: up to 8 rows in
    one row tile of the kernel on the card, 12 in two; on the CPU the plain
    version."""
    qt_j, qt_t, _ = matrix
    x = np.random.default_rng(rows).standard_normal((rows, K)).astype(np.float32)
    ref = np.asarray(jax_script.variant_e(jnp.asarray(x, jnp.bfloat16), qt_j))
    got = qe.VARIANTS["E"][0](torch.from_numpy(x).to(torch.bfloat16), qt_t)
    assert got.shape == (rows, O)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("T", [1, 3, 8, 9, 12, 20])
@pytest.mark.parametrize("K,O", [(4096, 11008), (14336, 4096), (512, 256), (4096, 100)])
def test_int8_plan_covers_k_in_superblocks_within_one_wave(T, K, O):
    """K7's plan: row tiles of 8, splits of whole superblocks that cover K
    exactly once, a staged activation that fits the kernel's 16384 bytes,
    and no more splits than one wave of 2 blocks on each of 132 SMs holds
    (unless the staging forces them)."""
    n_sm, per_sm = 132, 2
    tiles, ksplit, rows = qe.int8_plan(T, K, O, n_sm, per_sm)
    assert tiles == -(-T // 8)
    assert rows % 64 == 0 and (ksplit - 1) * rows < K <= ksplit * rows
    tt = next(t for t in (1, 2, 4, 8) if t >= min(T, 8))
    assert rows * tt <= 16384
    blocks = -(-O // qe.INT8_COLS) * tiles
    assert ksplit <= max(n_sm * per_sm // blocks, -(-K * tt // 16384), 1)


def test_int8_plan_at_the_shootout_width():
    # 86 strips of 128 columns: 3 splits of 22, 22 and 20 superblocks fill 258 of 264 slots
    assert qe.int8_plan(1, 4096, 11008, 132, 2) == (1, 3, 1408)
    # two row tiles of 8: 8 staged rows of 4096 would be 32 KB, so 2 splits of 2048
    assert qe.int8_plan(12, 4096, 11008, 132, 2) == (2, 2, 2048)
