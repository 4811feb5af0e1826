"""The Q40 decode GEMV's host side (csrc/q40_matmul.cu ``dllama_q40_gemv``),
on the CPU; the kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py).

* ``q40_plan`` is a pure function of the shape and the residency: every
  64-row superblock lies in exactly one split, no split is empty, the
  staged activation fits the block's shared memory, and at T = 1 the
  blocks fill more than half of one wave of resident blocks and no more
  than one; T <= ``GEMV_MAX_T`` takes the GEMV, more rows the tile.
* The kernel's per-weight arithmetic, emulated in numpy: the byte permute
  that makes the float 2^23 + nibble, minus 2^23 + sub, is exact for every
  nibble and both subs, and bf16((q - sub) * delta) from it, rounded in
  pairs, is the weight ``q40_dot_ref`` multiplies.
* Every ``extern "C"`` entry point of ``csrc/*.cu`` has its argument types
  in ``kernels._SIGNATURES``, and every entry there has a function.
"""

import inspect
import math
import re

import numpy as np
import pytest
import torch

from dllama_tpu_torch import kernels, qkernel_experiments
from dllama_tpu_torch.ops import qmatmul as tq

#: Llama-3-8B projection widths (K, O) and the small widths of the CPU tests
WIDTHS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256),
          (512, 24), (512, 40), (1024, 16), (512, 102), (1024, 516), (512, 8)]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("K,O", WIDTHS)
@pytest.mark.parametrize("n_sm,per_sm", [(1, 1), (8, 2), (132, 1), (132, 2), (132, 3)])
def test_q40_plan_puts_every_superblock_in_one_split(K, O, n_sm, per_sm, wide):
    for T in range(1, tq.GEMV_MAX_T + 1):
        route, ksplit, rows = tq.q40_plan(T, K, O, n_sm, per_sm, wide)
        assert route == "gemv" and ksplit >= 1 and rows % 64 == 0
        starts = [s * rows for s in range(ksplit)]
        assert starts[-1] < K <= starts[-1] + rows  # no empty split, K covered
        owner = np.full(K // 64, -1)
        for s, k0 in enumerate(starts):
            sbs = range(k0 // 64, min(k0 + rows, K) // 64)
            assert (owner[sbs] == -1).all()
            owner[sbs] = s
        assert (owner >= 0).all()
        tt = 1 << (T - 1).bit_length()
        assert rows * tt <= tq._GEMV_X_FLOATS  # the staged activation fits


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_q40_plan_fills_one_wave_at_llama3_8b_widths(per_sm, wide):
    """At T = 1 the blocks fit one wave of resident blocks (a second would
    take as long as the first) and fill more than half of it."""
    cap = 132 * per_sm
    for K, O in WIDTHS[:5]:
        _, ksplit, _ = tq.q40_plan(1, K, O, 132, per_sm, wide)
        blocks = math.ceil(O / tq.q40_gemv_cols(wide)) * ksplit
        assert cap / 2 < blocks <= cap or ksplit == 1, (K, O, blocks)


def test_q40_gemv_columns_per_block():
    """The plan's block width is the kernel's: a warp's strip of 8 lane
    groups x 16 columns, kWarps / kRowWarps strips a block, kWarps strips
    in K6's wide blocks."""
    src = (kernels.CSRC / "q40_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert "constexpr int kWarpCols = 8 * kLaneCols;" in src
    strip = 8 * const("kLaneCols")
    assert tq.q40_gemv_cols() == strip * const("kWarps") // const("kRowWarps") == 256
    assert tq.q40_gemv_cols(wide=True) == strip * const("kWarps") == 1024


def test_q40_dispatch_threshold_and_plan_inputs():
    for T in range(1, 130):
        route, ksplit, rows = tq.q40_plan(T, 4096, 4096, 132, 2)
        assert route == ("gemv" if T <= tq.GEMV_MAX_T else "tile"), T
        assert ksplit >= 1 and rows % 64 == 0 and (ksplit - 1) * rows < 4096
    # the plan never sees x's dtype or the fused norm: both launches sum alike
    assert list(inspect.signature(tq.q40_plan).parameters) == [
        "T", "K", "O", "n_sm", "per_sm", "wide"]


def test_q40_wrappers_refuse_other_devices():
    w = torch.zeros((32, 8), dtype=torch.uint8, device="meta")
    s = torch.zeros((1, 8), dtype=torch.float32, device="meta")
    x = torch.zeros((1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tq.q40_matmul(x, w, s, s)
    with pytest.raises(ValueError, match="unsupported device"):
        qkernel_experiments.q40_nosub_matmul(x, w, s, s)


def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (x >> np.uint64(8 * src)) & np.uint64(0xFF) if src < 4 else \
            np.uint64((y >> (8 * (src - 4))) & 0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def _nibble_floats(words: np.ndarray, sub: float) -> tuple[list, list]:
    """The kernel's q - sub for the low and high nibble of each byte b of
    each word: mask in place, permute into 2^23 + nibble, subtract."""
    magic = np.float32(8388608.0 + sub)
    wl = words & np.uint32(0x0F0F0F0F)
    wh = (words >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    lo = [_byte_perm(wl, 0x4B000000, 0x7540 | b).view(np.float32) - magic for b in range(4)]
    hi = [_byte_perm(wh, 0x4B000000, 0x7540 | b).view(np.float32) - magic for b in range(4)]
    return lo, hi


def _bf16_pair_bits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """__floats2bfloat162_rn(a, b) as the 32-bit word (a low, b high): each
    rounded to nearest even, no NaNs here."""
    def rne(v):
        bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
        return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    return (rne(a) | (rne(b) << 16)).astype(np.uint32)


@pytest.mark.parametrize("sub", [0.0, 8.0])
def test_magic_exponent_nibble_decode_is_exact(sub):
    nib = np.arange(256, dtype=np.uint32)  # every byte: every (lo, hi) nibble pair
    words = nib | (nib[::-1] << 8) | (((nib * 7) & 0xFF) << 16) | (((nib * 13) & 0xFF) << 24)
    lo, hi = _nibble_floats(words, sub)
    for b in range(4):
        byte = (words >> np.uint32(8 * b)) & np.uint32(0xFF)
        assert np.array_equal(lo[b], (byte & 15).astype(np.float32) - np.float32(sub))
        assert np.array_equal(hi[b], (byte >> 4).astype(np.float32) - np.float32(sub))
    assert set(np.concatenate(lo).tolist()) == {float(q) - sub for q in range(16)}


@pytest.mark.parametrize("sub", [0.0, 8.0])
def test_kernel_weight_is_q40_dot_refs_weight(sub):
    """bf16((q - sub) * delta) built the kernel's way, laid out by the
    packed layout (byte 32s + j: rows 64s + j and 64s + 32 + j), is the
    matrix ``q40_dot_ref`` multiplies: one-hot activation rows pick it out."""
    rng = np.random.default_rng(int(sub) + 3)
    K, O = 128, 8
    packed = rng.integers(0, 256, (K // 2, O), dtype=np.uint8)
    s_lo = (rng.standard_normal((K // 64, O)) * 0.01).astype(np.float32)
    s_hi = (rng.standard_normal((K // 64, O)) * 0.01).astype(np.float32)
    words = packed.reshape(K // 2, O // 4, 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    lo, hi = _nibble_floats(words, sub)
    want = np.zeros((K, O), np.float32)
    for prow in range(K // 2):
        s, j = divmod(prow, 32)
        for c in range(O):
            ql, qh = lo[c % 4][prow, c // 4], hi[c % 4][prow, c // 4]
            bits = _bf16_pair_bits(np.float32(ql) * s_lo[s, c], np.float32(qh) * s_hi[s, c])
            want[64 * s + j, c] = (bits << np.uint32(16)).view(np.float32)
            want[64 * s + 32 + j, c] = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    got = tq.q40_dot_ref(torch.eye(K), torch.from_numpy(packed), torch.from_numpy(s_lo),
                         torch.from_numpy(s_hi), sub)
    assert np.array_equal(got.numpy(), want)


def _extern_c_functions() -> dict:
    """{name: [parameter declarations]} of every ``extern "C"`` function in
    the kernel sources."""
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\s*\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = [p.strip() for p in m.group(2).split(",") if p.strip()]
    return found


def test_every_entry_point_has_its_signature():
    found = _extern_c_functions()
    assert set(found) == set(kernels._SIGNATURES)
    for name, params in found.items():
        want = [kernels._P if "*" in p else kernels._F if p.startswith("float")
                else kernels._L if p.startswith("long long") else kernels._I for p in params]
        assert list(kernels._SIGNATURES[name]) == want, name
