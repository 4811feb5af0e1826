"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips (the kernels
cannot run on the CPU). On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: the Q40/Q80 matmuls (K1, K3, K6), the Q40xQ80 integer dot
(K7) and flash decode sum in another order than their plain versions (f32
accumulation of exact bf16 products or exact block dots; online softmax), so
they are held to 1e-5 of the output's magnitude in f32; the rope + cache
write does the same single-rounding arithmetic as its plain version, so the
caches must be bit-equal. The fused-norm epilogue (K1, K3) must equal the
unfused composition bit for bit: the same bf16 tile, the same split plan.
The K1 and K3 decode GEMVs, the K1/K3 prefill tile (T > 8, split-K
partials summed in split order) and K4 merge their blocks' partials in a
fixed order, so two launches on the same inputs must give the same bits;
the GEMVs add their splits in the kernel, one CUDA launch a call. K4's batched form
plans each row's chunks from that row alone: a row's bits do not depend on
its neighbours or on the host's grid bound, and the solo form is its
one-row launch, bit for bit. The verify form of the rope + cache write
(B sequences of T rows) is the same kernel's [B, T] grid, bit-equal to its
plain version; solo flash decode at the verify step's T never reads a
cache slot past pos + T (where rejected drafts leave garbage). The decode
step captured in a CUDA graph (``runtime.graphs.StepGraph``) replays the
eager step's bits: logits, cache, greedy and sampled tokens, solo and
batched; its replays make no host sync and count the launches they
captured; one greedy and one sampled graph serve a session's every mix of
admitted rows; the ``logits`` fault seam's flags are read on every replay,
so a graph captured clean poisons exactly the flagged row.
"""

import gc

import numpy as np
import pytest
import torch

from dllama_tpu_torch import kernels, qkernel_experiments
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops import flash_decode, fused_rope_cache, qmatmul
from dllama_tpu_torch.ops.norms import rmsnorm
from dllama_tpu_torch.ops.rope import HALF, INTERLEAVED, rope_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _q40(rng, K, O, dev):
    w = rng.standard_normal((K, O)).astype(np.float32) * 0.05
    return qmatmul.quantize_tensor(w, "q40", dev)


@pytest.mark.parametrize("nosub", [True, False])
@pytest.mark.parametrize("T,K,O", [(1, 4096, 4096), (3, 192, 100), (17, 1024, 1536),
                                   (8, 640, 516)])
def test_q40_matmul_kernel_matches_ref(cuda, nosub, T, K, O):
    rng = np.random.default_rng(T * 1000 + K + O)
    qt = _q40(rng, K, O, cuda)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    before = kernels.launches["q40_matmul"]
    got = qmatmul.q40_matmul(x, qt.w, qt.s, qt.s2, nosub=nosub)
    torch.cuda.synchronize()
    assert kernels.launches["q40_matmul"] == before + 1
    ref = qmatmul.q40_matmul_ref(x, qt.w, qt.s, qt.s2, nosub=nosub)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def _close(got, ref):
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("T,K,O", [(1, 4096, 6144), (1, 14336, 4096), (128, 4096, 1024),
                                   (3, 256, 102), (9, 1024, 516)])
def test_q80_matmul_kernel_matches_ref(cuda, T, K, O):
    rng = np.random.default_rng(T + K + O)
    qt = qmatmul.quantize_tensor(rng.standard_normal((K, O)).astype(np.float32) * 0.05, "q80",
                                 cuda)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    before = kernels.launches["q80_matmul"]
    got = qmatmul.q80_matmul(x, qt.w, qt.s)
    torch.cuda.synchronize()
    assert kernels.launches["q80_matmul"] == before + 1
    _close(got, qmatmul.q80_matmul_ref(x, qt.w, qt.s))


@pytest.mark.parametrize("kind,nosub", [("q40", True), ("q40", False), ("q80", None)])
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,K,O", [(1, 4096, 6144), (5, 192, 40), (20, 1024, 1536)])
def test_fused_norm_epilogue_matches_ref_and_unfused_bits(cuda, kind, nosub, act, T, K, O):
    rng = np.random.default_rng(T + K + O + (nosub is True))
    qt = qmatmul.quantize_tensor(rng.standard_normal((K, O)).astype(np.float32) * 0.05, kind,
                                 cuda)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda, act)
    nw = torch.from_numpy(rng.standard_normal(K).astype(np.float32)).to(cuda)
    inv = qmatmul.rmsnorm_inv(x)
    if kind == "q40":
        got = qmatmul.q40_matmul(x, qt.w, qt.s, qt.s2, nosub=nosub, norm_w=nw, norm_inv=inv)
        ref = qmatmul.q40_matmul_ref(x, qt.w, qt.s, qt.s2, nosub=nosub, norm_w=nw, norm_inv=inv)
        unfused = qmatmul.q40_matmul(rmsnorm(x, nw), qt.w, qt.s, qt.s2, nosub=nosub)
    else:
        got = qmatmul.q80_matmul(x, qt.w, qt.s, norm_w=nw, norm_inv=inv)
        ref = qmatmul.q80_matmul_ref(x, qt.w, qt.s, norm_w=nw, norm_inv=inv)
        unfused = qmatmul.q80_matmul(rmsnorm(x, nw), qt.w, qt.s)
    torch.cuda.synchronize()
    _close(got, ref)
    assert torch.equal(got, unfused)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("T,K,O", [(1, 4096, 11008), (2, 512, 256), (7, 14336, 4096)])
def test_q40_nosub_kernel_matches_ref(cuda, wide, T, K, O):
    rng = np.random.default_rng(T + K + O)
    qt = qmatmul.quantize_tensor(rng.standard_normal((K, O)).astype(np.float32) * 0.1, "q40",
                                 cuda)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    got = qkernel_experiments.q40_nosub_matmul(x, qt.w, qt.s, qt.s2, wide=wide)
    torch.cuda.synchronize()
    _close(got, qkernel_experiments.q40_nosub_matmul_ref(x, qt.w, qt.s, qt.s2))


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 9, 12])
@pytest.mark.parametrize("K,O", [(4096, 11008), (512, 256), (14336, 4100), (1024, 100)])
def test_q40_int8_kernel_matches_ref(cuda, T, K, O):
    """Within 1e-5 of the output's magnitude (exact block dots, f32 sums in
    another order), and the same bits on a second call (splits added in
    split order); O 4100 and 100 take the unvectorized loads."""
    rng = np.random.default_rng(T + K + O)
    qt = qmatmul.quantize_tensor(rng.standard_normal((K, O)).astype(np.float32) * 0.1, "q40",
                                 cuda)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    xq, sx = qkernel_experiments.quantize_q80_rows(x, qt.k_padded)
    got = qkernel_experiments.q40_int8_matmul(xq, sx, qt.w, qt.s, qt.s2)
    again = qkernel_experiments.q40_int8_matmul(xq, sx, qt.w, qt.s, qt.s2)
    torch.cuda.synchronize()
    _close(got, qkernel_experiments.q40_int8_matmul_ref(xq, sx, qt.w, qt.s, qt.s2))
    assert torch.equal(got, again)


@pytest.mark.parametrize("T", [1, 12])
def test_q40_int8_kernel_call_is_one_cuda_launch(cuda, T):
    """K7 splits K at the shootout's width and adds the splits in the
    kernel: one ``q40_int8_kernel`` a call, no ``sum_splits_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    K, O = 4096, 11008
    assert qkernel_experiments.int8_plan(T, K, O, kernels.sm_count(cuda),
                                         qkernel_experiments.int8_blocks_per_sm(T))[1] > 1
    qt = _q40(np.random.default_rng(T), K, O, cuda)
    xq, sx = qkernel_experiments.quantize_q80_rows(torch.randn((T, K), device=cuda), K)
    qkernel_experiments.q40_int8_matmul(xq, sx, qt.w, qt.s, qt.s2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        qkernel_experiments.q40_int8_matmul(xq, sx, qt.w, qt.s, qt.s2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert sum("q40_int8_kernel" in n for n in names) == 1, names
    assert not any("sum_splits" in n for n in names), names


def test_every_variant_passes_its_check_on_the_card(cuda):
    rows = qkernel_experiments.main(["all", "512", "256"], device=cuda)
    assert [r["variant"] for r in rows] == ["S-sub", "S-nosub", *qkernel_experiments.VARIANTS]
    assert all(r["ms"] > 0 for r in rows)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("T,pos,S,hd", [(1, 0, 64, 64), (1, 300, 333, 128), (4, 254, 512, 128),
                                        (16, 40, 100, 32)])
def test_flash_decode_kernel_matches_ref(cuda, cache_dtype, T, pos, S, hd):
    rng = np.random.default_rng(pos + S + hd)
    L, kv, group = 2, 3, 4
    q = torch.from_numpy(rng.standard_normal((T, kv * group, hd)).astype(np.float32)).to(cuda)
    kc = torch.from_numpy(rng.standard_normal((L, S, kv, hd)).astype(np.float32)).to(cuda)
    vc = torch.from_numpy(rng.standard_normal((L, S, kv, hd)).astype(np.float32)).to(cuda)
    kc, vc = kc.to(cache_dtype), vc.to(cache_dtype)
    got = flash_decode.flash_decode_attention(q, kc, vc, pos, 1)
    torch.cuda.synchronize()
    ref = flash_decode.flash_decode_attention_ref(q, kc, vc, pos, 1)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def _rope_step(cuda, form, style, act, cache_dtype, rows, pos, hd=64, S=32, seed=0):
    """The form's wrapper on the card, twice, and its plain version, on q, k
    and v sliced from one fused qkv projection [rows, (H + 2 kv) hd] as the
    decode step hands them over; asserts q rotated and both caches bit-equal,
    the second launch's bits equal to the first's, one launch counted each.
    ``rows``: the leading dims, (T,) solo, (B,) batched, (B, T) verify."""
    L, H, kv = 2, 4, 2
    rng = np.random.default_rng(seed)
    n = int(np.prod(rows))
    qkv = torch.from_numpy(rng.standard_normal((n, (H + 2 * kv) * hd)).astype(np.float32) * 4)
    qkv = qkv.to(cuda, act)
    q, k, v = (t.reshape(*rows, -1, hd) for t in (qkv[:, :H * hd], qkv[:, H * hd:(H + kv) * hd],
                                                  qkv[:, (H + kv) * hd:]))
    cos, sin = (torch.from_numpy(t).to(cuda) for t in rope_table(S, hd, 10000.0))
    shape = (L, S, kv, hd) if form == "solo" else (L, rows[0], S, kv, hd)
    base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    kc, vc = base.to(cache_dtype), (base + 1).to(cache_dtype)
    kr, vr, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    name = {"solo": "rope_cache_update", "batched": "rope_cache_update_batched",
            "verify": "rope_cache_update_verify"}[form]
    fn, ref = getattr(fused_rope_cache, name), getattr(fused_rope_cache, name + "_ref")
    if form != "solo":
        pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kernels.launches[name]
    got = fn(q, k, v, cos, sin, kc, vc, pos, 1, style)
    again = fn(q, k, v, cos, sin, k2, v2, pos, 1, style)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    want = ref(q, k, v, cos, sin, kr, vr, pos, 1, style)
    assert got.is_contiguous() and got.shape == q.shape and got.dtype == act
    for a, b in ((got, want), (kc, kr), (vc, vr), (got, again), (kc, k2), (vc, v2)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("T,pos", [(1, 7), (3, 30)])  # pos 30 of S 32: start clamps to 29
def test_rope_cache_kernel_bit_equal_to_ref(cuda, style, act, cache_dtype, T, pos):
    _rope_step(cuda, "solo", style, act, cache_dtype, (T,), pos, seed=T + pos)


@pytest.mark.parametrize("form,rows,pos", [("solo", (2,), 5), ("batched", (3,), [0, 9, 40]),
                                           ("verify", (2, 9), [3, 30])])
@pytest.mark.parametrize("hd", [24, 128])
def test_rope_cache_kernel_unvectorized_and_wide_heads(cuda, form, rows, pos, hd):
    """hd 24 takes the kernel's scalar loads (runs not 16-byte aligned), hd
    128 the Llama widths; f8 cache, both styles."""
    for style in (INTERLEAVED, HALF):
        _rope_step(cuda, form, style, torch.bfloat16, torch.float8_e4m3fn, rows, pos, hd=hd,
                   seed=hd)


#: Llama-3-8B projection widths (K, O)
LLAMA3_8B_WIDTHS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]


def _q80_planes(K, O, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen),
            torch.rand((K // 32, O), device=dev, generator=gen) * 0.0003)


@pytest.mark.parametrize("K,O", LLAMA3_8B_WIDTHS)
def test_q80_gemv_matches_ref_and_repeats_its_bits(cuda, K, O):
    w, s = _q80_planes(K, O, cuda, K + O)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for T in range(1, qmatmul.GEMV_MAX_T + 1):
        per_sm = qmatmul.gemv_blocks_per_sm(T, False)
        assert per_sm >= 1
        assert qmatmul.q80_plan(T, K, O, kernels.sm_count(cuda), per_sm)[0] == "gemv"
        x = torch.randn((T, K), device=cuda, generator=gen).to(torch.bfloat16)
        got = qmatmul.q80_matmul(x, w, s)
        again = qmatmul.q80_matmul(x, w, s)
        torch.cuda.synchronize()
        _close(got, qmatmul.q80_matmul_ref(x, w, s))
        assert torch.equal(got, again), T


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("K,O", [(256, 102), (1024, 516), (4096, 4100), (512, 8)])
def test_q80_gemv_ragged_columns(cuda, T, K, O):
    w, s = _q80_planes(K, O, cuda, K * O)
    x = torch.randn((T, K), device=cuda, generator=torch.Generator(device=cuda).manual_seed(T))
    got = qmatmul.q80_matmul(x, w, s)
    torch.cuda.synchronize()
    _close(got, qmatmul.q80_matmul_ref(x, w, s))


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,O", [(4096, 6144), (4096, 28672), (1024, 516)])
def test_q80_gemv_fused_norm_bit_equal_to_unfused(cuda, act, K, O):
    w, s = _q80_planes(K, O, cuda, K + 7 * O)
    gen = torch.Generator(device=cuda).manual_seed(2)
    nw = 1.0 + 0.1 * torch.randn(K, device=cuda, generator=gen)
    for T in range(1, qmatmul.GEMV_MAX_T + 1):
        x = torch.randn((T, K), device=cuda, generator=gen).to(act)
        inv = qmatmul.rmsnorm_inv(x)
        fused = qmatmul.q80_matmul(x, w, s, norm_w=nw, norm_inv=inv)
        unfused = qmatmul.q80_matmul(rmsnorm(x, nw), w, s)
        torch.cuda.synchronize()
        _close(fused, qmatmul.q80_matmul_ref(x, w, s, norm_w=nw, norm_inv=inv))
        assert torch.equal(fused, unfused), T


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("group,hd", [(4, 128), (8, 64), (8, 256), (4, 256)])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_flash_decode_split_kernel_matches_ref_and_repeats_its_bits(cuda, cache_dtype, group,
                                                                     hd, T):
    L, S, kv = 2, 1024, 8
    gen = torch.Generator(device=cuda).manual_seed(group * hd + T)
    kc = torch.randn((L, S, kv, hd), device=cuda, generator=gen).to(cache_dtype)
    vc = torch.randn((L, S, kv, hd), device=cuda, generator=gen).to(cache_dtype)
    n_sm = kernels.sm_count(cuda)
    # split edges: live = pos + T on, just past and just short of a chunk edge
    for pos in (0, 31 - T + 1, 32 - T + 1, 116, 1000, S - T):
        pos = max(pos, 0)
        q = torch.randn((T, kv * group, hd), device=cuda, generator=gen)
        got = flash_decode.flash_decode_attention(q, kc, vc, pos, 1)
        again = flash_decode.flash_decode_attention(q, kc, vc, pos, 1)
        torch.cuda.synchronize()
        ref = flash_decode.flash_decode_attention_ref(q, kc, vc, pos, 1)
        split = flash_decode.flash_decode_split_ref(
            q, kc, vc, pos, 1, flash_decode.split_plan(min(pos + T, S), kv, n_sm)[0])
        tol = 1e-5 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol, pos
        assert (got - split).abs().max().item() <= tol, pos
        assert torch.equal(got, again), pos


def _q40_planes(K, O, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen),
            torch.rand((K // 64, O), device=dev, generator=gen) * 0.004,
            torch.rand((K // 64, O), device=dev, generator=gen) * 0.004)


@pytest.mark.parametrize("nosub", [True, False])
@pytest.mark.parametrize("K,O", LLAMA3_8B_WIDTHS)
def test_q40_gemv_matches_ref_and_repeats_its_bits(cuda, nosub, K, O):
    planes = _q40_planes(K, O, cuda, K + O + nosub)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for T in range(1, qmatmul.GEMV_MAX_T + 1):
        per_sm = qmatmul.q40_gemv_blocks_per_sm(T)
        assert per_sm >= 1
        assert qmatmul.q40_plan(T, K, O, kernels.sm_count(cuda), per_sm)[0] == "gemv"
        x = torch.randn((T, K), device=cuda, generator=gen).to(torch.bfloat16)
        before = kernels.launches["q40_matmul"]
        got = qmatmul.q40_matmul(x, *planes, nosub=nosub)
        again = qmatmul.q40_matmul(x, *planes, nosub=nosub)
        torch.cuda.synchronize()
        assert kernels.launches["q40_matmul"] == before + 2
        _close(got, qmatmul.q40_matmul_ref(x, *planes, nosub=nosub))
        assert torch.equal(got, again), T


@pytest.mark.parametrize("nosub", [True, False])
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("K,O", [(256, 102), (1024, 516), (4096, 4100), (512, 8)])
def test_q40_gemv_ragged_columns(cuda, nosub, T, K, O):
    planes = _q40_planes(K, O, cuda, K * O + nosub)
    x = torch.randn((T, K), device=cuda, generator=torch.Generator(device=cuda).manual_seed(T))
    got = qmatmul.q40_matmul(x, *planes, nosub=nosub)
    torch.cuda.synchronize()
    _close(got, qmatmul.q40_matmul_ref(x, *planes, nosub=nosub))


@pytest.mark.parametrize("nosub", [True, False])
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,O", [(4096, 6144), (4096, 28672), (1024, 516)])
def test_q40_gemv_fused_norm_bit_equal_to_unfused(cuda, nosub, act, K, O):
    planes = _q40_planes(K, O, cuda, K + 7 * O + nosub)
    gen = torch.Generator(device=cuda).manual_seed(2)
    nw = 1.0 + 0.1 * torch.randn(K, device=cuda, generator=gen)
    for T in range(1, qmatmul.GEMV_MAX_T + 1):
        x = torch.randn((T, K), device=cuda, generator=gen).to(act)
        inv = qmatmul.rmsnorm_inv(x)
        fused = qmatmul.q40_matmul(x, *planes, nosub=nosub, norm_w=nw, norm_inv=inv)
        unfused = qmatmul.q40_matmul(rmsnorm(x, nw), *planes, nosub=nosub)
        torch.cuda.synchronize()
        _close(fused, qmatmul.q40_matmul_ref(x, *planes, nosub=nosub, norm_w=nw, norm_inv=inv))
        assert torch.equal(fused, unfused), T


@pytest.mark.parametrize("T", [1, 8])
def test_q40_gemv_call_is_one_cuda_launch(cuda, T):
    """wo splits K across blocks at every T: the last block of each column
    tile adds the splits, so K1 and K6 are one launch a call and no
    ``sum_splits_kernel`` follows."""
    from torch.profiler import ProfilerActivity, profile

    K, O = 4096, 4096
    planes = _q40_planes(K, O, cuda, T)
    assert qmatmul.q40_plan(T, K, O, kernels.sm_count(cuda),
                            qmatmul.q40_gemv_blocks_per_sm(T))[1] > 1
    x = torch.randn((T, K), device=cuda).to(torch.bfloat16)
    qmatmul.q40_matmul(x, *planes)
    qkernel_experiments.q40_nosub_matmul(x, *planes, wide=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        qmatmul.q40_matmul(x, *planes)
        qkernel_experiments.q40_nosub_matmul(x, *planes, wide=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert sum("q40_gemv_kernel" in n for n in names) == 2, names
    assert not any("sum_splits" in n for n in names), names


def _tile_call(kind, nosub, x, planes, **kw):
    if kind == "q40":
        return qmatmul.q40_matmul(x, *planes, nosub=nosub, **kw)
    return qmatmul.q80_matmul(x, *planes, **kw)


def _tile_ref(kind, nosub, x, planes, **kw):
    if kind == "q40":
        return qmatmul.q40_matmul_ref(x, *planes, nosub=nosub, **kw)
    return qmatmul.q80_matmul_ref(x, *planes, **kw)


TILE_KINDS = [("q40", True), ("q40", False), ("q80", None)]


@pytest.mark.parametrize("kind,nosub", TILE_KINDS)
@pytest.mark.parametrize("T,K,O", [(9, 512, 136), (16, 1024, 100), (20, 4096, 4100),
                                   (100, 14336, 1024), (128, 4096, 516), (128, 14336, 4096),
                                   (200, 640, 384), (200, 1024, 40)])
def test_tile_matches_ref_and_repeats_its_bits(cuda, kind, nosub, T, K, O):
    planes = (_q40_planes if kind == "q40" else _q80_planes)(K, O, cuda, T + K + O)
    n_sm = kernels.sm_count(cuda)
    route = (qmatmul.q40_plan(T, K, O, n_sm, 0) if kind == "q40"
             else qmatmul.q80_plan(T, K, O, n_sm, 0))[0]
    assert route == "tile"
    x = torch.randn((T, K), device=cuda, generator=torch.Generator(device=cuda).manual_seed(T))
    x = x.to(torch.bfloat16)
    name = f"{kind}_matmul"
    before = kernels.launches[name]
    got = _tile_call(kind, nosub, x, planes)
    again = _tile_call(kind, nosub, x, planes)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    _close(got, _tile_ref(kind, nosub, x, planes))
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind,nosub", TILE_KINDS)
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,K,O", [(9, 1024, 516), (128, 4096, 6144), (200, 4096, 136)])
def test_tile_fused_norm_matches_ref_and_unfused_bits(cuda, kind, nosub, act, T, K, O):
    planes = (_q40_planes if kind == "q40" else _q80_planes)(K, O, cuda, K + 3 * O)
    gen = torch.Generator(device=cuda).manual_seed(T)
    nw = 1.0 + 0.1 * torch.randn(K, device=cuda, generator=gen)
    x = torch.randn((T, K), device=cuda, generator=gen).to(act)
    inv = qmatmul.rmsnorm_inv(x)
    fused = _tile_call(kind, nosub, x, planes, norm_w=nw, norm_inv=inv)
    unfused = _tile_call(kind, nosub, rmsnorm(x, nw), planes)
    torch.cuda.synchronize()
    _close(fused, _tile_ref(kind, nosub, x, planes, norm_w=nw, norm_inv=inv))
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("T,K,O", [(20, 4096, 11008), (128, 512, 100), (128, 4096, 11008)])
def test_q40_nosub_kernel_takes_the_tile_past_the_decode_rows(cuda, T, K, O):
    planes = _q40_planes(K, O, cuda, T + O)
    x = torch.randn((T, K), device=cuda, generator=torch.Generator(device=cuda).manual_seed(T))
    got = qkernel_experiments.q40_nosub_matmul(x, *planes)
    wide = qkernel_experiments.q40_nosub_matmul(x, *planes, wide=True)  # the same tile
    torch.cuda.synchronize()
    _close(got, qkernel_experiments.q40_nosub_matmul_ref(x, *planes))
    assert torch.equal(wide, got)


def _batch_caches(L, B, S, kv, hd, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((L, B, S, kv, hd), device=dev, generator=gen).to(dtype),
            torch.randn((L, B, S, kv, hd), device=dev, generator=gen).to(dtype), gen)


#: mixed row positions of S = 1024: first slot, short, long, last slot
BATCH_POS = [0, 116, 1000, 1023, 31, 32, 500, 7]


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("group,hd", [(4, 128), (8, 64)])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_flash_decode_batched_kernel_matches_ref_and_repeats_its_bits(cuda, cache_dtype, group,
                                                                       hd, B):
    L, S, kv = 2, 1024, 8
    kc, vc, gen = _batch_caches(L, B, S, kv, hd, cache_dtype, cuda, B * hd + group)
    pos = torch.tensor(BATCH_POS[:B] if B > 1 else [1000], dtype=torch.int32, device=cuda)
    q = torch.randn((B, kv * group, hd), device=cuda, generator=gen)
    before = kernels.launches["flash_decode_batched"]
    got = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 1)
    again = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 1)
    # the host bound only trims the grid: a row's bits stay
    tight = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 1,
                                                        int(pos.max()) + 1)
    torch.cuda.synchronize()
    assert kernels.launches["flash_decode_batched"] == before + 3
    ref = flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, 1)
    split = flash_decode.flash_decode_split_batched_ref(
        q, kc, vc, pos, 1, flash_decode.max_splits(B * kv, kernels.sm_count(cuda)))
    tol = 1e-5 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    assert (got - split).abs().max().item() <= tol
    assert torch.equal(got, again) and torch.equal(got, tight)


@pytest.mark.parametrize("bound", [1, 100, 500])
def test_flash_decode_batched_too_small_bound_still_reads_every_prefix(cuda, bound):
    """A host bound below some rows' pos + 1 gives a grid with fewer chunks
    than those rows plan: each such row is cut into the grid's chunks, and
    still attends over its whole prefix."""
    L, S, kv, group, hd, B = 2, 1024, 8, 4, 128, 8
    kc, vc, gen = _batch_caches(L, B, S, kv, hd, torch.bfloat16, cuda, bound)
    pos = torch.tensor(BATCH_POS, dtype=torch.int32, device=cuda)
    q = torch.randn((B, kv * group, hd), device=cuda, generator=gen)
    got = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 1, bound)
    torch.cuda.synchronize()
    ref = flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, 1)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("pos", [0, 116, 1000, 1023])
def test_flash_decode_solo_is_the_batched_kernel_at_one_row(cuda, cache_dtype, pos):
    L, S, kv, group, hd = 2, 1024, 8, 4, 128
    kc, vc, gen = _batch_caches(L, 1, S, kv, hd, cache_dtype, cuda, pos)
    q = torch.randn((1, kv * group, hd), device=cuda, generator=gen).to(torch.bfloat16)
    solo = flash_decode.flash_decode_attention(q, kc[:, 0], vc[:, 0], pos, 1)
    batched = flash_decode.flash_decode_attention_batched(
        q, kc, vc, torch.tensor([pos], dtype=torch.int32, device=cuda), 1)
    torch.cuda.synchronize()
    assert torch.equal(solo, batched)


def test_flash_decode_batched_rows_ignore_other_rows_and_nan_past_prefix(cuda):
    """NaN beyond each row's own prefix never leaks in; a row's bits do not
    depend on its neighbours' queries, caches or positions."""
    L, B, S, kv, group, hd = 1, 4, 1024, 8, 4, 128
    kc, vc, gen = _batch_caches(L, B, S, kv, hd, torch.bfloat16, cuda, 8)
    pos = torch.tensor([10, 400, 1023, 300], dtype=torch.int32, device=cuda)
    q = torch.randn((B, kv * group, hd), device=cuda, generator=gen)
    want = flash_decode.flash_decode_attention_batched_ref(q, kc, vc, pos, 0)
    clean = flash_decode.flash_decode_attention_batched(q, kc, vc, pos, 0)
    kn, vn = kc.clone(), vc.clone()
    for b, p in enumerate(pos.tolist()):
        kn[:, b, p + 1:] = float("nan")
        vn[:, b, p + 1:] = float("nan")
    got = flash_decode.flash_decode_attention_batched(q, kn, vn, pos, 0)
    # other rows: new queries, caches and positions; row 0 as it was
    q2 = torch.randn((B, kv * group, hd), device=cuda, generator=gen)
    q2[0] = q[0]
    k2, v2 = torch.randn_like(kc.float()).bfloat16(), torch.randn_like(vc.float()).bfloat16()
    k2[:, 0], v2[:, 0] = kc[:, 0], vc[:, 0]
    pos2 = torch.tensor([10, 1023, 5, 700], dtype=torch.int32, device=cuda)
    other = flash_decode.flash_decode_attention_batched(q2, k2, v2, pos2, 0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(other[0], got[0])


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_rope_cache_batched_kernel_bit_equal_to_ref(cuda, style, act, cache_dtype):
    S = 32
    _rope_step(cuda, "batched", style, act, cache_dtype, (5,), [0, 7, S - 1, S + 3, 20], S=S,
               seed=5)  # S + 3 clamps to S - 1, its angle to row S - 1


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("T", [9, 16])
def test_rope_cache_verify_kernel_bit_equal_to_ref(cuda, style, act, cache_dtype, T):
    # first slot, middle, S - T, past S - T and past S (both write at S - T;
    # their angles run on to min(pos + t, S - 1))
    S = 48
    _rope_step(cuda, "verify", style, act, cache_dtype, (5, T),
               [0, 20, S - T, S - T + 3, S + 2], S=S, seed=T)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_flash_decode_solo_verify_rows_ignore_nan_past_their_window(cuda, cache_dtype):
    """A solo verify step writes T rows at pos and attends up to pos + T - 1:
    NaN in every slot from pos + T on leaves its output's bits as they are."""
    L, S, kv, group, hd, T, pos = 2, 512, 8, 4, 128, 9, 300
    gen = torch.Generator(device=cuda).manual_seed(5)
    kc = torch.randn((L, S, kv, hd), device=cuda, generator=gen).to(cache_dtype)
    vc = torch.randn((L, S, kv, hd), device=cuda, generator=gen).to(cache_dtype)
    q = torch.randn((T, kv * group, hd), device=cuda, generator=gen)
    clean = flash_decode.flash_decode_attention(q, kc, vc, pos, 1)
    kn, vn = kc.clone(), vc.clone()
    kn[:, pos + T:] = float("nan")
    vn[:, pos + T:] = float("nan")
    got = flash_decode.flash_decode_attention(q, kn, vn, pos, 1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)


def test_batched_wrappers_want_device_int32_positions(cuda):
    kc = torch.zeros((1, 2, 64, 1, 64), device=cuda)
    q = torch.zeros((2, 4, 64), device=cuda)
    k = torch.zeros((2, 1, 64), device=cuda)
    tab = torch.zeros((64, 32), device=cuda)
    for bad in ([0, 1], torch.tensor([0, 1], device=cuda),  # a list; int64
                torch.tensor([0, 1], dtype=torch.int32),  # on the host
                torch.tensor([0], dtype=torch.int32, device=cuda)):  # one row short
        with pytest.raises(ValueError):
            flash_decode.flash_decode_attention_batched(q, kc, kc, bad, 0)
        with pytest.raises(ValueError):
            fused_rope_cache.rope_cache_update_batched(q, k, k, tab, tab, kc, kc, bad, 0)
        with pytest.raises(ValueError):
            fused_rope_cache.rope_cache_update_verify(q[:, None], k[:, None], k[:, None], tab,
                                                      tab, kc, kc, bad, 0)


def test_wrappers_raise_on_unsupported_cuda_input(cuda):
    q = torch.zeros((17, 4, 64), device=cuda)
    kc = torch.zeros((1, 64, 1, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_decode.flash_decode_attention(q, kc, kc, 0, 0)  # T > 16: no plain fallback
    with pytest.raises(ValueError):  # pos past the cache
        flash_decode.flash_decode_attention(q[:1], kc, kc, 64, 0)
    with pytest.raises(ValueError):  # hd > 256
        big = torch.zeros((1, 64, 1, 272), device=cuda)
        flash_decode.flash_decode_attention(torch.zeros((1, 4, 272), device=cuda), big, big, 0, 0)
    with pytest.raises(TypeError):  # K and V caches of different dtypes
        flash_decode.flash_decode_attention(q[:1], kc, kc.bfloat16(), 0, 0)
    w, s = _q80_planes(256, 64, cuda, 0)
    with pytest.raises(ValueError):  # no activation rows
        qmatmul.q80_matmul(torch.zeros((0, 256), device=cuda), w, s)
    with pytest.raises(ValueError):  # scales that do not match the quants
        qmatmul.q80_matmul(torch.zeros((1, 256), device=cuda), w, s[:4])
    with pytest.raises(ValueError):  # the fused norm's operands come together
        qmatmul.q80_matmul(torch.zeros((1, 256), device=cuda), w, s,
                           norm_w=torch.ones(256, device=cuda))
    c12, t6 = torch.zeros((1, 64, 1, 12), device=cuda), torch.zeros((64, 6), device=cuda)
    with pytest.raises(ValueError):  # rope: a head size that is not a multiple of 8
        fused_rope_cache.rope_cache_update(torch.zeros((1, 2, 12), device=cuda), c12[0, :1],
                                           c12[0, :1], t6, t6, c12, c12, 0, 0)
    t32 = torch.zeros((64, 32), device=cuda)
    with pytest.raises(ValueError):  # rope: q's heads not adjacent within a row
        fused_rope_cache.rope_cache_update(torch.zeros((4, 3, 64), device=cuda).transpose(0, 1),
                                           kc[0, :3], kc[0, :3], t32, t32, kc, kc, 0, 0)


def _graph_engines(dev, kind):
    """A small random ``kind`` model on the card: (graphed engine, eager
    engine) on the same parameters."""
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    cfg = ModelConfig(arch="llama", dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=4, vocab_size=512, seq_len=128, head_size=32, kv_dim=128,
                      dtype="bfloat16")
    params = llama.random_quant_params(cfg, dev, torch.Generator(device=dev).manual_seed(0), kind)
    greedy = SamplerConfig(temperature=0.0)
    graphed = Engine(cfg, params, greedy, cache_dtype=torch.bfloat16, device=dev, decode_chunk=8)
    eager = Engine(cfg, graphed.params, greedy, cache_dtype=torch.bfloat16, device=dev,
                   cuda_graphs=False)
    return cfg, graphed, eager


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_graphed_solo_step_replays_eager_bits(cuda, kind):
    cfg, graphed, eager = _graph_engines(cuda, kind)
    prompt = list(range(1, 20))
    cache = eager.new_cache()
    last, cache = eager.prefill(cache, prompt)
    nxt = torch.argmax(last).reshape(1)
    twin = {n: c.clone() for n, c in cache.items()}
    want, _ = llama.forward(cfg, eager.params, eager.rope, nxt, cache, len(prompt))
    g = graphed.step_graph(twin, False, 8)
    g.load(nxt, len(prompt))
    before = dict(kernels.launches)
    g.run(1)
    torch.cuda.synchronize()
    step = {f"{kind}_matmul": 4 * cfg.n_layers + 1, "flash_decode_batched": cfg.n_layers,
            "rope_cache_update_batched": cfg.n_layers}
    assert g.counts == step
    assert {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]} == step
    assert torch.equal(g.logits, want)
    S = cfg.seq_len  # slot S - 1 is the graph's warm-up step's
    for n in ("k", "v"):
        assert torch.equal(twin[n][:, :S - 1], cache[n][:, :S - 1])


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_graphed_decode_tokens_equal_eager(cuda, kind):
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    _, graphed, eager = _graph_engines(cuda, kind)
    prompt = list(range(3, 30))
    want = [t for t, _ in eager.generate(prompt, 20)]
    assert [t for t, _ in graphed.generate(prompt, 20)] == want
    assert graphed.generate_fused(prompt, 20)[0] == want  # chunks of 8, 8 and 3
    s = SamplerConfig(temperature=0.8, topp=0.9, seed=5)
    want = [t for t, _ in eager.generate(prompt, 20, sampler=s)]
    assert [t for t, _ in graphed.generate(prompt, 20, sampler=s)] == want
    assert graphed.generate_fused(prompt, 20, sampler=s)[0] == want
    prompts = [prompt, [7], list(range(40, 90)), [5, 6, 7]]
    for sampler in (None, s):
        want = eager.generate_batch(prompts, 20, sampler=sampler)
        assert graphed.generate_batch(prompts, 20, sampler=sampler) == want


def test_graphed_replays_make_no_host_sync(cuda):
    cfg, graphed, eager = _graph_engines(cuda, "q40")
    B = 4
    cache = llama.init_batch_cache(cfg, B, torch.bfloat16, cuda)
    temps, topps = [0.8, 0.0, 0.8, 0.0], [0.9, 1.0, 0.9, 1.0]
    gens = [torch.Generator(device=cuda).manual_seed(b) if t else None
            for b, t in enumerate(temps)]
    g = graphed.step_graph(cache, True, 8)
    tokens = torch.tensor([1, 2, 3, 4], device=cuda)
    pos = torch.tensor([0, 5, 9, 100], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.load(tokens, pos, temps, topps)
        toks, ok = g.run(8, gens)
        graphed._decode_chunk_batch(cache, toks[-1], g.pos, 8, temps, topps, gens, [8] * B)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launches["flash_decode_batched"] - before["flash_decode_batched"] == \
        16 * cfg.n_layers
    assert bool(ok.all()) and g.pos.tolist() == [16, 21, 25, 116]


def test_graphed_batch_session_mixed_traffic_equals_eager(cuda):
    """Sampled and greedy rows admitted and released between chunks: one
    greedy and one sampled graph serve every mix (no capture per
    admission), and every row's tokens equal the eager session's."""
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    _, graphed, eager = _graph_engines(cuda, "q40")
    got = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        sess = eng.batch_session(max_batch=4, chunk=4)
        log = []
        for i, (prompt, temp) in enumerate([([3, 4, 5], 0.0), ([9, 8], 0.8), ([7] * 6, 0.0),
                                            ([1, 2], 1.1), ([6, 5, 4, 3], 0.7)]):
            h = sess.admit(prompt, 10, SamplerConfig(temperature=temp, topp=0.9, seed=i))
            for r, toks in sess.step_chunk().items():
                log.append((i, r, toks))
            if i % 2:
                sess.release(sess.occupied[0])
        sess.close()
        got[name] = log
    assert got["graphed"] == got["eager"]
    assert graphed.graphs.made == 2


def test_graphed_step_poisons_only_the_flagged_row(cuda):
    """The ``logits`` seam's static flags: a batched graph captured clean,
    then replayed with row 2 flagged, gives non-finite logits in row 2 only
    (its ``ok`` flag drops, the others' logits are the clean replay's bits);
    clearing the flag makes the next replay clean again."""
    cfg, graphed, _ = _graph_engines(cuda, "q40")
    cache = llama.init_batch_cache(cfg, 4, torch.bfloat16, cuda)
    g = graphed.step_graph(cache, False, 8)  # captured with no row flagged
    tokens = torch.tensor([3, 5, 7, 9], device=cuda)
    pos = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    twin = {n: c.clone() for n, c in cache.items()}
    g.load(tokens, pos)
    g.run(1)
    clean = g.logits.clone()
    for n in cache:  # back to the state before the clean step
        cache[n].copy_(twin[n])
    g.load(tokens, pos, poison=(2,))
    _, ok = g.run(1)
    torch.cuda.synchronize()
    finite = torch.isfinite(g.logits).all(dim=-1).tolist()
    assert finite == [True, True, False, True] and ok.tolist() == finite
    assert torch.equal(g.logits[[0, 1, 3]], clean[[0, 1, 3]])
    g.load(tokens, pos)
    _, ok = g.run(1)
    assert bool(ok.all())


def test_graphed_solo_generate_fails_on_the_logits_seam(cuda):
    """A solo decode graph captured clean and replayed under
    ``logits:nan`` trips the watchdog; without the fault the same engine's
    next call decodes cleanly on the same graph."""
    from dllama_tpu_torch import faults
    from dllama_tpu_torch.runtime.generate import NumericHealthError

    _, graphed, _ = _graph_engines(cuda, "q40")
    want = [t for t, _ in graphed.generate([3, 4, 5], 6)]
    made = graphed.graphs.made
    faults.install("logits:nan:after=2,times=1")
    try:
        with pytest.raises(NumericHealthError):
            list(graphed.generate([3, 4, 5], 6))
    finally:
        faults.clear()
    gc.collect()  # the failed call's traceback held its Session: the resident cache is free
    assert [t for t, _ in graphed.generate([3, 4, 5], 6)] == want
    assert graphed.graphs.made == made


# ---------------------------------------------------------------------------
# The expert-indexed GEMVs (K1, K3) and a graphed mixture-of-experts step
# ---------------------------------------------------------------------------

def _stack_planes(kind, N, K, O, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "q40":
        return (torch.randint(0, 256, (N, K // 2, O), dtype=torch.uint8, device=dev,
                              generator=gen),
                torch.rand((N, K // 64, O), device=dev, generator=gen) * 0.004,
                torch.rand((N, K // 64, O), device=dev, generator=gen) * 0.004)
    return (torch.randint(-127, 128, (N, K, O), dtype=torch.int8, device=dev, generator=gen),
            torch.rand((N, K // 32, O), device=dev, generator=gen) * 0.0003)


def _indexed(kind, x, planes, ids, base, n_ids):
    if kind == "q40":
        return qmatmul.q40_matmul_stacked(x, *planes, ids, base, n_ids)
    return qmatmul.q80_matmul_stacked(x, *planes, ids, base, n_ids)


def _indexed_ref(kind, x, planes, ids, base, n_ids):
    if kind == "q40":
        return qmatmul.q40_matmul_stacked_ref(x, *planes, ids, base, n_ids)
    return qmatmul.q80_matmul_stacked_ref(x, *planes, ids, base, n_ids)


def _view(kind, x, planes, i):
    if kind == "q40":
        return qmatmul.q40_matmul(x, *(p[i] for p in planes))
    return qmatmul.q80_matmul(x, *(p[i] for p in planes))


@pytest.mark.parametrize("kind", ["q40", "q80"])
@pytest.mark.parametrize("T", [1, 2, 3, 8])
@pytest.mark.parametrize("K,O,shared", [(4096, 2048, True), (1024, 4096, False),
                                        (512, 100, True), (14336, 512, False)])
def test_indexed_gemv_matches_ref_and_the_view_launch(cuda, kind, T, K, O, shared):
    """Output j is the plain launch on the view ``w[base + ids[j]]`` bit for
    bit, within 1e-5 of the plain version's magnitude, and repeats its
    bits; one launch per call."""
    E, base = 4, 4  # layer 1 of two
    planes = _stack_planes(kind, 2 * E, K, O, cuda, K + O + T)
    gen = torch.Generator(device=cuda).manual_seed(T)
    ids = torch.tensor([2, 0, 3], dtype=torch.int32, device=cuda)
    shape = (T, K) if shared else (3, T, K - 64)
    x = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    before = kernels.launches[f"{kind}_matmul_stacked"]
    got = _indexed(kind, x, planes, ids, base, E)
    again = _indexed(kind, x, planes, ids, base, E)
    torch.cuda.synchronize()
    assert kernels.launches[f"{kind}_matmul_stacked"] == before + 2
    assert got.shape == (3, T, O) and torch.equal(got, again)
    _close(got, _indexed_ref(kind, x, planes, ids, base, E))
    for j, e in enumerate(ids.tolist()):
        assert torch.equal(got[j], _view(kind, x if shared else x[j], planes, base + e)), j


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_indexed_gemv_id_out_of_range_gives_nan(cuda, kind):
    planes = _stack_planes(kind, 4, 1024, 512, cuda, 3)
    x = torch.randn((2, 1024), device=cuda).to(torch.bfloat16)
    ids = torch.tensor([1, 4, -1, 3], dtype=torch.int32, device=cuda)
    got = _indexed(kind, x, planes, ids, 0, 4)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert torch.equal(got[0], _view(kind, x, planes, 1))
    assert torch.equal(got[3], _view(kind, x, planes, 3))
    with pytest.raises(ValueError):
        _indexed(kind, x, planes, ids.long(), 0, 4)  # ids must be int32
    with pytest.raises(ValueError):
        _indexed(kind, x, planes, ids, 2, 4)  # planes 2..5 of 4


@pytest.mark.parametrize("arch,kind", [("mixtral", "q40"), ("mixtral", "q80"),
                                       ("grok1", "q40")])
def test_graphed_moe_steps_replay_eager_bits(cuda, arch, kind):
    """A small Mixtral or Grok-1 on the card: the graphed solo step (the
    selected path through the indexed launches) gives eager ``forward``'s
    logits bit for bit with no host sync; graphed tokens equal eager ones,
    solo and batched at B = 2 (selected) and B = 4 (the dense combine)."""
    from dllama_tpu_torch.runtime.generate import Engine
    from dllama_tpu_torch.runtime.sampler import SamplerConfig

    cfg = ModelConfig(arch=arch, dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=4, vocab_size=512, seq_len=128, head_size=32, kv_dim=128,
                      n_experts=8, n_active_experts=2, dtype="bfloat16",
                      hidden_act="gelu" if arch == "grok1" else "silu")
    params = llama.random_quant_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0),
                                       kind)
    greedy = SamplerConfig(temperature=0.0)
    graphed = Engine(cfg, params, greedy, cache_dtype=torch.bfloat16, device=cuda,
                     decode_chunk=8)
    eager = Engine(cfg, graphed.params, greedy, cache_dtype=torch.bfloat16, device=cuda,
                   cuda_graphs=False)
    prompt = list(range(1, 20))
    cache = eager.new_cache()
    last, cache = eager.prefill(cache, prompt)
    nxt = torch.argmax(last).reshape(1)
    twin = {n: c.clone() for n, c in cache.items()}
    want, _ = llama.forward(cfg, eager.params, eager.rope, nxt, cache, len(prompt))
    g = graphed.step_graph(twin, False, 8)
    assert g.counts == {f"{kind}_matmul": 2 * cfg.n_layers + 1,
                        f"{kind}_matmul_stacked": 2 * cfg.n_layers,
                        "flash_decode_batched": cfg.n_layers,
                        "rope_cache_update_batched": cfg.n_layers}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.load(nxt, len(prompt))
        g.run(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(g.logits, want)
    want = [t for t, _ in eager.generate(prompt, 12)]
    assert [t for t, _ in graphed.generate(prompt, 12)] == want
    assert graphed.generate_fused(prompt, 12)[0] == want
    for rows in ([prompt, [7]], [prompt, [7], list(range(40, 60)), [5, 6]]):
        assert graphed.generate_batch(rows, 10) == eager.generate_batch(rows, 10)


def test_graphed_bucket_slab_pins_at_ctx_and_equals_eager(cuda):
    """A bucket slab [L, B, ctx, kv, hd] shorter than seq_len: its graph
    pins rows at ctx - 1 and bounds flash decode's grid by ctx, and its
    replays give the eager chunk's tokens and KV bit for bit (the KV below
    ctx - 1, the slot the warm-up step writes)."""
    cfg, graphed, eager = _graph_engines(cuda, "q40")
    ctx, B = 32, 4
    slab = graphed._bucket_cache_init(B, ctx)
    for n in ("k", "v"):
        slab[n].normal_(0.0, 0.5, generator=torch.Generator(device=cuda).manual_seed(1))
    twin = {n: c.clone() for n, c in slab.items()}
    tokens = torch.tensor([1, 2, 3, 4], device=cuda)
    pos = torch.tensor([3, 20, 26, 30], dtype=torch.int32, device=cuda)
    temps = [0.0] * B
    want, _, wpos = eager._decode_chunk_batch(twin, tokens, pos, 8, temps, [1.0] * B,
                                              [None] * B, pos.tolist())
    g = graphed.step_graph(slab, False, 8)
    assert g.seq_len == ctx
    got, _, gpos = graphed._decode_chunk_batch(slab, tokens, pos, 8, temps, [1.0] * B,
                                               [None] * B, pos.tolist())
    assert torch.equal(got, want) and gpos.tolist() == wpos.tolist() == [11, 28, 31, 31]
    for n in ("k", "v"):
        assert torch.equal(slab[n][:, :, :ctx - 1], twin[n][:, :, :ctx - 1])


def _paged_arena(graphed, cuda, pages=9, page=8):
    arena = graphed._bucket_cache_init(pages, page)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for n in ("k", "v"):
        arena[n].normal_(0.0, 0.5, generator=gen)
    return arena


def test_paged_graph_capture_touches_only_the_scratch_page(cuda):
    """A paged graph is warmed up and captured with an all-scratch table:
    making it writes page 0 and leaves every other page's bits alone."""
    _, graphed, _ = _graph_engines(cuda, "q40")
    arena = _paged_arena(graphed, cuda)
    before = {n: c.clone() for n, c in arena.items()}
    g = graphed.paged_graph(arena, 2, 4, True, 8)
    torch.cuda.synchronize()
    assert g.graph is not None
    for n in ("k", "v"):
        assert torch.equal(arena[n][:, 1:], before[n][:, 1:])


def test_paged_graph_reads_the_table_load_gives(cuda):
    """A paged graph replayed after ``load`` changes its table reads the new
    table: each run equals the eager paged chunk over that table, bit for
    bit, tokens and pages."""
    _, graphed, eager = _graph_engines(cuda, "q40")
    arena = _paged_arena(graphed, cuda)
    twin = {n: c.clone() for n, c in arena.items()}
    pos = [13, 27]
    for table in ([[1, 2, 3, 4], [5, 6, 7, 8]], [[8, 7, 6, 5], [4, 3, 2, 1]]):
        table = torch.tensor(table, dtype=torch.int32)
        tokens = torch.tensor([5, 9], device=cuda)
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        want, _, _ = eager._decode_chunk_batch(twin, tokens, p, 4, [0.0, 0.0], [1.0, 1.0],
                                               [None, None], pos, table=table)
        got, _, _ = graphed._decode_chunk_batch(arena, tokens, p, 4, [0.0, 0.0], [1.0, 1.0],
                                                [None, None], pos, table=table)
        assert torch.equal(got, want)
        for n in ("k", "v"):
            assert torch.equal(arena[n][:, 1:], twin[n][:, 1:])
    assert graphed.graphs.made == 1
