"""The port's Q80 matmul and fused-norm epilogue against the JAX package's
(CPU; the JAX side runs its Pallas kernels in interpret mode).

* ``q80_matmul_ref`` rounds both dot operands to bf16 exactly as the TPU
  kernel does and sums the exact products in f32, so it differs from the
  JAX kernel only in summation order: max abs err <= 1e-5 * max|ref|.
* Packing is pure data movement: the planes must be equal.
* The fused-norm epilogue: both sides normalize the raw activation with
  their own ``rmsnorm_inv`` (XLA's and ATen's f32 means may differ in the
  last ulp, which could flip the bf16 rounding of a normalized element; on
  these inputs it moved no output past 3e-7 * max|ref|), so the kernels'
  f32 outputs are held to 1e-5 * max|ref|, and ``qmatmul_norm``'s output in
  the activation dtype to one bf16 ulp of max|ref| (2^-8).
* Inside the port, fused equals unfused bit for bit (the same f32 products
  in the same order, one bf16 rounding), for bf16 and f32 activations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import qmatmul as jq
from dllama_tpu.quants import blocks as j_blocks
from dllama_tpu_torch.ops import qmatmul as tq
from dllama_tpu_torch.ops.norms import rmsnorm
from dllama_tpu_torch.quants import blocks as t_blocks


def _port_qt(qt_j, kind, K):
    return tq.QuantTensor(*(np.asarray(getattr(qt_j, n)) for n in ("w", "s", "s2")),
                          kind=kind, k_logical=K).to("cpu")


@pytest.mark.parametrize("T", [1, 3, 9])
@pytest.mark.parametrize("K,O", [(256, 24), (512, 40), (1024, 16)])
def test_q80_matmul_ref_matches_jax_kernel(K, O, T):
    rng = np.random.default_rng(K + O + T)
    qt_j = jq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), "q80")
    qt_t = _port_qt(qt_j, "q80", K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    ref = np.asarray(jq.q80_matmul(jnp.asarray(x), qt_j.w, qt_j.s))
    got = tq.q80_matmul_ref(torch.from_numpy(x), qt_t.w, qt_t.s)
    assert got.dtype == torch.float32 and got.shape == (T, O)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    # the dispatching wrapper on CPU tensors is the same function
    assert torch.equal(tq.q80_matmul(torch.from_numpy(x), qt_t.w, qt_t.s), got)


@pytest.mark.parametrize("d,n", [(24, 192), (40, 256), (8, 1024)])
def test_q80_pack_and_repack_planes_equal(d, n):
    rng = np.random.default_rng(d + n)
    x = (rng.standard_normal(d * n) * 0.1).astype(np.float32)
    raw = j_blocks.quantize_q80(x)
    np.testing.assert_array_equal(raw, t_blocks.quantize_q80(x))
    j = jq.repack_q80(raw, d, n, to_device=False)
    t = tq.repack_q80(raw, d, n)
    for name in ("w", "s", "s2"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (j.kind, j.k_logical) == (t.kind, t.k_logical) == ("q80", n)
    # lossless: the planes hold the file's values exactly
    np.testing.assert_array_equal(tq.dequantize(t), t_blocks.dequantize_q80(raw, d * n)
                                  .reshape(d, n).T)
    q, dl = rng.integers(-127, 128, (n, d)), rng.random((n // 32, d)).astype(np.float32)
    pj, pt = jq.pack_q80(q, dl, to_device=False), tq.pack_q80(q, dl)
    for name in ("w", "s"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, name)), getattr(pt, name))


CASES = [("q40", True), ("q40", False), ("q80", None)]


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,nosub", CASES)
def test_fused_norm_matches_jax(kind, nosub, act):
    rng = np.random.default_rng(len(kind) + (nosub is True) + len(act))
    T, K, O = 3, 192, 40
    qt_j = jq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), kind)
    qt_t = _port_qt(qt_j, kind, K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(act), torch.from_numpy(x).to(getattr(torch, act))
    nwj, nwt = jnp.asarray(nw), torch.from_numpy(nw)
    inv_j, inv_t = jq.rmsnorm_inv(xj, 1e-5), tq.rmsnorm_inv(xt, 1e-5)
    if kind == "q40":
        ref = jq.q40_matmul(xj, qt_j.w, qt_j.s, qt_j.s2, nosub=nosub, norm_w=nwj, norm_inv=inv_j)
        got = tq.q40_matmul(xt, qt_t.w, qt_t.s, qt_t.s2, nosub=nosub, norm_w=nwt, norm_inv=inv_t)
    else:
        ref = jq.q80_matmul(xj, qt_j.w, qt_j.s, norm_w=nwj, norm_inv=inv_j)
        got = tq.q80_matmul(xt, qt_t.w, qt_t.s, norm_w=nwt, norm_inv=inv_t)
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    # the dispatcher: the default nosub setting on both sides, output in x's dtype
    want = np.asarray(jq.qmatmul_norm(xj, nwj, qt_j)).astype(np.float32)
    have = tq.qmatmul_norm(xt, nwt, qt_t)
    assert have.dtype == xt.dtype
    assert np.abs(have.float().numpy() - want).max() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,nosub", CASES)
def test_fused_norm_bit_equal_to_unfused_in_the_port(kind, nosub, act):
    rng = np.random.default_rng(7)
    T, K, O = 5, 320, 72
    qt = tq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), kind, "cpu")
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(act)
    nw = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32))
    inv = tq.rmsnorm_inv(x)
    if kind == "q40":
        fused = tq.q40_matmul(x, qt.w, qt.s, qt.s2, nosub=nosub, norm_w=nw, norm_inv=inv)
        plain = tq.q40_matmul(rmsnorm(x, nw), qt.w, qt.s, qt.s2, nosub=nosub)
    else:
        fused = tq.q80_matmul(x, qt.w, qt.s, norm_w=nw, norm_inv=inv)
        plain = tq.q80_matmul(rmsnorm(x, nw), qt.w, qt.s)
    assert torch.equal(fused, plain)
    assert torch.equal(tq.qmatmul_norm(x, nw, qt), tq.qmatmul(rmsnorm(x, nw), qt))


def test_norm_fusion_gate_reads_the_flag_per_call(monkeypatch):
    qt = tq.quantize_tensor(np.ones((64, 8), np.float32), "q80", "cpu")
    monkeypatch.delenv("DLLAMA_FUSE_NORM", raising=False)
    assert not tq.norm_fusion_enabled() and not tq.norm_fusion_engages(qt)
    monkeypatch.setenv("DLLAMA_FUSE_NORM", "1")
    assert tq.norm_fusion_engages(qt)
    assert not tq.norm_fusion_engages(torch.ones(64, 8))  # dense: nothing to fuse into
    with pytest.raises(ValueError, match="together"):
        tq._kernel_activation(torch.ones(1, 64), 64, torch.ones(64), None)
