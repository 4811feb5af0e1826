"""The port's Q40 packing and the Q40 matmul's plain version against the JAX
package (CPU; the JAX side runs its Pallas kernels in interpret mode).

Packing is pure data movement, so the planes must be equal. The matmul's
plain version rounds both dot operands to bf16 exactly as the TPU kernel
does and sums the (exact) products in f32, so it differs from the JAX kernel
only in summation order: max abs err <= 1e-5 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import qmatmul as jq
from dllama_tpu.quants import blocks as j_blocks
from dllama_tpu_torch.ops import qmatmul as tq
from dllama_tpu_torch.quants import blocks as t_blocks


def _planes_equal(j, t):
    for name in ("w", "s", "s2"):
        a = np.asarray(getattr(j, name))
        b = getattr(t, name)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (j.kind, j.k_logical) == (t.kind, t.k_logical)


@pytest.mark.parametrize("K,O", [(128, 24), (192, 40), (1024, 16)])
def test_quantize_pack_dequantize_equal(K, O):
    rng = np.random.default_rng(K + O)
    w = (rng.standard_normal((K, O)) * 0.1).astype(np.float32)
    j = jq.quantize_tensor(w, "q40", to_device=False)
    t = tq.quantize_tensor(w, "q40")
    _planes_equal(j, t)
    np.testing.assert_array_equal(jq.dequantize(j), tq.dequantize(t))
    np.testing.assert_array_equal(jq.dequantize(j), tq.dequantize(t.to("cpu")))
    q, d = rng.integers(-8, 8, (K, O)), rng.random((K // 32, O)).astype(np.float32)
    _planes_equal(jq.pack_q40(q, d, to_device=False), tq.pack_q40(q, d))


def test_repack_q40_lossless_and_equal():
    rng = np.random.default_rng(7)
    d, n = 24, 192  # a [d, n] file tensor -> [n, d] kernel matrix, K padded to 512
    x = (rng.standard_normal(d * n) * 0.1).astype(np.float32)
    raw = j_blocks.quantize_q40(x)
    np.testing.assert_array_equal(raw, t_blocks.quantize_q40(x))
    j = jq.repack_q40(raw, d, n, to_device=False)
    t = tq.repack_q40(raw, d, n)
    _planes_equal(j, t)
    dense = t_blocks.dequantize_q40(raw, d * n).reshape(d, n).T
    np.testing.assert_array_equal(tq.dequantize(t), dense)


@pytest.mark.parametrize("nosub", [True, False])
@pytest.mark.parametrize("T", [1, 3, 17])
def test_q40_matmul_ref_matches_jax_kernel(nosub, T):
    rng = np.random.default_rng(T + 10 * nosub)
    K, O = 192, 40  # K pads to 512: the activation needs zero columns
    qt_j = jq.quantize_tensor((rng.standard_normal((K, O)) * 0.1).astype(np.float32), "q40")
    qt_t = tq.QuantTensor(*(np.asarray(getattr(qt_j, n)) for n in ("w", "s", "s2")),
                          kind="q40", k_logical=K).to("cpu")
    x = rng.standard_normal((T, K)).astype(np.float32)
    ref = np.asarray(jq.q40_matmul(jnp.asarray(x), qt_j.w, qt_j.s, qt_j.s2, nosub=nosub))
    got = tq.q40_matmul_ref(torch.from_numpy(x), qt_t.w, qt_t.s, qt_t.s2, nosub=nosub)
    assert got.dtype == torch.float32 and got.shape == (T, O)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    # the dispatching wrapper on CPU tensors is the same function
    assert torch.equal(tq.q40_matmul(torch.from_numpy(x), qt_t.w, qt_t.s, qt_t.s2, nosub=nosub),
                       got)


def test_qmatmul_output_dtype_and_q80_refusal():
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((64, 8)) * 0.1).astype(np.float32)
    qt = tq.quantize_tensor(w, "q40", "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32)).bfloat16()
    j = jq.qmatmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                   jq.quantize_tensor(w, "q40"))
    got = tq.qmatmul(x, qt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(j).astype(np.float32))
    # q80 is no longer refused: it dispatches to the Q80 kernel's route
    q80_j = jq.quantize_tensor(w, "q80", to_device=False)
    _planes_equal(q80_j, tq.quantize_tensor(w, "q80"))
    j80 = jq.qmatmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                     jq.quantize_tensor(w, "q80"))
    got80 = tq.qmatmul(x, tq.quantize_tensor(w, "q80", "cpu"))
    assert got80.dtype == torch.bfloat16
    np.testing.assert_array_equal(got80.float().numpy(), np.asarray(j80).astype(np.float32))
    with pytest.raises(ValueError, match="kind"):
        tq.qmatmul(x, tq.QuantTensor(qt.w, qt.s, qt.s2, kind="q50"))
