"""The port's mixture-of-experts (``models.moe``, the MoE leaves of
``models.llama`` and the expert-indexed launchers of ``ops.qmatmul``)
against the JAX package's, on the CPU. The JAX side runs as its own tests
run it (``tests/test_moe.py``): Pallas in interpret mode.

Tolerances, each stated where it is used:

* Routing: indices equal (a constructed tie included: the lowest index
  first, ``jax.lax.top_k``'s order); on exact router logits, the
  renormalized weights within 1 f32 ulp of their value (softmax sums in
  another order).
* ``moe_ffn`` on dense f32 stacks: 1e-5 abs (summation order only, as the
  dense model's tests); on bf16 stacks, 1e-2 of the output's magnitude
  (bf16 rounds each step's output: a last-place flip in one expert's
  product moves the sum by a bf16 ulp of ~4e-3 relative).
* ``moe_ffn`` on Q40/Q80 stacks at a layer index, f32 activations: 1e-4 of
  the output's magnitude. Both sides multiply the same bf16 values exactly
  and add them in f32 in another order (~1e-7 of the magnitude), but the
  down kernels round the hidden activation to bf16 again: where the up
  sums differ by an f32 ulp at a bf16 rounding boundary, that element
  moves by a bf16 ulp (2^-8 of itself), ~2e-5 of the output here.
* The stacked plain versions against JAX's stacked launchers at a traced
  index: 1e-5 of the output's magnitude (the same f32 sums in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.weights import WeightFileReader as JReader
from dllama_tpu.models import llama as jl
from dllama_tpu.models import moe as jmoe
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.ops import qmatmul as jq
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import kernels
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.formats.spec import ArchType, HiddenAct, ModelSpec
from dllama_tpu_torch.formats.weights import WeightFileReader as TReader
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models import moe as tmoe
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops import qmatmul as tq
from dllama_tpu_torch.ops.qmatmul import QuantTensor
from dllama_tpu_torch.quants import blocks
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler

BASE = dict(dim=128, hidden_dim=192, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
            seq_len=256, head_size=32, kv_dim=64, n_active_experts=2, dtype="float32")
SHAPES = {"mixtral": dict(BASE, arch="mixtral", n_experts=8, hidden_act="silu"),
          "grok1": dict(BASE, arch="grok1", n_experts=4, hidden_act="gelu")}
GREEDY = tsampler.SamplerConfig(temperature=0.0)
PROMPT = np.array([1, 5, 9, 13, 2, 7, 3, 4, 11, 12, 40, 41, 42, 43, 44, 45, 46, 47, 48],
                  np.int32)  # 19 tokens: the prefill route on both sides


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (several test processes share the
    CPU, and spinning thread pools would oversubscribe it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _cfgs(arch, **kw):
    shape = {**SHAPES[arch], **kw}
    return JConfig(**shape), TConfig(**shape)


def _params(arch, quant=None, seed=0, **kw):
    """(JAX params, the port's copy, JAX config, port config); quantized
    params are fused on both sides, as the engines fuse them."""
    jc, tc = _cfgs(arch, **kw)
    jp = jl.random_params(jc, seed=seed, dtype=np.float32)
    if quant:
        jp = jl.fuse_qkv_ffn(jl.quantize_params(jp, quant))
    return jp, from_jax_params(_np_tree(jp), tc, "cpu"), jc, tc


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_top_k_order_is_jax_top_k_order_on_ties():
    v = np.array([[0.1, 0.3, 0.3, 0.0, 0.3, 0.0, 0.2, 0.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = tmoe.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_route_topk_and_union_pick_match_jax(arch, T):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(T)
    # multiples of 1/64 and 1/8 of a few units: every router logit is exact
    # in f32 whatever order the matmul sums in, so the weights differ only
    # by softmax's own rounding
    router = (rng.integers(-8, 9, (tc.dim, tc.n_experts)) / 64).astype(np.float32)
    router[:, 3] = router[:, 1]  # experts 1 and 3 tie on every row
    x = (rng.integers(-8, 9, (T, tc.dim)) / 8).astype(np.float32)
    x[0] = 0.0  # a row whose probabilities all tie
    ji, jw = jmoe.route_topk(jc, jnp.asarray(router), jnp.asarray(x))
    ti, tw = tmoe.route_topk(tc, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # within 1 f32 ulp of the value
    ulp = np.spacing(np.abs(np.asarray(jw)))
    assert (np.abs(tw.numpy() - np.asarray(jw)) <= ulp).all()
    jcomb = jmoe.route(jc, jnp.asarray(router), jnp.asarray(x))
    tcomb = tmoe.route(tc, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(tcomb.numpy() != 0, np.asarray(jcomb) != 0)
    # the union pick of the selected path, on the same combine weights
    cap = min(tc.n_experts, T * tc.n_active_experts)
    _, jids = jax.lax.top_k(jcomb.max(axis=0), cap)
    _, tids = tmoe.top_k(torch.from_numpy(np.array(jcomb)).max(dim=0).values, cap)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _layer_leaves(p, layer, names):
    return {n: p["layers"][n][layer] for n in names}


@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dense_stacks_match_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype=dtype)
    jp = jl.random_params(jc, seed=2)
    tp = from_jax_params(_np_tree(jp), tc, "cpu")
    names = ("moe_router", "moe_up", "moe_gate", "moe_down")
    rng = np.random.default_rng(7)
    for T in (1, 5):
        x = rng.standard_normal((T, tc.dim)).astype(np.float32)
        jx = jnp.asarray(x).astype(jc.jax_dtype)
        want = np.asarray(jmoe.moe_ffn(jc, _layer_leaves(jp, 1, names), jx), np.float32)
        got = tmoe.moe_ffn(tc, _layer_leaves(tp, 1, names),
                           torch.from_numpy(x).to(tc.torch_dtype)).float().numpy()
        tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (T, np.abs(got - want).max(), tol)


@pytest.fixture(scope="module", params=["q40", "q80"])
def quant_mixtral(request):
    return _params("mixtral", request.param, seed=3)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 16])  # selected below 4 rows (E 8, k 2)
def test_moe_ffn_quant_stacks_at_a_layer_index_match_jax(quant_mixtral, T):
    jp, tp, jc, tc = quant_mixtral
    layer = 1
    jl_ = {n: (v if isinstance(v, jq.QuantTensor) else v[layer])
           for n, v in jp["layers"].items()}
    tl_ = {n: (v if isinstance(v, QuantTensor) else v[layer]) for n, v in tp["layers"].items()}
    x = np.random.default_rng(T).standard_normal((T, tc.dim)).astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jc, jl_, jnp.asarray(x), jnp.int32(layer)))
    got = tmoe.moe_ffn(tc, tl_, torch.from_numpy(x), layer)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (T, err)
    # the forward's form — this layer's views, no layer index — is the same sum
    views = tl._layer_params(tp["layers"], layer)
    assert torch.equal(tmoe.moe_ffn(tc, views, torch.from_numpy(x)), got)


def test_selected_path_reads_only_the_union_through_the_indexed_launchers(monkeypatch,
                                                                         quant_mixtral):
    _, tp, _, tc = quant_mixtral
    seen = []
    real = tq.qmatmul_stacked

    def noted(x, qt, ids, base=0, n_ids=None):
        seen.append((tuple(x.shape), ids.tolist(), base))
        return real(x, qt, ids, base, n_ids)

    monkeypatch.setattr(tq, "qmatmul_stacked", noted)
    views = tl._layer_params(tp["layers"], 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, tc.dim)).astype(
        np.float32))
    out = tmoe.moe_ffn(tc, views, x)
    combine = tmoe.route(tc, views["moe_router"], x)
    union = sorted(set(torch.nonzero(combine)[:, 1].tolist()))
    assert len(seen) == 2  # one up|gate launch, one down launch
    (xs_up, ids_up, _), (xs_down, ids_down, _) = seen
    assert ids_up == ids_down and len(ids_up) == 4 and set(union) <= set(ids_up)
    assert xs_up == (2, tc.dim) and xs_down == (4, 2, tc.hidden_dim)
    # the dense combine over every expert gives the same output within f32 order
    up = views["moe_upgate"]
    dense_out = torch.einsum(
        "ted,te->td",
        tmoe._expert_down(_dense_h(tc, x, up), views["moe_down"]), combine)
    torch.testing.assert_close(out, dense_out, rtol=1e-5, atol=1e-6)


def _dense_h(cfg, x, up):
    from dllama_tpu_torch.ops.activations import ACTIVATIONS

    ug = tmoe._expert_up(x, up)
    half = ug.shape[-1] // 2
    return ug[..., :half] * ACTIVATIONS[cfg.hidden_act](ug[..., half:])


# ---------------------------------------------------------------------------
# The stacked launchers' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["q40", "q80"])
@pytest.mark.parametrize("T", [1, 3])
def test_stacked_refs_match_jax_stacked_launchers(kind, T):
    rng = np.random.default_rng(11)
    K, O, N = 512, 96, 5
    planes = [tq.quantize_tensor((rng.standard_normal((K, O)) * 0.05).astype(np.float32), kind)
              for _ in range(N)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jq.quantize_tensor(np.asarray(tq.dequantize(p)), kind)
                            for p in planes])
    tstack = tl._stack(planes).to("cpu")
    x = rng.standard_normal((T, K)).astype(np.float32)
    ids = torch.tensor([3, 0, 3], dtype=torch.int32)
    if kind == "q40":
        got = tq.q40_matmul_stacked_ref(torch.from_numpy(x), tstack.w, tstack.s, tstack.s2,
                                        ids)
    else:
        got = tq.q80_matmul_stacked_ref(torch.from_numpy(x), tstack.w, tstack.s, ids)
    for j, i in enumerate(ids.tolist()):
        if kind == "q40":
            want = jq.q40_matmul_stacked(jnp.asarray(x), jstack.w, jstack.s, jstack.s2,
                                         jnp.int32(i))
        else:
            want = jq.q80_matmul_stacked(jnp.asarray(x), jstack.w, jstack.s, jnp.int32(i))
        want = np.asarray(want, np.float32)
        assert np.abs(got[j].numpy() - want).max() <= 1e-5 * np.abs(want).max(), (j, i)


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_stacked_wrapper_on_the_cpu_is_its_ref_and_the_view_product(kind):
    rng = np.random.default_rng(5)
    K, O, L, E = 512, 64, 2, 4
    stack = tl._stack([tl._stack([
        tq.quantize_tensor((rng.standard_normal((K, O)) * 0.05).astype(np.float32), kind)
        for _ in range(E)]) for _ in range(L)]).to("cpu")
    flat = tmoe.flat_experts(stack)
    x = torch.from_numpy(rng.standard_normal((2, 3, 300)).astype(np.float32))  # own x per j
    ids = torch.tensor([2, 1], dtype=torch.int32)
    kernels.reset_launches()
    got = tq.matmul_any(x, flat, ids, base=E)  # layer 1's experts 2 and 1
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only
    for j, e in enumerate(ids.tolist()):
        want = tq.matmul_any(x[j], stack.layer(1).layer(e))
        assert torch.equal(got[j], want)
        assert torch.equal(tq.matmul_any(x[j], stack.layer(1), e), want)
    # an expert outside [0, n_ids) gives NaN, as the kernel defines it
    bad = torch.tensor([1, E], dtype=torch.int32)
    out = tq.qmatmul_stacked(x, flat, bad, base=0, n_ids=E)
    assert not torch.isnan(out[0]).any() and torch.isnan(out[1]).all()


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
def test_params_carry_across_and_quantize_alike(arch):
    jc, tc = _cfgs(arch)
    jp = jl.random_params(jc, seed=3)
    tp = from_jax_params(_np_tree(jp), tc, "cpu")
    own = tl.random_params(tc, seed=3, device="cpu")
    assert set(own["layers"]) == set(jp["layers"]) == set(tp["layers"])
    for k, v in own["layers"].items():
        assert torch.equal(v, tp["layers"][k]), k
    assert tp["layers"]["moe_up"].shape == (2, tc.n_experts, tc.dim, tc.hidden_dim)
    assert ("rms_moe" in tp["layers"]) == (arch == "grok1")
    jq_ = jl.fuse_qkv_ffn(jl.quantize_params(jp, "q40"))
    tq_ = tl.fuse_qkv_ffn(tl.quantize_params(own, "q40"))
    carried = from_jax_params(_np_tree(jq_), tc, "cpu")
    assert set(tq_["layers"]) == set(jq_["layers"]) == set(carried["layers"])
    assert "moe_upgate" in tq_["layers"] and "moe_up" not in tq_["layers"]
    for k, v in tq_["layers"].items():
        c = carried["layers"][k]
        if isinstance(v, QuantTensor):
            for a in ("w", "s", "s2"):
                assert torch.equal(getattr(v, a), getattr(c, a)), (k, a)
        else:
            assert torch.equal(v, c), k


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_random_quant_params_moe_stacks(kind):
    _, tc = _cfgs("grok1")
    p = tl.random_quant_params(tc, "cpu", torch.Generator().manual_seed(0), kind)
    L, E, D, H = tc.n_layers, tc.n_experts, tc.dim, tc.hidden_dim
    ug, dn = p["layers"]["moe_upgate"], p["layers"]["moe_down"]
    assert ug.w.shape[:2] == dn.w.shape[:2] == (L, E)
    assert ug.out_features == 2 * H and dn.out_features == D and dn.in_features == H
    assert p["layers"]["moe_router"].shape == (L, D, E)
    assert p["layers"]["rms_moe"].shape == p["layers"]["rms_ffn2"].shape == (L, D)
    again = tl.random_quant_params(tc, "cpu", torch.Generator().manual_seed(0), kind)
    assert torch.equal(again["layers"]["moe_upgate"].w, ug.w)
    eng = tgen.Engine(tc, p, GREEDY, device="cpu")
    toks, _, _ = eng.generate_fused([1, 2], 3)
    assert len(toks) == 3 and all(0 <= t < tc.vocab_size for t in toks)


