"""The port's quantized MoE expert stacks under tensor parallelism against
the JAX package's, on the CPU: the mirror of ``tests/test_tp_moe_quant.py``.

Mixtral- and Grok-shaped small models (2 layers; E = 8 and 4, k = 2) at tp
2: the JAX side runs ``quant_tp.make_tp_forward`` on conftest's virtual CPU
devices, the port side a real gloo world of 2 processes (started once for
the module), every expert plane an output shard. Decode (T = 1) takes the
selected-experts path (T·k < E), whose picked experts' hidden slices are
gathered in one collective; T = 4 takes the dense combine (T·k ≥ E).

Tolerances: port TP against the port on one device 1e-5·max|logit| (the
CPU plain versions compute each output column from the whole K either
way); against JAX's TP forward 5e-3·max|logit|, the port's MoE tolerance
against JAX (``tests/test_torch_moe_model.py``: a hidden activation that
differs by an ulp between the packages can round to another bf16 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.parallel import quant_tp as jq
from dllama_tpu.parallel.mesh import tp_mesh
from dllama_tpu_torch.formats.spec import ArchType, HiddenAct, ModelSpec
from dllama_tpu_torch.formats.weights import WeightFileReader, tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import GROK_EMBEDDING_SCALE, GROK_LOGIT_SCALE
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops.qmatmul import QuantTensor
from dllama_tpu_torch.parallel import quant_tp as tq
from dllama_tpu_torch.parallel.group import LocalWorld, TPGroup
from dllama_tpu_torch.quants import blocks
from tests import torch_tp_ranks as R

BASE = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=8, vocab_size=512,
            seq_len=64, head_size=32, kv_dim=256, n_active_experts=2, rope_style="half",
            dtype="float32")
SHAPES = {
    "mixtral": dict(BASE, arch="mixtral", n_experts=8),
    "grok1": dict(BASE, arch="grok1", n_experts=4, hidden_act="gelu",
                  embedding_scale=GROK_EMBEDDING_SCALE, logit_scale=GROK_LOGIT_SCALE,
                  post_norms=True),
}


@pytest.fixture(scope="module")
def world():
    with LocalWorld(2, threads=1, timeout_s=180) as w:
        yield w


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same CPU sums
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(arch: str, kind: str):
    if (arch, kind) not in _PARAMS:
        jc = JConfig(**SHAPES[arch])
        qp = jl.quantize_params(jl.random_params(jc, seed=3, dtype=np.float32), kind)
        _PARAMS[arch, kind] = (qp, R.host_params(jax.tree.map(np.asarray, qp)))
    return _PARAMS[arch, kind]


def _close(got, want, frac, what):
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= frac * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("tokens", [[5], [5, 9, 3, 1]], ids=["selected", "dense_combine"])
@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
def test_moe_tp_forward_matches_jax_tp_and_one_device(world, arch, tokens):
    qp, host = _params(arch, "q40")
    cfg = TConfig(**SHAPES[arch])
    ranks = world.run(R.moe_case, host, cfg, tokens, size=2)
    one = R.moe_case(None, host, cfg, tokens)
    # the path the JAX gate picks: every layer selected at T * k < E, none past it
    selected = cfg.n_layers if len(tokens) * cfg.n_active_experts < cfg.n_experts else 0
    for r in ranks:
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
        assert r["selected"] == one["selected"] == selected
    _close(ranks[0]["logits"], one["logits"], 1e-5, "vs one device")

    jc = JConfig(**SHAPES[arch])
    mesh = tp_mesh(2)
    sharded = jq.shard_quant_params(qp, mesh, jc)
    want, _ = jax.jit(jq.make_tp_forward(jc, mesh, sharded))(
        sharded, jl.rope_tables(jc), jl.init_cache(jc), jnp.asarray(tokens, jnp.int32),
        jnp.int32(0))
    _close(ranks[0]["logits"], np.asarray(want), 5e-3, "vs JAX TP")


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_moe_tp_engine_greedy_decode_equals_one_device(world, kind):
    """``generate`` and ``generate_fused`` of the expert-sharded engine:
    every rank's greedy tokens = the one-device engine's (prefill on the
    dense combine, decode on the selected experts)."""
    _, host = _params("mixtral", kind)
    cfg = TConfig(**SHAPES["mixtral"])
    one = R.decode_case(None, host, cfg, False, [3, 7, 11], 8)
    for r in world.run(R.decode_case, host, cfg, False, [3, 7, 11], 8, size=2):
        assert r["tokens"] == one["tokens"] and r["fused"] == one["fused"]


def test_moe_q80_wire_decode_is_close_to_plain(world):
    _, host = _params("grok1", "q40")
    cfg = TConfig(**SHAPES["grok1"])
    plain = world.run(R.logits_case, host, cfg, False, [7], size=2)[0]["first"]
    comp = world.run(R.logits_case, host, cfg, True, [7], size=2)[0]["first"]
    assert not np.array_equal(plain, comp)
    _close(comp, plain, 0.05, "q80 wire vs plain")


def test_moe_m_file_read_shard_by_shard(tmp_path):
    """A rank reads its rows of every expert: its fused ``moe_upgate`` and
    its ``moe_down`` equal the slices of the whole model's, each expert's
    up and gate shards side by side (not a slice of the fused stack)."""
    shape = SHAPES["mixtral"]
    spec = ModelSpec(arch=ArchType.MIXTRAL, dim=shape["dim"], hidden_dim=shape["hidden_dim"],
                     n_layers=shape["n_layers"], n_heads=shape["n_heads"],
                     n_kv_heads=shape["n_kv_heads"], vocab_size=shape["vocab_size"],
                     seq_len=shape["seq_len"], n_experts=shape["n_experts"],
                     n_active_experts=shape["n_active_experts"], hidden_act=HiddenAct.SILU,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(4)
    path = str(tmp_path / "mixtral.m")
    write_model(path, spec, {e.name: 0.05 * rng.standard_normal(e.d * e.n).astype(np.float32)
                             for e in tensor_plan(spec)})
    with WeightFileReader(path) as reader:
        cfg = TConfig.from_spec(reader.spec)
        whole = tl.quant_params_from_reader(reader, cfg, "cpu", "q40")
    for rank in range(2):
        with WeightFileReader(path) as reader:
            got = tl.quant_params_from_reader(reader, cfg, "cpu", "q40",
                                              tp=TPGroup(rank, 2, torch.device("cpu"), "gloo"))
        want = tl.fuse_qkv_ffn(tq.shard_params(whole, cfg, rank, 2))
        for name in ("moe_upgate", "moe_down", "wqkv", "wo"):
            a, b = got["layers"][name], want["layers"][name]
            assert isinstance(a, QuantTensor) and a.w.shape == b.w.shape, name
            for n in ("w", "s", "s2"):
                assert torch.equal(getattr(a, n), getattr(b, n)), (name, n, rank)
        H, h = cfg.hidden_dim, cfg.hidden_dim // 2  # whole and per-rank hidden
        fused, mine = whole["layers"]["moe_upgate"].w, got["layers"]["moe_upgate"].w
        assert torch.equal(mine[..., :h], fused[..., rank * h:(rank + 1) * h])  # up
        assert torch.equal(mine[..., h:], fused[..., H + rank * h:H + (rank + 1) * h])  # gate
        assert torch.equal(got["layers"]["moe_router"], whole["layers"]["moe_router"])
