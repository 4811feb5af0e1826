"""The port's quantized tensor parallelism against the JAX package's
(``dllama_tpu/parallel/quant_tp.py``), on the CPU: the mirror of
``tests/test_tp_quant.py``.

The JAX side runs ``quant_tp.make_tp_forward`` on conftest's 8 virtual CPU
devices; the port side runs a real gloo world of 2 and of 4 processes
(``parallel.group.LocalWorld``, started once for the module), each rank
holding its output shards of the same numpy parameters
(``from_jax_params(..., tp=)``) and gathering through ``torch.distributed``.

Tolerances:
* port TP against the port on one device: 1e-5·max|logit| with plain
  gathers (the CPU plain versions compute each output column from the
  whole K either way); with the Q80 wire, JAX's own compressed-against-plain
  tolerance (0.05·max|logit|, correlation > 0.999);
* port TP against JAX TP: 1e-5·max|logit|, plain gathers and Q80 wire
  alike (measured: 4e-7): the plain versions of the port's kernels agree
  with JAX's interpret-mode kernels to f32 summation order, and the Q80
  wire is bit-equal (``test_torch_tp_collectives.py``), so no activation
  rounds to another quant here. (The port's general Q40/Q80 tolerance
  against JAX is 1e-3, ``tests/test_torch_llama.py``.)
* tokens (greedy, and sampled with the same seed, which every rank draws
  from its own generator) are equal on every rank and to one device.
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
from dllama_tpu.runtime.generate import Engine as JEngine
from dllama_tpu.runtime.sampler import SamplerConfig as JSampler
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.weights import WeightFileReader, tensor_plan, write_model
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops.qmatmul import QuantTensor
from dllama_tpu_torch.parallel import quant_tp as tq
from dllama_tpu_torch.parallel.group import LocalWorld, TPGroup
from dllama_tpu_torch.quants import blocks
from tests import torch_tp_ranks as R

SHAPE = dict(arch="llama", dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=4,
             vocab_size=512, seq_len=64, head_size=32, kv_dim=128, dtype="float32")
#: hidden 320 and vocab 384 pad at tp 4 (hidden to 512, vocab to 512: the
#: last rank's wcls shard is all padding)
PADDED = {**SHAPE, "hidden_dim": 320, "vocab_size": 384}
#: a vocab tp 4 does not divide: wcls stays whole on every rank
ODD_VOCAB = {**SHAPE, "vocab_size": 510}
PROMPT = [3, 7, 11]


@pytest.fixture(scope="module")
def world():
    with LocalWorld(4, threads=1, timeout_s=180) as w:
        yield w


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same CPU sums
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(shape: dict, kind: str):
    """(JAX quantized params, the host copy ranks take) of ``shape``."""
    key = (tuple(sorted(shape.items())), kind)
    if key not in _PARAMS:
        jc = JConfig(**shape)
        qp = jl.quantize_params(jl.random_params(jc, seed=0, dtype=np.float32), kind)
        _PARAMS[key] = (qp, R.host_params(jax.tree.map(np.asarray, qp)))
    return _PARAMS[key]


def _jax_tp_logits(shape: dict, kind: str, tp: int, compress: bool, tokens: list) -> np.ndarray:
    jc = JConfig(**shape)
    qp, _ = _params(shape, kind)
    mesh = tp_mesh(tp)
    sharded = jq.shard_quant_params(qp, mesh, jc)
    fwd = jax.jit(jq.make_tp_forward(jc, mesh, sharded, compress=compress))
    logits, _ = fwd(sharded, jl.rope_tables(jc), jl.init_cache(jc),
                    jnp.asarray(tokens, jnp.int32), jnp.int32(0))
    return np.asarray(logits)


def _close(got, want, frac, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= frac * scale, (what, err, frac * scale)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "q80wire"])
@pytest.mark.parametrize("kind", ["q40", "q80"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_jax_tp_and_one_device(world, tp, kind, compress):
    """Decode at position 0 (T = 1): port TP logits against JAX's
    ``make_tp_forward`` and against the port on one device; then a 19-token
    prefill and two decode steps against one device. Every rank's logits
    are equal."""
    cfg = TConfig(**SHAPE)
    _, host = _params(SHAPE, kind)
    ranks = world.run(R.logits_case, host, cfg, compress, [5], size=tp)
    one = R.logits_case(None, host, cfg, False, [5])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["first"], ranks[0]["first"])
        for a, b in zip(r["chain"], ranks[0]["chain"]):
            np.testing.assert_array_equal(a, b)
    got = ranks[0]
    want_jax = _jax_tp_logits(SHAPE, kind, tp, compress, [5])
    _close(got["first"], want_jax, 1e-5, "vs JAX TP")
    for g, w in zip([got["first"], *got["chain"]], [one["first"], *one["chain"]]):
        if compress:
            _close(g, w, 0.05, "q80 wire vs one device")
            assert np.corrcoef(g.reshape(-1), w.reshape(-1))[0, 1] > 0.999
        else:
            _close(g, w, 1e-5, "plain vs one device")


@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_and_sampled_decode_equal_one_device_on_every_rank(world, tp):
    """``generate`` and ``generate_fused``: greedy tokens of every rank =
    the one-device engine's; sampled (T 0.8, top-p 0.9, seed 5): every rank
    draws the same tokens from its own generator, equal to one device's."""
    cfg = TConfig(**SHAPE)
    _, host = _params(SHAPE, "q40")
    for temp in (0.0, 0.8):
        ranks = world.run(R.decode_case, host, cfg, False, PROMPT, 8, temp, 5, size=tp)
        one = R.decode_case(None, host, cfg, False, PROMPT, 8, temp, 5)
        for r in ranks:
            assert r["tokens"] == one["tokens"] and r["fused"] == one["fused"], temp
        if temp == 0.0:
            assert one["tokens"] == one["fused"]


def test_greedy_decode_equals_jax_one_device_engine(world):
    """The port's TP tokens = the JAX package's one-device engine's."""
    qp, host = _params(SHAPE, "q40")
    want, _, _ = JEngine(JConfig(**SHAPE), qp, JSampler(temperature=0.0)).generate_fused(
        PROMPT, steps=8)
    for r in world.run(R.decode_case, host, TConfig(**SHAPE), False, PROMPT, 8, size=4):
        assert r["tokens"] == want


def test_generate_batch_under_tp_equals_one_device(world):
    """``generate_batch`` at B = 4 under tp 2: every rank's rows = the
    one-device batch's, token for token."""
    cfg = TConfig(**SHAPE)
    _, host = _params(SHAPE, "q80")
    prompts = [[5, 9, 3, 5], [7, 7], [4, 2, 8], [1]]
    one = R.batch_case(None, host, cfg, prompts, 6)
    for rows in world.run(R.batch_case, host, cfg, prompts, 6, size=2):
        assert rows == one


def test_vocab_that_tp_does_not_divide_keeps_wcls_whole(world):
    cfg = TConfig(**ODD_VOCAB)
    _, host = _params(ODD_VOCAB, "q40")
    shard = tq.shard_params(host, cfg, 1, 4)
    assert shard["wcls"].out_features == 510  # every rank computes every logit
    ranks = world.run(R.logits_case, host, cfg, False, [2], size=4)
    one = R.logits_case(None, host, cfg, False, [2])
    _close(ranks[0]["first"], one["first"], 1e-5, "odd vocab")
    _close(ranks[0]["first"], _jax_tp_logits(ODD_VOCAB, "q40", 4, False, [2]), 1e-5,
           "odd vocab vs JAX TP")


def test_lane_padding_keeps_logits(world):
    """hidden 320 and vocab 384 at tp 4: w1/w3's output and w2's packed
    input pad to 512 together, the vocab to 512 (the last rank's shard is
    all padding); the padded vocab never reaches the sampler."""
    cfg = TConfig(**PADDED)
    _, host = _params(PADDED, "q40")
    assert tq.ffn_padded_width(cfg, "q40", 4) == 512
    for rank in range(4):
        shard = tq.shard_params(host, cfg, rank, 4)
        assert shard["layers"]["w1"].out_features == 128
        assert shard["layers"]["w2"].k_padded == 512
        assert shard["wcls"].out_features == 128
    last = tq.shard_params(host, cfg, 3, 4)["wcls"]
    assert not last.s.any() and not last.s2.any()
    ranks = world.run(R.logits_case, host, cfg, False, [5], size=4)
    one = R.logits_case(None, host, cfg, False, [5])
    assert ranks[0]["first"].shape == (1, 384)
    _close(ranks[0]["first"], one["first"], 1e-5, "padded")
    _close(ranks[0]["first"], _jax_tp_logits(PADDED, "q40", 4, False, [5]), 1e-5,
           "padded vs JAX TP")
    for a, b in zip(ranks[0]["chain"], one["chain"]):
        _close(a, b, 1e-5, "padded chain")


def _write_model(path: str, shape: dict, kind: str) -> None:
    ft = {"q40": blocks.Q40, "q80": blocks.Q80}[kind]
    spec = ModelSpec(arch=ArchType.LLAMA, dim=shape["dim"], hidden_dim=shape["hidden_dim"],
                     n_layers=shape["n_layers"], n_heads=shape["n_heads"],
                     n_kv_heads=shape["n_kv_heads"], vocab_size=shape["vocab_size"],
                     seq_len=shape["seq_len"], weights_float_type=ft)
    rng = np.random.default_rng(9)
    write_model(path, spec, {e.name: 0.05 * rng.standard_normal(e.d * e.n).astype(np.float32)
                             for e in tensor_plan(spec)})


def _plane_equal(a: QuantTensor, b: QuantTensor, what: str) -> None:
    for n in ("w", "s", "s2"):
        x, y = getattr(a, n), getattr(b, n)
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{n}")
    assert (a.kind, a.k_logical) == (b.kind, b.k_logical), what


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_m_file_read_shard_by_shard(world, tmp_path, kind):
    """Each rank reads only its shard's rows of a `.m` file: its planes
    (fused from its own parts) equal the slices of the whole model's, and
    the ranks of a tp 4 engine decode the one-device engine's tokens."""
    cfg = TConfig(**PADDED)
    path = str(tmp_path / f"tp_{kind}.m")
    _write_model(path, PADDED, kind)
    with WeightFileReader(path) as reader:
        whole = tl.quant_params_from_reader(reader, cfg, "cpu", kind)
    for size in (2, 4):
        for rank in range(size):
            with WeightFileReader(path) as reader:
                got = tl.quant_params_from_reader(
                    reader, cfg, "cpu", kind, tp=TPGroup(rank, size, torch.device("cpu"), "gloo"))
            want = tl.fuse_qkv_ffn(tq.shard_params(whole, cfg, rank, size))
            assert set(got["layers"]) == set(want["layers"]) == set(whole["layers"])
            for name, leaf in want["layers"].items():
                if isinstance(leaf, QuantTensor):
                    _plane_equal(got["layers"][name], leaf, f"{name} rank {rank}/{size}")
            _plane_equal(got["wcls"], want["wcls"], f"wcls rank {rank}/{size}")
    ranks = world.run(R.reader_case, path, cfg, kind, PROMPT, 6, size=4)
    one = R.reader_case(None, path, cfg, kind, PROMPT, 6)
    assert ranks[0]["shapes"]["wqkv"][-1] == (cfg.dim + 2 * cfg.kv_dim) // 4
    for r in ranks:
        assert r["tokens"] == one["tokens"]


def test_compressed_close_to_plain_at_jax_tolerance(world):
    """The Q80 wire engaged (logits differ) and within JAX's tolerance of
    the plain gathers (``tests/test_tp_quant.py:145``)."""
    cfg = TConfig(**SHAPE)
    _, host = _params(SHAPE, "q40")
    plain = world.run(R.logits_case, host, cfg, False, [5], size=4)[0]["first"]
    comp = world.run(R.logits_case, host, cfg, True, [5], size=4)[0]["first"]
    assert not np.array_equal(plain, comp)
    _close(comp, plain, 0.05, "q80 wire vs plain")
    assert np.corrcoef(plain.reshape(-1), comp.reshape(-1))[0, 1] > 0.999


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "q80wire"])
@pytest.mark.parametrize("tp", [2, 4])
def test_wire_bytes_per_token_equal_jax_analytic_count(world, tp, compress):
    """The bytes a decode token's gathers sent (``TokenStats.sent_kb``,
    counted by the gathers) = the JAX Engine's analytic
    ``_wire_bytes(1)``; the prefill's cover its gathers (one row of
    logits: the port computes the classifier at the last row only)."""
    cfg = TConfig(**SHAPE)
    qp, host = _params(SHAPE, "q40")
    want = JEngine(JConfig(**SHAPE), qp, JSampler(temperature=0.0), mesh=tp_mesh(tp),
                   tp_compress=compress)._wire_bytes(1)
    ranks = world.run(R.decode_case, host, cfg, compress, PROMPT, 4, size=tp)
    for r in ranks:
        for kb in r["sent_kb"][1:]:
            assert kb * 1024 == pytest.approx(want, rel=1e-12)
        assert r["recv_kb"] == r["sent_kb"]
    per_feat = 1.125 if compress else 4.0
    hidden = tq.ffn_padded_width(cfg, "q40", tp)
    layers = cfg.n_layers * (3 * cfg.dim + hidden) * per_feat * 8  # bucket 8
    assert ranks[0]["sent_kb"][0] * 1024 == pytest.approx(
        (layers + cfg.vocab_size * 4.0) * (tp - 1) / tp, rel=1e-12)


def test_engine_refuses_whole_params_dense_params_and_paths_not_ported():
    """What a tensor-parallel engine refuses, before any collective: a
    whole model where a rank's shard belongs, dense weights, and the paths
    this slice leaves out (speculative decoding, BatchSession)."""
    from dllama_tpu_torch.runtime.generate import Engine

    cfg = TConfig(**SHAPE)
    qp, host = _params(SHAPE, "q40")
    group = TPGroup(0, 2, torch.device("cpu"), "gloo")  # never joined
    whole = tl.params_to(host, "cpu")
    with pytest.raises(ValueError, match="wo has 256 output columns where a rank"):
        Engine(cfg, whole, device="cpu", tp=group, metrics=None)
    dense = tl.random_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        Engine(cfg, dense, device="cpu", tp=group, metrics=None)
    eng = Engine(cfg, tl.params_to(tq.shard_params(host, cfg, 0, 2), "cpu"), device="cpu",
                 tp=group, tp_compress=True, metrics=None)
    assert eng.tp_wire == "q80" and not eng.cuda_graphs and not eng.supports_batch_spec
    assert eng.new_cache()["k"].shape == (2, 64, 2, 32)  # this rank's 2 of 4 kv heads
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 8"):
        list(eng.generate_spec(PROMPT, 4))
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 8"):
        eng.generate_batch_spec([PROMPT], 4)
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 8"):
        eng.batch_session(2)
