"""The port's row-parallel reduce direction (``--tp-reduce``) against the
JAX package's, on the CPU: the mirror of ``tests/test_tp_reduce.py``.

The JAX side runs on conftest's 8 virtual CPU devices; the port side on one
gloo world of 4 processes started for the module (``LocalWorld``), its
rank cases in ``tests/torch_tp_ranks.py``.

* The collective: the plain ring is bitwise equal to JAX's
  ``reduce_scatter_columns`` (and to its pinned-order numpy replica) at tp
  2 and 4, f32 and bf16; the Q80 hops are bitwise equal to the exact
  numpy re-simulation of the quantized ring and within its analytic bound
  of the exact sum, and equal to JAX's but where JAX's own test allows its
  rounding flips; every hop's bytes are counted.
* The row packs: a rank's wo/w2 are JAX's ``row_shard_quant_leaf`` pack
  cut at the rank, bit for bit, from params and from a `.m` file.
* The engine (Q40 and Q80, tp 2 and 4, plain and q80 hops): logits within
  1e-5·max|logit| of JAX's row-mode TP forward; the batched decode and
  verify steps after a prefill, monolithic and overlapped, at B = 3 and 4,
  against JAX's ``make_tp_forward_batched``/``make_tp_verify_batched`` of
  the same modes on the same cache (most rows within 1e-5·max|logit|,
  every row within the cross-order tolerance: a bf16 rounding of an
  activation may flip); plain mode's greedy
  streams equal the gather-only engine's on every path; q80's equal run to
  run; the counter, the ``tp_reduce`` seam, the bytes a decode token (JAX's
  analytic count, but the scalar sums: the port all-gathers them, (tp - 1)
  scalars a row each where the analytic count has (tp - 1) / tp), and
  every declined case with JAX's reason.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.parallel import collectives as jc
from dllama_tpu.parallel import quant_tp as jq
from dllama_tpu.parallel.mesh import TP, tp_mesh
from dllama_tpu.runtime.generate import Engine as JEngine
from dllama_tpu.runtime.sampler import SamplerConfig as JSampler
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.parallel import quant_tp as tq
from dllama_tpu_torch.parallel.group import LocalWorld
from dllama_tpu_torch.runtime import generate as tg
from tests import torch_tp_ranks as R
from tests.test_tp_reduce import _np_ring_plain, _np_ring_q80, _run_reduce_scatter
from tests.test_torch_tp_quant import _write_model
from tests.torch_ports import store_address

#: the engine shape: dim 256 keeps a Q40 wo chunk whole at tp 4 (64 rows)
SHAPE = dict(arch="llama", dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=4,
             vocab_size=512, seq_len=64, head_size=32, kv_dim=128, dtype="float32")
#: JAX's test shape: a Q40 wo chunk at tp 4 is 32 rows, half a superblock
SMALL = dict(arch="llama", dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4,
             vocab_size=256, seq_len=64, head_size=32, kv_dim=128, dtype="float32")
MIXTRAL = dict(SMALL, arch="mixtral", n_experts=4, n_active_experts=2, rope_style="half")
PROMPT = [3, 7, 11]
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
STEPS = 8
POINTS = [("q40", 2, "plain"), ("q40", 2, "q80"), ("q80", 4, "plain"), ("q80", 4, "q80"),
          ("q40", 4, "plain")]
IDS = [f"{k}-tp{t}-{m}" for k, t, m in POINTS]


@pytest.fixture(scope="module")
def world():
    with LocalWorld(4, threads=1, timeout_s=180, init_method=store_address()) as w:
        yield w


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the same CPU sums
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}
_RUNS: dict = {}


def _params(shape: dict, kind: str):
    """(JAX quantized params, the host copy ranks take) of ``shape``."""
    key = (tuple(sorted(shape.items())), kind)
    if key not in _PARAMS:
        qp = jl.quantize_params(jl.random_params(JConfig(**shape), seed=0, dtype=np.float32),
                                kind)
        _PARAMS[key] = (qp, R.host_params(jax.tree.map(np.asarray, qp)))
    return _PARAMS[key]


def _run(world, kind: str, tp: int, mode: str, overlap: bool = False,
         compress: bool = False) -> list:
    """Every rank's ``modes_case`` of one point on SHAPE (cached: each point
    builds its engines once)."""
    key = (kind, tp, mode, overlap, compress)
    if key not in _RUNS:
        _, host = _params(SHAPE, kind)
        _RUNS[key] = world.run(R.modes_case, host, TConfig(**SHAPE), compress, mode, overlap,
                               PROMPT, PROMPTS, STEPS, size=tp)
    return _RUNS[key]


# -- the collective ------------------------------------------------------------

def _parts(tp: int, seed: int, scaled: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    parts = rng.standard_normal((tp, 5, 64 * tp))
    if scaled:
        parts = parts * rng.uniform(0.1, 8.0, (tp, 5, 1))
    return parts.astype(np.float32)


def _as(parts: np.ndarray, dtype: str) -> np.ndarray:
    """``parts`` rounded to ``dtype`` (the values both packages start from), as f32."""
    return torch.from_numpy(parts).to(getattr(torch, dtype)).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_plain_ring_bitwise_equal_to_jax(world, tp, dtype):
    """compress=False: every rank's chunk = JAX's ``reduce_scatter_columns``
    on the same partials, bit for bit (f32 out whatever the dtype in), =
    the pinned-order numpy schedule; each rank sent tp - 1 f32 chunks."""
    parts = _as(_parts(tp, tp), dtype)
    ranks = world.run(R.reduce_case, parts, False, dtype, size=tp)
    jax_out = _run_reduce_scatter(jnp.asarray(parts).astype(getattr(jnp, dtype)), tp, False)
    want = _np_ring_plain(parts)
    rows, c = parts.shape[1], parts.shape[2] // tp
    for i, r in enumerate(ranks):
        assert r["dtype"] == "torch.float32"
        np.testing.assert_array_equal(r["chunk"], jax_out[i])
        np.testing.assert_array_equal(r["chunk"], want[i])
        assert r["sent"] == (tp - 1) * rows * c * 4
        np.testing.assert_allclose(r["full"], parts.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_q80_ring_matches_simulation_and_jax(world, tp, dtype):
    """compress=True: every rank's chunk = the exact numpy re-simulation of
    the quantized ring bit for bit (the same codec in the same order, no
    fused multiply-add), within the analytic bound of the exact sum (the
    sum over hops of each hop's block scale / 2), and JAX's result within
    its own test's allowance (XLA may fuse the decode's multiply-add and
    flip a rounding at a .5 boundary); each hop sent one Q80 payload."""
    parts = _as(_parts(tp, 200 + tp, scaled=True), dtype)
    ranks = world.run(R.reduce_case, parts, True, dtype, size=tp)
    jax_out = _run_reduce_scatter(jnp.asarray(parts).astype(getattr(jnp, dtype)), tp, True)
    sim, bound = _np_ring_q80(parts)
    exact = _np_ring_plain(parts)
    ulp = np.spacing(np.abs(exact).max(), dtype=np.float32) * (tp + 1)
    rows, c = parts.shape[1], parts.shape[2] // tp
    got = np.stack([r["chunk"] for r in ranks])
    np.testing.assert_array_equal(got, sim)
    assert np.all(np.abs(got - exact) <= bound + ulp) and bound.max() > 0
    assert np.all(np.abs(got - jax_out) <= 2.0 * bound + ulp)
    assert np.mean(np.abs(got - jax_out) > ulp) < 0.01
    for r in ranks:
        assert r["sent"] == (tp - 1) * rows * (c + c // 8)


def test_scatter_roundtrip_and_rms_inv_against_jax(world):
    """``scatter_features`` then the gather is the identity; the scattered
    rms scale is within 1e-6 of JAX's ``rms_inv_scattered`` and of the
    float64 value (the local sums of squares add in another order than
    ``jnp.sum``'s: the last bit may differ)."""
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((3, 128)).astype(np.float32)
    want = 1.0 / np.sqrt((x0.astype(np.float64) ** 2).mean(-1) + 1e-5)
    for tp in (2, 4):
        mesh = tp_mesh(tp)

        def inner(p):
            s = jc.scatter_features(p[0], TP)
            return jc.rms_inv_scattered(s, TP, 128, 1e-5)[None]

        from dllama_tpu.compat import shard_map
        from jax.sharding import PartitionSpec as P

        jinv = np.asarray(jax.jit(shard_map(inner, mesh=mesh, in_specs=P(TP), out_specs=P(TP),
                                            check_vma=False))(
            jnp.asarray(np.broadcast_to(x0, (tp, 3, 128)).copy())))
        for i, r in enumerate(world.run(R.norm_case, x0, 1e-5, size=tp)):
            np.testing.assert_array_equal(r["back"], x0)
            np.testing.assert_allclose(r["inv"], jinv[i], rtol=1e-6)
            np.testing.assert_allclose(r["inv"], want, rtol=1e-6)


def test_block_guards(world):
    """A Q80 hop needs 32-value blocks in a chunk; the partials must split
    into whole chunks (the JAX package's guards, its words)."""
    got = world.run(R.guard_case, 96, True, size=2)[0]  # chunks of 48
    assert "reduce_scatter_columns(compress=True)" in got and "48" in got
    assert "not divisible by tp=2" in world.run(R.guard_case, 63, False, size=2)[0]


# -- the row packs ----------------------------------------------------------------

def _planes(leaf) -> tuple:
    return tuple(np.asarray(getattr(leaf, n)) for n in ("w", "s", "s2"))


def _jax_rank_piece(leaf, rank: int, tp: int) -> tuple:
    """Rank ``rank``'s piece of a JAX row-parallel pack: its share of the
    packed K axis of every plane (q80's empty s2 whole)."""
    out = []
    for a in _planes(leaf):
        if a.ndim < 2 or a.shape[-1] == 0:
            out.append(a)
            continue
        per = a.shape[-2] // tp
        out.append(a[..., rank * per:(rank + 1) * per, :])
    return tuple(out)


@pytest.mark.parametrize("kind,tp", [("q40", 2), ("q40", 4), ("q80", 2), ("q80", 4)])
def test_row_packs_equal_jax_row_shard_quant_leaf(world, kind, tp):
    """Every rank's wo and w2 = JAX's ``row_shard_quant_leaf`` pack cut at
    the rank, plane for plane and bit for bit, with the chunk as
    ``k_logical`` (w2 first padded to the FFN's padded width)."""
    qp, host = _params(SHAPE, kind)
    jcfg = JConfig(**SHAPE)
    want = {n: jq.row_shard_quant_leaf(n, jax.tree.map(np.asarray, qp["layers"][n]), jcfg, tp)
            for n in ("wo", "w2")}
    for rank, got in enumerate(world.run(R.row_pack_case, host, TConfig(**SHAPE), size=tp)):
        for n in ("wo", "w2"):
            for a, b in zip(got[n][:3], _jax_rank_piece(want[n], rank, tp)):
                np.testing.assert_array_equal(a, b, err_msg=f"{n} rank {rank}/{tp}")
            assert got[n][3] == tq.row_shard_chunk_k(TConfig(**SHAPE), n, kind, tp)
            assert got[n][3] == want[n].k_logical


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_row_packs_read_from_m_file(world, tmp_path, kind):
    """A rank reading a `.m` file with ``tp_reduce`` holds JAX's row pack of
    the file's matrices (``quant_params_from_reader``, no mesh), cut at the
    rank."""
    path = str(tmp_path / f"row_{kind}.m")
    _write_model(path, SHAPE, kind)
    from dllama_tpu.formats.weights import WeightFileReader as JReader

    with JReader(path) as reader:
        whole = jl.quant_params_from_reader(reader, JConfig(**SHAPE), kind)
    for tp in (2, 4):
        want = {n: jq.row_shard_quant_leaf(n, jax.tree.map(np.asarray, whole["layers"][n]),
                                           JConfig(**SHAPE), tp) for n in ("wo", "w2")}
        ranks = world.run(R.row_reader_case, path, TConfig(**SHAPE), kind, size=tp)
        for rank, got in enumerate(ranks):
            for n in ("wo", "w2"):
                for a, b in zip(got[n][:3], _jax_rank_piece(want[n], rank, tp)):
                    np.testing.assert_array_equal(a, b, err_msg=f"{n} {rank}/{tp}")


# -- the engine ---------------------------------------------------------------------

def _jax_row_logits(kind: str, tp: int, mode: str) -> np.ndarray:
    jcfg = JConfig(**SHAPE)
    qp, _ = _params(SHAPE, kind)
    mesh = tp_mesh(tp)
    sharded = jq.shard_quant_params(qp, mesh, jcfg, tp_reduce=True)
    fwd = jax.jit(jq.make_tp_forward(jcfg, mesh, sharded, tp_reduce=mode))
    logits, _ = fwd(sharded, jl.rope_tables(jcfg), jl.init_cache(jcfg),
                    jnp.asarray([5], jnp.int32), jnp.int32(0))
    return np.asarray(logits)


def _close(got, want, frac, what):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and err <= frac * scale, (what, err, frac * scale)


@pytest.mark.parametrize("kind,tp,mode", POINTS, ids=IDS)
def test_row_logits_match_jax_row_mode(world, kind, tp, mode):
    """Decode at position 0: every rank's logits are the same bits, and
    within 1e-5·max|logit| of JAX's row-mode ``make_tp_forward``. The
    prefill-then-decode chain against the gather-only engine: 5e-3 with
    plain hops (the ring adds the partial sums in another order, and a
    residual an ulp away can round to another bf16 activation in the
    kernels' plain versions: the port's cross-order tolerance,
    ``tests/test_torch_tp_moe.py``), 0.05 with q80 hops (JAX's compressed
    tolerance)."""
    ranks = _run(world, kind, tp, mode)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["first"], ranks[0]["first"])
    _close(ranks[0]["first"], _jax_row_logits(kind, tp, mode), 1e-5, "vs JAX row mode")
    base = _run(world, kind, tp, "off")[0]
    for g, w in zip(ranks[0]["chain"], base["chain"]):
        _close(g, w, 5e-3 if mode == "plain" else 0.05, "vs gather-only")


def _lens(stream):
    """A stream's length, or each row's for a batch's rows."""
    return [len(r) for r in stream] if stream and isinstance(stream[0], list) else len(stream)


_JAX_STEPS: dict = {}
#: B = 3 (halves of 1 + 2 rows) and B = 4 (2 + 2)
TWIN_BATCHES = [PROMPTS, PROMPTS + [[10, 3]]]
TWIN_T = 4


def _jax_step(kind: str, tp: int, mode: str, overlap: bool, verify: bool, cache: dict,
              tokens: np.ndarray, pos: list) -> np.ndarray:
    """The JAX package's quantized-TP batched decode step
    (``make_tp_forward_batched``) or verify step (``make_tp_verify_batched``)
    with ``overlap`` and ``tp_reduce`` (mode "off": None) on SHAPE's
    params, from the whole cache ``cache`` [L, B, S, kv, hd]."""
    jcfg = JConfig(**SHAPE)
    key = (kind, tp, mode, overlap, verify)
    if key not in _JAX_STEPS:
        qp, _ = _params(SHAPE, kind)
        mesh = tp_mesh(tp)
        red = None if mode == "off" else mode
        sharded = jq.shard_quant_params(qp, mesh, jcfg, tp_reduce=red is not None)
        make = jq.make_tp_verify_batched if verify else jq.make_tp_forward_batched
        _JAX_STEPS[key] = (sharded, jax.jit(make(jcfg, mesh, sharded, overlap=overlap,
                                                 tp_reduce=red)))
    sharded, fwd = _JAX_STEPS[key]
    logits, _ = fwd(sharded, jl.rope_tables(jcfg), {n: jnp.asarray(c) for n, c in cache.items()},
                    jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32))
    return np.asarray(logits)


def steps_against_jax(world, kind: str, tp: int, mode: str) -> dict:
    """The port's batched decode and verify steps (T = TWIN_T), monolithic
    and overlapped, at B = 3 and 4 after each row's prefill, against the
    JAX package's programs of the same modes on the same params and the
    same cache (every rank's kv heads joined): every rank returns the same
    bits, and each logit row's worst error over max|logit| comes back, by
    (B, step)."""
    _, host = _params(SHAPE, kind)
    ranks = world.run(R.twin_case, host, TConfig(**SHAPE), False, mode, TWIN_BATCHES, TWIN_T,
                      size=tp)
    jobs = {}
    with ThreadPoolExecutor(8) as pool:  # XLA compiles the eight programs side by side
        for bi, prompts in enumerate(TWIN_BATCHES):
            got = ranks[0][bi]
            cache = {n: np.concatenate([r[bi][n] for r in ranks], axis=3) for n in ("k", "v")}
            for name, overlap, verify in (("step", False, False), ("step_ov", True, False),
                                          ("verify", False, True), ("verify_ov", True, True)):
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[bi][name], got[name])
                toks = got["feeds"] if verify else np.asarray(got["pend"])
                jobs[(len(prompts), name)] = (got[name], pool.submit(
                    _jax_step, kind, tp, mode, overlap, verify, cache, toks, got["pos"]))
    errs = {}
    for key, (got, job) in jobs.items():
        want = job.result()
        assert got.shape == want.shape, (key, got.shape, want.shape)
        errs[key] = np.abs(got - want).reshape(-1, want.shape[-1]).max(-1) / np.abs(want).max()
    return errs


#: the port's cross-order tolerance (``tests/test_torch_tp_moe.py``)
CROSS_ORDER = 5e-3


def check_steps_against_jax(world, kind: str, tp: int, mode: str) -> None:
    """:func:`steps_against_jax`: most logit rows within 1e-5·max|logit| of
    JAX's (measured: 1e-7 to 4e-7), every row within :data:`CROSS_ORDER`.
    Both packages round each matmul's input to bf16, so where their f32
    sums (rmsnorm, attention, a matmul's order) differ in the last bit an
    activation can round to the neighbouring bf16 value, and the row it
    falls in moves by ~1e-3 (measured up to 1.7e-3; the one-row half of an
    overlapped B = 3 step at tp 2 also sums in another order on the CPU,
    4.7e-4). A fault of the row path or the overlap moves every row it
    touches, and far more."""
    rows = np.concatenate(list(steps_against_jax(world, kind, tp, mode).values()))
    assert rows.max() <= CROSS_ORDER, rows.max()
    assert np.mean(rows <= 1e-5) > 0.5, np.sort(rows)


@pytest.mark.parametrize("kind,tp,mode", POINTS[:4], ids=IDS[:4])
def test_row_steps_match_jax_row_programs(world, kind, tp, mode):
    """Row mode's batched decode step and verify step (T = 4), monolithic
    and through the overlap twins (their composition), at B = 3 and 4,
    plain and q80 hops, tp 2 and 4, against the JAX package's
    ``make_tp_forward_batched(overlap=, tp_reduce=)`` and
    ``make_tp_verify_batched`` on the same params and cache: most rows
    within 1e-5·max|logit|, every row within the cross-order tolerance
    (:func:`check_steps_against_jax`)."""
    check_steps_against_jax(world, kind, tp, mode)


@pytest.mark.parametrize("kind,tp,mode", POINTS, ids=IDS)
def test_row_streams_match_gather_only(world, kind, tp, mode):
    """Plain hops: every path's greedy stream = the gather-only engine's
    (solo, fused, solo spec, batched, batched spec, the slab and the paged
    session). q80 hops round each hop's payload, so a near tie may flip:
    there the streams are equal run to run and have the same lengths.
    Every rank emits the same tokens."""
    ranks = _run(world, kind, tp, mode)
    got, base = ranks[0], _run(world, kind, tp, "off")[0]
    assert got["resolved"]["tp_reduce_active"] and got["resolved"]["tp_reduce"] == mode
    paths = ("solo", "fused", "spec_solo", "batch", "single", "spec", "slab", "paged")
    for r in ranks[1:]:
        for p in paths:
            assert r[p] == got[p], p
    if mode == "plain":
        for p in paths:
            assert got[p] == base[p], p
        assert got["spec_emitted"] == base["spec_emitted"]
    else:
        assert got["batch_again"] == got["batch"]
        for p in paths:
            assert _lens(got[p]) == _lens(base[p]), p


@pytest.mark.parametrize("kind,tp,mode", POINTS[:3], ids=IDS[:3])
def test_reduce_counter_counts_every_dispatch(world, kind, tp, mode):
    """``dllama_tp_reduce_chunks_total`` counts a dispatch per solo step
    (7 after the prefill's token), one per batched chunk; the overlap's
    counter stays at 0 without ``--tp-overlap``."""
    got = _run(world, kind, tp, mode)[0]
    assert got["solo_counts"]["dllama_tp_reduce_chunks_total"] == STEPS - 1
    assert got["batch_counts"]["dllama_tp_reduce_chunks_total"] == 1
    assert got["counts"]["dllama_tp_overlap_chunks_total"] == 0
    base = _run(world, kind, tp, "off")[0]
    assert base["counts"]["dllama_tp_reduce_chunks_total"] == 0


def test_reduce_fault_seam(world):
    """``tp_reduce:raise`` fires on a row-mode dispatch on every rank alike:
    each raises FaultInjected at that site, nothing hangs, and the next call
    runs the gather-only engine's streams."""
    _, host = _params(SHAPE, "q40")
    ranks = world.run(R.seam_case, host, TConfig(**SHAPE), "tp_reduce", PROMPTS, size=2)
    base = world.run(R.batch_case, host, TConfig(**SHAPE), PROMPTS, 4, size=2)[0]
    for r in ranks:
        assert r["raised"] == "tp_reduce" and r["after"] == base


@pytest.mark.parametrize("kind,tp,mode", POINTS, ids=IDS)
def test_bytes_a_token_equal_jax_count(world, kind, tp, mode):
    """The bytes a decode token sent = the JAX engine's ``_wire_bytes(1)``
    under the same modes, plus the port's scalar sums' difference: each of
    the 2L + 1 sums is an all-gather of (tp - 1) f32 scalars, where the
    analytic count has (tp - 1) / tp (``generate.wire_bytes_per_row``);
    strictly fewer bytes than the gather-only engine's."""
    qp, _ = _params(SHAPE, kind)
    jcfg, cfg = JConfig(**SHAPE), TConfig(**SHAPE)
    jax_bytes = JEngine(jcfg, qp, JSampler(temperature=0.0), mesh=tp_mesh(tp), metrics=None,
                        tp_reduce=mode)._wire_bytes(1)
    extra = (2 * cfg.n_layers + 1) * 4.0 * ((tp - 1) - (tp - 1) / tp)
    model = tg.wire_bytes_per_row(cfg, kind, tp, 4.0, mode)
    assert model == pytest.approx(jax_bytes + extra, rel=1e-12)
    ranks = _run(world, kind, tp, mode)
    for r in ranks:
        for kb in r["sent_kb"][1:]:
            assert kb * 1024 == pytest.approx(model, rel=1e-12)
    gather_only = _run(world, kind, tp, "off")[0]["sent_kb"][1]
    assert ranks[0]["sent_kb"][1] < gather_only


# -- what declines, with JAX's reasons ------------------------------------------------

def _port_reasons(world, shape: dict, kind: str, tp, mode: str) -> dict:
    """The port engine's resolution (``tp`` None: one device, in process)."""
    _, host = _params(shape, kind)
    cfg = TConfig(**shape)
    if tp is None:
        eng = R.engine(None, host, cfg, tp_reduce=mode)
        return {a: getattr(eng, a) for a in ("tp_reduce", "tp_reduce_active", "tp_reduce_reason")}
    return {k: v for k, v in world.run(R.resolve_case, host, cfg, mode, False, size=tp)[0]
            .items() if k.startswith("tp_reduce")}


def _jax_reasons(shape: dict, kind: str, tp, mode: str) -> dict:
    qp, _ = _params(shape, kind)
    eng = JEngine(JConfig(**shape), qp, JSampler(temperature=0.0), metrics=None,
                  mesh=None if tp is None else tp_mesh(tp), tp_reduce=mode)
    return {a: getattr(eng, a) for a in ("tp_reduce", "tp_reduce_active", "tp_reduce_reason")}


@pytest.mark.parametrize("case", ["not_requested", "no_tp", "granularity", "moe"])
def test_declined_cases_give_jax_reasons(world, case):
    """Not requested, no tensor parallelism, a Q40 wo chunk of 32 rows at tp
    4 (half a superblock), a MoE model: the port resolves each as the JAX
    engine does, reason word for word; a declined engine still decodes
    (the granularity case: the gather-only streams)."""
    shape, kind, tp, mode = {
        "not_requested": (SMALL, "q40", 2, "off"), "no_tp": (SMALL, "q40", None, "plain"),
        "granularity": (SMALL, "q40", 4, "plain"), "moe": (MIXTRAL, "q40", 2, "plain"),
    }[case]
    got = _port_reasons(world, shape, kind, tp, mode)
    assert got == _jax_reasons(shape, kind, tp, mode)
    if case == "granularity":
        _, host = _params(shape, kind)
        ran = world.run(R.resolve_case, host, TConfig(**shape), mode, False, PROMPTS, size=4)
        want = world.run(R.batch_case, host, TConfig(**shape), PROMPTS, 4, size=4)
        assert [r["batch"] for r in ran] == want
    assert tq.validate_tp_reduce(TConfig(**shape), kind, tp or 1) == \
        jq.validate_tp_reduce(JConfig(**shape), kind, tp or 1)


def test_bad_mode_raises():
    _, host = _params(SMALL, "q40")
    with pytest.raises(ValueError, match="tp_reduce"):
        R.engine(None, host, TConfig(**SMALL), tp_reduce="zstd")
    with pytest.raises(ValueError, match="tp_reduce"):
        tl._check_tp_reduce(TConfig(**SMALL), "zstd")
    with pytest.raises(ValueError, match="dense FFN"):
        tl._check_tp_reduce(TConfig(**MIXTRAL), "plain")


def test_check_shards_knows_row_shards():
    """A row-mode engine takes row shards (wo [dim / tp, dim]) and refuses
    output shards, and the gather-only engine the other way round."""
    _, host = _params(SHAPE, "q40")
    cfg = TConfig(**SHAPE)
    rows = tq.shard_params(host, cfg, 1, 2, tp_reduce=True)
    outs = tq.shard_params(host, cfg, 1, 2)
    assert (rows["layers"]["wo"].in_features, rows["layers"]["wo"].out_features) == (128, 256)
    tq.check_shards(rows, cfg, 2, tp_reduce=True)
    tq.check_shards(outs, cfg, 2)
    with pytest.raises(ValueError, match="row shard"):
        tq.check_shards(outs, cfg, 2, tp_reduce=True)
    with pytest.raises(ValueError, match="output columns"):
        tq.check_shards(rows, cfg, 2)
