"""The port's microbatch compute/communication overlap (``--tp-overlap``)
against the JAX package's, on the CPU: the mirror of
``tests/test_tp_overlap.py``.

The overlap cuts a batched decode or verify step's rows into two
microbatches whose layers run interleaved (``collectives.interleave``):
each half's gathers and reduce hops are issued as asynchronous
``torch.distributed`` work and waited on after the other half has issued
its own. Every op is per row and the halves' K4/K5 launches take their rows
of the one cache in place (``row0``), so a half's rows are the monolithic
step's rows wherever the matmuls sum in the same order at h rows as at B.
On the CPU they do when each half has two or more rows: the logits of a
B = 4 step are bit-equal to the monolithic step's. At B = 3 a half has one
row, where the CPU's matmul takes its one-row path and sums in another
order; an activation an ulp away can then round to another bf16 value in
the kernels' plain versions, so the logits agree within the port's
cross-order tolerance, 5e-3·max|logit| (measured: 4.7e-4). The greedy
streams are equal either way. One gloo world of
4 processes serves the module; rank cases in ``tests/torch_tp_ranks.py``.
"""

import jax
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.parallel.mesh import tp_mesh
from dllama_tpu.runtime.generate import Engine as JEngine
from dllama_tpu.runtime.sampler import SamplerConfig as JSampler
from dllama_tpu_torch import faults
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.ops import flash_decode, fused_rope_cache
from dllama_tpu_torch.parallel.group import LocalWorld
from dllama_tpu_torch.runtime.generate import resolve_tp_modes
from tests import torch_tp_control as ctl
from tests import torch_tp_ranks as R
from tests.test_torch_tp_chat import _chat, _replies, _transcript
from tests.test_torch_tp_reduce import check_steps_against_jax
from tests.torch_ports import port_block, store_address

SHAPE = dict(arch="llama", dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=4,
             vocab_size=512, seq_len=64, head_size=32, kv_dim=128, dtype="float32")
MIXTRAL = dict(SHAPE, arch="mixtral", n_experts=4, n_active_experts=2, rope_style="half")
PROMPT = [3, 7, 11]
#: an odd batch: the halves are uneven (1 + 2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
#: halves of two rows each
PROMPTS4 = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 3]]
STEPS = 8


@pytest.fixture(scope="module")
def world():
    with LocalWorld(4, threads=1, timeout_s=180, init_method=store_address()) as w:
        yield w


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}
_RUNS: dict = {}


def _params(shape: dict, kind: str = "q40"):
    key = (tuple(sorted(shape.items())), kind)
    if key not in _PARAMS:
        qp = jl.quantize_params(jl.random_params(JConfig(**shape), seed=0, dtype=np.float32),
                                kind)
        _PARAMS[key] = (qp, R.host_params(jax.tree.map(np.asarray, qp)))
    return _PARAMS[key]


def _run(world, tp: int, overlap: bool, compress: bool = False, mode: str = "off",
         prompts: tuple = tuple(map(tuple, PROMPTS)), paths: bool = True) -> list:
    """Every rank's ``modes_case`` of one point (cached per point)."""
    key = (tp, overlap, compress, mode, prompts, paths)
    if key not in _RUNS:
        _, host = _params(SHAPE)
        _RUNS[key] = world.run(R.modes_case, host, TConfig(**SHAPE), compress, mode, overlap,
                               PROMPT, [list(p) for p in prompts], STEPS, paths, size=tp)
    return _RUNS[key]


PATHS = ("solo", "fused", "spec_solo", "batch", "single", "spec", "slab", "paged")


def _close(got, want, frac, what):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and err <= frac * scale, (what, err, frac * scale)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "q80"])
@pytest.mark.parametrize("tp", [2, 4])
def test_overlap_decode_and_verify_match_monolithic(world, tp, compress):
    """One batched decode step and one verify step (T = 4) through the
    overlap forwards against the monolithic forwards on the same engine:
    bit-equal at B = 4 (halves of two rows), within 5e-3·max|logit| at B
    = 3 (see the module's docstring); both wires, tp 2 and 4; every rank
    the same bits."""
    even = _run(world, tp, True, compress, prompts=tuple(map(tuple, PROMPTS4)), paths=False)
    for r in even:
        np.testing.assert_array_equal(r["step_ov"], r["step"])
        np.testing.assert_array_equal(r["verify_ov"], r["verify"])
        np.testing.assert_array_equal(r["step_ov"], even[0]["step_ov"])
    odd = _run(world, tp, True, compress)[0]
    _close(odd["step_ov"], odd["step"], 5e-3, "decode B = 3")
    _close(odd["verify_ov"], odd["verify"], 5e-3, "verify B = 3")


@pytest.mark.parametrize("kind,tp", [("q40", 2), ("q80", 4)])
def test_overlap_steps_match_jax_overlap_programs(world, kind, tp):
    """The gather-only overlap twins' batched decode and verify steps (T =
    4) at B = 3 and 4, and the monolithic steps beside them, against the
    JAX package's ``make_tp_forward_batched`` and ``make_tp_verify_batched``
    with and without ``overlap`` on the same params and cache: most rows
    within 1e-5·max|logit|, every row within the cross-order tolerance
    (``test_torch_tp_reduce.check_steps_against_jax``)."""
    check_steps_against_jax(world, kind, tp, "off")


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "q80"])
@pytest.mark.parametrize("tp", [2, 4])
def test_overlap_streams_equal_monolithic(world, tp, compress):
    """Every path's greedy stream under ``tp_overlap`` = the engine's
    without it (batched decode and verify take the overlap at B = 3; the
    solo paths, which have no second row, and the single-row batch take the
    monolithic step), the slab and paged sessions included."""
    got = _run(world, tp, True, compress)
    want = _run(world, tp, False, compress)[0]
    assert got[0]["resolved"]["tp_overlap_active"]
    assert got[0]["resolved"]["tp_wire"] == ("q80" if compress else "plain")
    for r in got:
        for p in PATHS:
            assert r[p] == want[p], p
    assert got[0]["spec_emitted"] == want["spec_emitted"]


def test_overlap_counter_and_single_row_fallback(world):
    """Two or more live rows engage the overlap (the counter moves once per
    batched chunk); one row takes the monolithic step (the counter stays);
    solo calls never engage it."""
    got = _run(world, 2, True)[0]
    assert got["batch_counts"]["dllama_tp_overlap_chunks_total"] == 1
    assert got["single_counts"]["dllama_tp_overlap_chunks_total"] == 0
    assert got["solo_counts"]["dllama_tp_overlap_chunks_total"] == 0
    assert got["counts"]["dllama_tp_overlap_chunks_total"] > 2  # verify steps, sessions
    assert _run(world, 2, False)[0]["counts"]["dllama_tp_overlap_chunks_total"] == 0


def test_overlap_split_fault_seam(world):
    """``overlap_split:raise`` fires on an engaged dispatch on every rank
    alike: each raises at that site, and the next call streams as before."""
    _, host = _params(SHAPE)
    ranks = world.run(R.seam_case, host, TConfig(**SHAPE), "overlap_split", PROMPTS, size=2)
    base = world.run(R.batch_case, host, TConfig(**SHAPE), PROMPTS, 4, size=2)[0]
    for r in ranks:
        assert r["raised"] == "overlap_split" and r["after"] == base


@pytest.mark.parametrize("tp", [2, 4])
def test_overlap_composes_with_tp_reduce(world, tp):
    """``--tp-overlap`` with ``--tp-reduce plain``: each half runs the row
    programs; every path's stream = the gather-only monolithic engine's, and
    both counters move."""
    got = _run(world, tp, True, mode="plain")
    want = _run(world, tp, False)[0]
    assert got[0]["resolved"]["tp_overlap_active"] and got[0]["resolved"]["tp_reduce_active"]
    for r in got:
        for p in PATHS:
            assert r[p] == want[p], p
    assert got[0]["batch_counts"] == {"dllama_tp_overlap_chunks_total": 1,
                                      "dllama_tp_reduce_chunks_total": 1}
    np.testing.assert_array_equal(got[0]["step_ov"], got[0]["step"])


def test_overlap_rejects_bad_splits():
    """The split check refuses what cannot be exact, in JAX's words."""
    cfg, moe = TConfig(**SHAPE), TConfig(**MIXTRAL)
    with pytest.raises(ValueError, match="batch >= 2"):
        tl._check_overlap_split(cfg, 1)
    with pytest.raises(ValueError, match="selected-experts union"):
        tl._check_overlap_split(moe, 4)
    assert tl._check_overlap_split(cfg, 3) == 1
    for b, want in ((1, "batch >= 2"), (4, "selected-experts")):
        c = moe if b == 4 else cfg
        with pytest.raises(ValueError, match=want):
            jl._check_overlap_split(JConfig(**(MIXTRAL if b == 4 else SHAPE)), b)
        with pytest.raises(ValueError, match=want):
            tl._check_overlap_split(c, b)


@pytest.mark.parametrize("case", ["not_requested", "no_tp", "moe", "on"])
def test_overlap_resolution_gives_jax_reasons(world, case):
    """The port resolves ``tp_overlap`` as the JAX engine: not requested, no
    tensor parallelism, a MoE model (warned and dropped: the monolithic
    programs run), on; the resolution is the pure ``resolve_tp_modes``."""
    shape, tp, flag = {"not_requested": (SHAPE, 2, False), "no_tp": (SHAPE, None, True),
                       "moe": (MIXTRAL, 2, True), "on": (SHAPE, 2, True)}[case]
    qp, host = _params(shape)
    cfg = TConfig(**shape)
    if tp is None:
        eng = R.engine(None, host, cfg, tp_overlap=flag)
        got = {"tp_overlap_active": eng.tp_overlap_active,
               "tp_overlap_reason": eng.tp_overlap_reason}
    else:
        got = {k: v for k, v in world.run(R.resolve_case, host, cfg, "off", flag, size=tp)[0]
               .items() if k.startswith("tp_overlap")}
    jeng = JEngine(JConfig(**shape), qp, JSampler(temperature=0.0), metrics=None,
                   mesh=None if tp is None else tp_mesh(tp), tp_overlap=flag)
    assert got == {"tp_overlap_active": jeng.tp_overlap_active,
                   "tp_overlap_reason": jeng.tp_overlap_reason}
    modes = resolve_tp_modes(cfg, "q40", tp, flag, "off")
    assert modes["tp_overlap_reason"] == got["tp_overlap_reason"]
    assert bool(modes["warnings"]) == (case == "moe")


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_k4_k5_first_row_plain_versions_equal_slicing(cache_dtype):
    """The K4/K5 launch forms' ``row0``: a launch over rows [h, B) of the
    whole cache (batched and verify) writes the cache and returns the
    output the launch over all rows gives for those rows, bit for bit, and
    leaves the other rows as they were."""
    g = torch.Generator().manual_seed(3)
    L, B, S, kv, H, hd, T = 2, 5, 32, 2, 4, 32, 3
    cos, sin = (torch.rand((S, hd // 2), generator=g) for _ in range(2))
    pos = torch.tensor([3, 9, 0, 17, 30], dtype=torch.int32)

    def caches():
        k = (torch.randn((L, B, S, kv, hd), generator=torch.Generator().manual_seed(4)) * 0.5)
        return k.to(cache_dtype), (k * 0.7).to(cache_dtype)

    q = torch.randn((B, H, hd), generator=g)
    k, v = torch.randn((B, kv, hd), generator=g), torch.randn((B, kv, hd), generator=g)
    for h in (1, 2, 3):
        full_k, full_v = caches()
        qa = fused_rope_cache.rope_cache_update_batched(q, k, v, cos, sin, full_k, full_v, pos, 1)
        fa = flash_decode.flash_decode_attention_batched(qa, full_k, full_v, pos, 1, S)
        part_k, part_v = caches()
        qa0 = fused_rope_cache.rope_cache_update_batched(q[:h], k[:h], v[:h], cos, sin, part_k,
                                                         part_v, pos[:h], 1)
        qa1 = fused_rope_cache.rope_cache_update_batched(q[h:], k[h:], v[h:], cos, sin, part_k,
                                                         part_v, pos[h:], 1, row0=h)
        assert torch.equal(torch.cat([qa0, qa1]), qa)
        assert torch.equal(part_k.float(), full_k.float(), )
        assert torch.equal(part_v.float(), full_v.float())
        fb = flash_decode.flash_decode_attention_batched(qa1, part_k, part_v, pos[h:], 1, S,
                                                         row0=h)
        assert torch.equal(fb, fa[h:])
    qv = torch.randn((B, T, H, hd), generator=g)
    kv_, vv = torch.randn((B, T, kv, hd), generator=g), torch.randn((B, T, kv, hd), generator=g)
    full_k, full_v = caches()
    want = fused_rope_cache.rope_cache_update_verify(qv, kv_, vv, cos, sin, full_k, full_v, pos, 0)
    part_k, part_v = caches()
    got = fused_rope_cache.rope_cache_update_verify(qv[2:], kv_[2:], vv[2:], cos, sin, part_k,
                                                    part_v, pos[2:], 0, row0=2)
    assert torch.equal(got, want[2:])
    untouched_k, _ = caches()
    assert torch.equal(part_k[:, :2].float(), untouched_k[:, :2].float())
    assert torch.equal(part_k[:, 2:].float(), full_k[:, 2:].float())
    with pytest.raises(ValueError, match="outside a cache"):
        fused_rope_cache.rope_cache_update_batched(q[:3], k[:3], v[:3], cos, sin, part_k,
                                                   part_v, pos[:3], 0, row0=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return ctl.write_files(tmp_path_factory.mktemp("tp_overlap_chat"))


@pytest.fixture(scope="module")
def world2():
    """The control plane spans its whole world: a world of 2 of its own."""
    with LocalWorld(2, threads=1, timeout_s=180, init_method=store_address()) as w:
        yield w


def test_server_calls_under_both_modes_through_the_control_plane(world2, files):
    """The server's engine calls (``tests/torch_tp_control.drive``: bucketed
    and paged sessions, chunked admission, a cancel, a faulted admission, an
    abandoned stream, a batch) on rank 0's TPEngine with ``--tp-reduce
    plain --tp-overlap`` at tp 2: the follower replays every op in step,
    and rank 0 sees what one device sees."""
    model, _ = files
    lead, follower = world2.run(ctl.control_case, str(model), "plain", True)
    assert follower["report"]["tail"] == lead["report"]["tail"]
    assert follower["report"]["in_step"] and lead["report"]["in_step"]
    faults.install(ctl.FAULTS)
    try:
        want = ctl.drive(ctl.file_engine(None, str(model)))
    finally:
        faults.clear()
    assert lead["drive"] == want


def test_chat_tp2_with_both_modes_prints_the_one_device_chat(files):
    """``cli chat --tp 2 --tp-reduce plain --tp-overlap`` prints the one-device
    transcript, names both modes on its 🔗 line, and its ranks stay in step."""
    two = _transcript(_chat("dllama_tpu_torch", files, "--device", "cpu", "--tp", "2",
                            "--coordinator", f"127.0.0.1:{port_block(1)}", "--num-hosts", "1",
                            "--host-id", "0", "--tp-reduce", "plain", "--tp-overlap"))
    one = _transcript(_chat("dllama_tpu_torch", files, "--device", "cpu"))
    assert len(_replies(two)) == 2 and _replies(two) == _replies(one)
    assert "microbatch overlap, row-parallel plain reduce" in two
    assert "ranks in step: True" in two
