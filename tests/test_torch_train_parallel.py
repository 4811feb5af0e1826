"""The port's training over a mesh against the JAX package, on the CPU: the
mirror of ``tests/test_train.py:42`` and ``:62``, ``test_ring_attention.py``
and ``test_pipeline.py``, and of ``__graft_entry__.py``'s dp x ep x tp
step.

The JAX side runs on conftest's 8 virtual CPU devices; the port side on one
gloo world of 4 processes started for the module (``LocalWorld``), its rank
cases in ``tests/torch_train_ranks.py``, each mesh made by
``group.make_mesh`` (a one-axis mesh of 2 ranks on the world's first two).

* ``make_mesh`` puts world rank r at ``np.unravel_index(r, sizes)``, JAX's
  device order, and its groups hold the ranks of each line; ``make_grid``
  (ep 2 and 4) is the ``tp`` line of JAX's ``ep x tp`` mesh, and an
  all-reduce on its process group sums that line's ranks.
* Ring attention at sp 2 and 4, causal and not: outputs within 1e-5 of
  JAX's ``ring_self_attention``, gradients of ``sum(out**2)`` within 1e-4
  of JAX's.
* A tp 4 and a dp 2 x tp 2 SGD step against JAX's unsharded step: loss
  within 1e-5, every parameter within 1e-4. dp 2 x sp 2 and sp 2 x tp 2
  (ring attention inside the model): loss and every gradient within 1e-4
  of JAX's dense ``lm_loss`` (test_train.py:62).
* The pipeline at pp 1, 2, 4 with (pp, microbatches) (2, 2), (2, 4), (4,
  4), (1, 2): logits within 2e-5 of JAX's ``forward_train``, the
  gradients of ``mean(logits**2)`` within 2e-4 (at (4, 4)), remat within
  1e-6 of the plain schedule, and JAX's ``ValueError``s for the
  divisibility constraints.
* An ep 2 x tp 2 Mixtral SGD step against JAX's one-device step (1e-5 loss,
  1e-4 leaves).
* After a dp 2 x tp 2 Adam step every rank's copy of a replicated leaf (and
  the dp replicas' shards) are the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.ops.ring_attention import ring_self_attention
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime import train as jt
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.parallel import sharding
from dllama_tpu_torch.parallel.group import LocalWorld
from dllama_tpu_torch.parallel.pipeline import pipeline_forward_train
from tests import torch_train_ranks as R
from tests.torch_train_ranks import assemble
from tests.torch_ports import store_address

#: test_train.py:42's shape (a vocab of 128 shards its classifier at tp 4)
WIDE = dict(arch="llama", dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=8,
            vocab_size=128, seq_len=64, head_size=16, kv_dim=128, dtype="float32")
#: test_pipeline.py's and test_train.py:62's shape (tests/test_llama_forward.tiny_cfg)
TINY = dict(arch="llama", dim=64, hidden_dim=96, n_layers=4, n_heads=4, n_kv_heads=2,
            vocab_size=128, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
#: __graft_entry__.py:140's MoE shape
MOE = dict(arch="mixtral", dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=8,
           vocab_size=256, seq_len=64, head_size=16, kv_dim=128, n_experts=4,
           n_active_experts=2, rope_style="half", dtype="float32")


@pytest.fixture(scope="module")
def world():
    with LocalWorld(4, threads=1, timeout_s=180, init_method=store_address()) as w:
        yield w


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(shape: dict, seed: int):
    """(JAX cfg, JAX f32 params, port cfg, host params) of a shape."""
    key = (tuple(shape.items()), seed)
    if key not in _PARAMS:
        jc = JConfig(**shape)
        p = jl.random_params(jc, seed=seed, dtype=np.float32)
        host = {k: np.asarray(v) for k, v in p.items() if k != "layers"}
        host["layers"] = {k: np.asarray(v) for k, v in p["layers"].items()}
        _PARAMS[key] = (jc, jax.tree.map(jnp.asarray, p), TConfig(**shape), host)
    return _PARAMS[key]


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2}, {"dp": 2, "sp": 2}, {"ep": 2, "tp": 2},
                                  {"pp": 4}, {"sp": 4}])
def test_mesh_positions_follow_jax_device_order(world, axes):
    got = world.run(R.position, axes)
    mesh = make_mesh(axes, jax.devices()[:4])
    for r, pos in enumerate(got):
        where = np.argwhere(mesh.device_ids == r)[0]
        assert {a: pos[a][0] for a in axes} == dict(zip(axes, map(int, where)))
        assert all(pos[a][1] == n for a, n in axes.items())


@pytest.mark.parametrize("ep", [2, 4])
def test_make_grid_is_the_tp_line_of_the_jax_ep_tp_mesh(world, ep):
    got = world.run(R.grid_case, ep)
    ids = make_mesh({"ep": ep, "tp": 4 // ep}, jax.devices()[:4]).device_ids
    for r, g in enumerate(got):
        e, t = map(int, np.argwhere(ids == r)[0])
        assert g["ep"] == (e, ep) and g["tp"] == (t, 4 // ep)
        assert g["line"] == [int(i) for i in ids[e]]
        assert g["line_sum"] == sum(g["line"])


# -- ring attention -----------------------------------------------------------

def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))


@pytest.mark.parametrize("n_sp,causal", [(2, True), (4, True), (4, False)])
def test_ring_attention_and_gradients_match_jax(world, n_sp, causal):
    q, k, v = _qkv(2, 32, 8, 4, 16, seed=n_sp)
    jmesh = make_mesh({"sp": n_sp})

    def loss(q, k, v):
        return (ring_self_attention(q, k, v, jmesh, causal=causal) ** 2).sum()

    args = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(jax.jit(lambda *a: ring_self_attention(*a, jmesh, causal=causal))(*args))
    wgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    ranks = world.run(R.ring_case, {"sp": n_sp}, q, k, v, causal, size=n_sp)
    ranks.sort(key=lambda r: r["sp"])
    np.testing.assert_allclose(np.concatenate([r["out"] for r in ranks], axis=1), want,
                               atol=1e-5, rtol=1e-5)
    for i, wg in enumerate(wgrads):
        got = np.concatenate([r["grads"][i] for r in ranks], axis=1)
        np.testing.assert_allclose(got, np.asarray(wg), atol=1e-4, rtol=1e-4)


# -- tp, dp, sp steps -----------------------------------------------------------

def _jax_sgd(jc, jp, batches, lr=1e-2):
    opt = optax.sgd(lr)
    step = jax.jit(jt.make_train_step(jc, opt))
    state, losses = opt.init(jp), []
    for b in batches:
        jp, state, loss = step(jp, state, jnp.asarray(b))
        losses.append(float(loss))
    return losses, _flat(jp)


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 2}])
def test_sharded_sgd_step_matches_unsharded_jax(world, axes):
    jc, jp, tc, host = _params(WIDE, 4)
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 12)).astype(np.int32)
    losses, want = _jax_sgd(jc, jp, [tok])
    ranks = world.run(R.step_case, axes, host, tc, [tok], {"kind": "SGD", "lr": 1e-2})
    for r in ranks:
        assert abs(r["losses"][0] - losses[0]) < 1e-5
    got = assemble(tc, ranks, "params")
    for k, w in want.items():
        assert np.abs(got[k] - w).max() < 1e-4, k


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2}, {"sp": 2, "tp": 2}])
def test_seq_parallel_ring_loss_and_gradients_match_dense_jax(world, axes):
    jc, jp, tc, host = _params(TINY, 7)
    tok = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    loss, grads = jax.value_and_grad(lambda p: jt.lm_loss(jc, p, jnp.asarray(tok)))(jp)
    ranks = world.run(R.loss_case, axes, host, tc, tok)
    for r in ranks:
        assert abs(r["loss"] - float(loss)) < 1e-4
    got = assemble(tc, ranks, "grads")  # dp x sp: every rank holds them whole
    for k, w in _flat(grads).items():
        assert np.abs(got[k] - w).max() < 1e-4, k
    if "dp" in axes:
        for r in ranks:
            for k, g in r["grads"].items():
                assert np.array_equal(g, ranks[0]["grads"][k]), k


def test_ep_grid_mixtral_step_matches_one_device_jax(world):
    jc, jp, tc, host = _params(MOE, 1)
    tok = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    losses, want = _jax_sgd(jc, jp, [tok])
    ranks = world.run(R.step_case, {"ep": 2, "tp": 2}, host, tc, [tok],
                      {"kind": "SGD", "lr": 1e-2})
    assert [r["position"]["ep"][0] for r in ranks] == [0, 0, 1, 1]
    for r in ranks:
        assert abs(r["losses"][0] - losses[0]) < 1e-5
    got = assemble(tc, ranks, "params")
    for k, w in want.items():
        assert np.abs(got[k] - w).max() < 1e-4, k


def test_replicated_leaves_are_the_same_bits_on_every_rank(world):
    _, _, tc, host = _params(WIDE, 4)
    batches = [np.random.default_rng(s).integers(0, tc.vocab_size, (4, 12)).astype(np.int32)
               for s in range(2)]
    ranks = world.run(R.step_case, {"dp": 2, "tp": 2}, host, tc, batches,
                      {"kind": "Adam", "lr": 1e-3})
    specs = sharding.mesh_specs(tc, type("At", (), {"size": lambda self, *a: 2 if "tp" in a
                                                    else 1})())
    flat = {k: specs[k] for k in ("embedding", "rms_final", "wcls")}
    flat.update({f"layers/{n}": s for n, s in specs["layers"].items()})
    assert len({tuple(r["losses"]) for r in ranks}) == 1
    for k, spec in flat.items():
        if not any(spec):  # replicated everywhere
            assert all(np.array_equal(r["params"][k], ranks[0]["params"][k]) for r in ranks), k
        # dp replicas of one tp shard: world ranks t and 2 + t
        for t in range(2):
            assert np.array_equal(ranks[t]["params"][k], ranks[2 + t]["params"][k]), k


# -- the pipeline --------------------------------------------------------------

def _pipe_setup():
    jc, jp, tc, host = _params(TINY, 11)
    tok = np.random.default_rng(5).integers(0, tc.vocab_size, (4, 8)).astype(np.int32)
    return jc, jp, tc, host, tok


@pytest.mark.parametrize("pp,microbatches", [(2, 2), (2, 4), (4, 4), (1, 2)])
def test_pipeline_matches_dense_forward(world, pp, microbatches):
    jc, jp, tc, host, tok = _pipe_setup()
    dense = np.asarray(jl.forward_train(jc, jp, jnp.asarray(tok)))
    if pp == 1:
        ranks = [R.pipeline_case(None, {}, host, tc, tok, microbatches, False)]
    else:
        ranks = world.run(R.pipeline_case, {"pp": pp}, host, tc, tok, microbatches, False,
                          size=pp)
    for r in ranks:
        np.testing.assert_allclose(r["logits"], dense, rtol=2e-5, atol=2e-5)
    if (pp, microbatches) == (4, 4):  # test_pipeline.py:44's gradient case
        grads = jax.grad(lambda p: (jl.forward_train(jc, p, jnp.asarray(tok)) ** 2).mean())(jp)
        got = assemble(tc, ranks, "grads")
        for k, w in _flat(grads).items():
            assert np.abs(got[k] - w).max() < 2e-4, k


def test_dp_by_pp_pipeline_matches_dense(world):
    """__graft_entry__.py's dp x pp step: each dp row pipelines its half of
    the batch; the gradients of ``mean(logits**2)`` summed over dp (and the
    embedding's over pp) are the dense ones."""
    jc, jp, tc, host, tok = _pipe_setup()
    dense = np.asarray(jl.forward_train(jc, jp, jnp.asarray(tok)))
    grads = jax.grad(lambda p: (jl.forward_train(jc, p, jnp.asarray(tok)) ** 2).mean())(jp)
    ranks = world.run(R.pipeline_case, {"dp": 2, "pp": 2}, host, tc, tok, 2, False)
    halves = {r["position"]["dp"][0]: r["logits"] for r in ranks}
    np.testing.assert_allclose(np.concatenate([halves[0], halves[1]]), dense, rtol=2e-5,
                               atol=2e-5)
    got = assemble(tc, ranks, "grads")
    for k, w in _flat(grads).items():
        # each dp row's loss is the mean over its own half: the sum over dp
        # is twice the whole batch's mean's gradient
        assert np.abs(got[k] / 2 - w).max() < 2e-4, k


def test_pipeline_remat_matches(world):
    _, _, tc, host, tok = _pipe_setup()
    a = world.run(R.pipeline_case, {"pp": 2}, host, tc, tok, 2, False, size=2)
    b = world.run(R.pipeline_case, {"pp": 2}, host, tc, tok, 2, True, size=2)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["logits"], y["logits"], rtol=1e-6, atol=1e-6)
        for k in x["grads"]:
            np.testing.assert_allclose(x["grads"][k], y["grads"][k], rtol=1e-6, atol=1e-6)


def test_pipeline_rejects_bad_divisibility():
    _, _, tc, host, tok = _pipe_setup()
    params = R._tensors(host, tc, None, "cpu")

    class Four:  # pp = 4 for the checks, which run before any collective
        sizes = {"pp": 4}

        def size(self, *axes):
            return 4 if axes == ("pp",) else 1

        def index(self, axis):
            return 0

        def group(self, *axes):
            return None

    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward_train(tc, params, torch.from_numpy(tok[:3]), Four(), n_microbatches=2)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_forward_train(TConfig(**dict(TINY, n_layers=3)), params,
                               torch.from_numpy(tok), Four(), n_microbatches=2)
