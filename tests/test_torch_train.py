"""The port's training step (``models.llama.forward_train``,
``runtime.train``) against the JAX package on one device, on the CPU: the
mirror of ``tests/test_train.py``'s one-device cases.

Both packages take the same numpy-seeded f32 params (JAX
``random_params``, carried over by ``convert_params.from_jax_params``) and
tokens.

* ``forward_train`` equals JAX's (dense Llama, Mixtral and Grok-1; atol
  2e-5, rtol 1e-4) and the port's own incremental ``forward`` within JAX's
  batched-against-incremental tolerance (atol 2e-4, rtol 2e-3).
* ``lm_loss`` and every gradient leaf equal ``jax.value_and_grad``'s (loss
  within 1e-5, each leaf within 1e-4 of it).
* SGD steps equal ``optax.sgd``'s (1e-5 of the leaves). Adam is compared
  apart from the gradients (at step 1 it moves each element by about
  lr·sign(g), so an element near 0 whose sign parts between XLA's and
  ATen's sums would move 2·lr apart): ``torch.optim.Adam``/``AdamW``
  under ``LambdaLR`` of the ported ``warmup_cosine_decay_schedule`` and
  optax's ``adam``/``adamw`` with that schedule, fed the same numpy
  gradients for 5 steps, agree within f32 rounding (every hyperparameter
  passed: torch's AdamW decays by 1e-2 by default, optax's by 1e-4).
* The loss falls over 5 Adam steps; ``device_random_params`` has
  ``random_params``' leaves, shapes and dtypes (and JAX's
  ``device_random_params``').
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import train as jt
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import GROK_EMBEDDING_SCALE, GROK_LOGIT_SCALE
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import train as tt

LLAMA = dict(arch="llama", dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=128, seq_len=32, head_size=16, kv_dim=32, dtype="float32")
MIXTRAL = dict(LLAMA, arch="mixtral", n_experts=4, n_active_experts=2, rope_style="half")
GROK = dict(MIXTRAL, arch="grok1", hidden_act="gelu", embedding_scale=GROK_EMBEDDING_SCALE,
            logit_scale=GROK_LOGIT_SCALE, post_norms=True)
SHAPES = {"llama": LLAMA, "mixtral": MIXTRAL, "grok1": GROK}
ARCHS = list(SHAPES)


def _pair(arch: str, seed: int = 3):
    """(JAX cfg, JAX params, port cfg, port params needing grad)."""
    jc, tc = JConfig(**SHAPES[arch]), TConfig(**SHAPES[arch])
    jp = jax.tree.map(jnp.asarray, jl.random_params(jc, seed=seed, dtype=np.float32))
    tp = tt.trainable(from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu"))
    return jc, jp, tc, tp


def _tokens(vocab: int, shape=(2, 12), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _flat(tree) -> dict:
    """A JAX params tree as {leaf path: numpy}, the port's leaf paths."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    jc, jp, tc, tp = _pair(arch)
    tok = _tokens(tc.vocab_size)
    want = np.asarray(jl.forward_train(jc, jp, jnp.asarray(tok)))
    with torch.no_grad():
        got = tl.forward_train(tc, tp, torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (2, 12, tc.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_incremental_forward(arch):
    """Cache-free batched forward == the port's cached forward (JAX
    ``test_train.py:26``'s tolerance)."""
    _, _, tc, tp = _pair(arch, seed=2)
    toks = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)
    with torch.no_grad():
        batched = tl.forward_train(tc, tp, torch.from_numpy(toks))[0].numpy()
        inc, _ = tl.forward(tc, tp, tl.rope_tables(tc, "cpu"), torch.from_numpy(toks[0]),
                            tl.init_cache(tc, device="cpu"), 0)
    np.testing.assert_allclose(batched, inc.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jc, jp, tc, tp = _pair(arch)
    tok = _tokens(tc.vocab_size, (2, 16), seed=1)
    j_loss, j_grads = jax.value_and_grad(lambda p: jt.lm_loss(jc, p, jnp.asarray(tok)))(jp)
    loss = tt.lm_loss(tc, tp, torch.from_numpy(tok))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) < 1e-5
    want = _flat(j_grads)
    got = {k: v.grad.numpy() for k, v in tt.leaf_items(tp)}
    assert set(got) == set(want)
    for k, g in got.items():
        assert g.shape == want[k].shape
        assert np.abs(g - want[k]).max() < 1e-4, k


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
def test_sgd_steps_match_optax(arch):
    jc, jp, tc, tp = _pair(arch, seed=4)
    batches = [_tokens(tc.vocab_size, (4, 12), seed=s) for s in range(3)]
    opt = optax.sgd(1e-2)
    jstep = jax.jit(jt.make_train_step(jc, opt))
    state = opt.init(jp)
    sgd = torch.optim.SGD(tt.leaves(tp), lr=1e-2, momentum=0.0)
    step = tt.make_train_step(tc)
    for b in batches:
        jp, state, j_loss = jstep(jp, state, jnp.asarray(b))
        loss = step(tp, sgd, torch.from_numpy(b))
        assert abs(float(loss) - float(j_loss)) < 1e-5
    want = _flat(jp)
    for k, v in tt.leaf_items(tp):
        assert np.abs(v.detach().numpy() - want[k]).max() < 1e-5, k


def _fed_run(grads: list, init: np.ndarray, torch_opt, optax_opt) -> tuple:
    """Both optimisers stepped on the same numpy gradients: (torch's
    params, optax's params) after each step."""
    p_t = torch.from_numpy(init.copy()).requires_grad_(True)
    opt, sched = torch_opt(p_t)
    p_j = jnp.asarray(init)
    state = optax_opt.init(p_j)
    out = []
    for g in grads:
        p_t.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        upd, state = optax_opt.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        out.append((p_t.detach().numpy().copy(), np.asarray(p_j)))
    return out


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_and_schedule_match_optax_on_fed_gradients(kind):
    rng = np.random.default_rng(7)
    init = rng.standard_normal((64, 48)).astype(np.float32)
    grads = [(rng.standard_normal((64, 48)) * 0.1).astype(np.float32) for _ in range(5)]
    sched = tt.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 5, 3e-4)
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 5, 3e-4)
    for c in range(8):
        assert abs(sched(c) - float(jsched(c))) <= 1e-7 * 3e-3
    if kind == "adam":
        def make(p):
            o = torch.optim.Adam([p], lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
            return o, torch.optim.lr_scheduler.LambdaLR(o, sched)
        ref = optax.adam(jsched, b1=0.9, b2=0.999, eps=1e-8)
    else:
        def make(p):
            o = torch.optim.AdamW([p], lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
            return o, torch.optim.lr_scheduler.LambdaLR(o, sched)
        ref = optax.adamw(jsched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    for got, want in _fed_run(grads, init, make, ref):
        # f32 rounding: of each parameter (rtol) and of each step's update,
        # at most ~lr = 3e-3 an element, whose few ops (moments, bias
        # corrections, sqrt, the division near eps) round in another order
        # (atol: 1e-7 over 5 steps, ~7e-6 of one step's lr)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_loss_falls_over_five_adam_steps():
    _, _, tc, tp = _pair("llama", seed=0)
    tok = torch.from_numpy(_tokens(tc.vocab_size, (2, 16)))
    with torch.no_grad():
        l0 = float(tt.lm_loss(tc, tp, tok))
    adam = torch.optim.Adam(tt.leaves(tp), lr=1e-3)
    step = tt.make_train_step(tc)
    losses = [float(step(tp, adam, tok)) for _ in range(5)]
    with torch.no_grad():
        last = float(tt.lm_loss(tc, tp, tok))
    assert losses[0] == pytest.approx(l0, abs=1e-6)
    assert last < l0 and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["llama", "grok1"])
def test_device_random_params_layout(arch):
    tc = TConfig(**SHAPES[arch])
    got = tl.device_random_params(tc, seed=1, device="cpu")
    want = tl.random_params(tc, seed=1, device="cpu")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in tt.leaf_items(got)}
    assert shapes == {k: (tuple(v.shape), v.dtype) for k, v in tt.leaf_items(want)}
    for k, v in tt.leaf_items(got):
        if k.startswith("layers/rms") or k == "rms_final":
            assert torch.equal(v, torch.ones_like(v))
        else:
            assert 0.015 < float(v.float().std()) < 0.025, k
    again = tl.device_random_params(tc, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tt.leaves(got), tt.leaves(again)))
    # bf16 matrices, f32 embedding, norms and router: JAX's layout
    bf = tl.device_random_params(TConfig(**dict(SHAPES[arch], dtype="bfloat16")), device="cpu")
    jbf = jl.device_random_params(JConfig(**dict(SHAPES[arch], dtype="bfloat16")))
    jflat = _flat(jbf)
    for k, v in tt.leaf_items(bf):
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[1] == str(jflat[k].dtype), k


def test_training_entry_points_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dllama_tpu_torch import train_tiny_e2e

    tc = TConfig(**LLAMA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.device_random_params(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tiny_e2e.main([str(tmp_path), "--steps", "51", "--no-cli"])
    assert not (tmp_path / "tiny.m").exists()
