"""The training step: next-token LM loss, autograd and a ``torch.optim``
update, on one device or over a mesh (the port of
``dllama_tpu/runtime/train.py``).

Parameters are the stacked-leaf dict of ``models.llama`` (dense leaves, the
JAX pytree's layout) with ``requires_grad`` (:func:`trainable`); the
optimiser is any ``torch.optim`` optimiser built over :func:`leaves`. Where
the JAX package hands optax an update, this port hands ``optimizer.step()``
the gradients, so its Adam is torch's (the same formulas, another order of
rounding) and its defaults are torch's: pass every hyperparameter.

On a mesh (``parallel.group.make_mesh``): the loss is the mean over the
whole batch's targets on every rank; a rank computes its block
(``llama.forward_train``) and its part of the sum over targets, divided
by the global count, and the parts are summed over ``sp`` and ``dp``
(``grad_collectives.group_sum``). After the backward pass every leaf's
gradient is summed over ``dp`` and ``sp`` and the embedding's over ``pp``
(:func:`sync_grads`; ``parallel.pipeline``'s callers need the last), on
the pinned-order ring: every replica steps on the same bits. Over ``tp``
and ``ep`` the differentiable collectives leave each shard's gradient
whole already. The pipeline is not a branch of :func:`lm_loss`, as in
the JAX package: ``parallel.pipeline.pipeline_forward_train`` is called
on its own.

:func:`warmup_cosine_decay_schedule` is optax's, for
``torch.optim.lr_scheduler.LambdaLR`` over an optimiser made with lr 1.
"""

from __future__ import annotations

import math

import torch

from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel.grad_collectives import all_reduce, group_sum


def leaf_items(params: dict) -> list:
    """(path, tensor) of every leaf, in one fixed order: the top-level
    leaves, then ``layers/<name>``."""
    out = [(k, v) for k, v in params.items() if k != "layers"]
    return out + [(f"layers/{k}", v) for k, v in params["layers"].items()]


def leaves(params: dict) -> list:
    """Every leaf tensor of ``params`` in :func:`leaf_items` order (what an
    optimiser is built over)."""
    return [v for _, v in leaf_items(params)]


def trainable(params: dict) -> dict:
    """``params`` with every leaf a tensor that requires grad (in place)."""
    for _, v in leaf_items(params):
        v.requires_grad_(True)
    return params


def lm_loss(cfg: ModelConfig, params: dict, tokens, rope: dict = None, grid=None) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens [B, T]: log-softmax in f32
    over the logits of positions 0..T-2 against tokens 1..T-1 (the forward
    sees all T positions and the last one's logits are dropped, as in the
    JAX package). On ``grid`` every rank passes the whole batch and gets the
    whole batch's loss: an ``sp`` chunk's targets run one past its end (into
    the next chunk), the last chunk has one fewer, and the sum is divided
    by B·(T - 1)."""
    dev = params["embedding"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    logits = llama.forward_train(cfg, params, tokens, rope, grid)
    rows, (c0, c1) = llama.train_block(grid, B, T)
    targets = tokens[rows, c0 + 1:c1 + 1]
    logp = torch.log_softmax(logits[:, :targets.shape[1]].float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if grid is None or grid.size("dp", "sp") == 1:
        return -ll.mean()
    part = -ll.sum() / (B * (T - 1))
    return group_sum(group_sum(part, grid.group("sp")), grid.group("dp"))


def sync_grads(params: dict, grid) -> None:
    """Sum the gradients a rank holds of leaves replicated over an axis that
    splits the work: every leaf over ``dp`` and ``sp``, the embedding over
    ``pp`` (only stage 0 reads it). One flat f32 all-reduce per axis on the
    pinned ring: the same bits on every rank. A leaf without a gradient
    counts as zeros."""
    if grid is None:
        return
    items = leaf_items(params)
    for axes, names in ((("dp",), None), (("sp",), None), (("pp",), ("embedding",))):
        group = grid.group(*axes)
        if group is None:
            continue
        picked = [v for k, v in items if names is None or k in names]
        flat = torch.cat([(v.grad if v.grad is not None else torch.zeros_like(v))
                          .float().reshape(-1) for v in picked])
        flat = all_reduce(flat, group)
        at = 0
        for v in picked:
            n = v.numel()
            v.grad = flat[at:at + n].reshape(v.shape).to(v.dtype)
            at += n


def make_train_step(cfg: ModelConfig, grid=None):
    """``step(params, optimizer, tokens) -> loss``: the forward and the loss
    (:func:`lm_loss`), the backward pass, :func:`sync_grads` and
    ``optimizer.step()``. Returns the loss as a detached 0-d tensor on the
    params' device (reading it is the caller's one host sync). The rope
    tables are made once per device."""
    ropes: dict = {}

    def step(params: dict, optimizer, tokens) -> torch.Tensor:
        dev = params["embedding"].device
        if dev not in ropes:
            ropes[dev] = llama.rope_tables(cfg, dev)
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(cfg, params, tokens, ropes[dev], grid)
        loss.backward()
        sync_grads(params, grid)
        optimizer.step()
        return loss.detach()

    return step


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0):
    """optax's ``warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (the total, warmup included).
    Returns ``schedule(count) -> value``; with an optimiser made at lr 1,
    ``LambdaLR(optimizer, schedule)`` gives step k the value at count k,
    as optax does (call the scheduler's ``step()`` after the optimiser's)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            if warmup_steps <= 0:
                return init_value
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * (0.5 * (1 + math.cos(math.pi * c / cos_steps))) ** exponent
        return peak_value * (decayed + alpha)

    return schedule


def optimizer_state(optimizer, params: dict) -> dict:
    """The optimiser's per-leaf state keyed by leaf path ({path: {name:
    tensor}}), for ``runtime.checkpoint``: a tensor shaped like its leaf is
    sharded as the leaf is."""
    state = optimizer.state
    return {k: {n: t for n, t in state[v].items()} for k, v in leaf_items(params)
            if v in state}


def load_optimizer_state(optimizer, params: dict, saved: dict) -> None:
    """Put :func:`optimizer_state`'s dict back into ``optimizer`` (built over
    ``leaves(params)``), copying each tensor onto its leaf's device."""
    for k, v in leaf_items(params):
        if k in saved:
            optimizer.state[v] = {n: (t.to(v.device) if isinstance(t, torch.Tensor)
                                      and t.dim() > 0 else t)
                                  for n, t in saved[k].items()}


def optimizer_state_like(optimizer, params: dict) -> dict:
    """A state dict of :func:`optimizer_state`'s structure, shapes and
    devices for ``optimizer``'s class and settings over ``params`` (its
    values meaningless): the target of a ``runtime.checkpoint.restore``.
    Made by one step of a twin optimiser on zero-gradient copies."""
    twins = {k: v.detach().clone().requires_grad_(True) for k, v in leaf_items(params)}
    twin = type(optimizer)(list(twins.values()), **optimizer.defaults)
    for t in twins.values():
        t.grad = torch.zeros_like(t)
    twin.step()
    return {k: dict(twin.state[t]) for k, t in twins.items()}
