"""Rank-side cases of the port's training tests and of ``chip_smoke.py``
phase 12(d).

``parallel.group.LocalWorld`` runs each function here on every rank of a
gloo world (``fn(group, *args)``: CPU processes in the tests, ranks all on
the card in the smoke run); they import only torch and the port (never
JAX), so a spawned rank starts in a second. Called with ``group=None`` they
are the one-device reference, on ``device``. Params travel as host dicts of
numpy arrays (the whole model); each rank cuts its shards from them on its
mesh (``sharding.shard_mesh_params``) on its device. A mesh is made once
per process for each layout (``mesh``), in the same order on every rank.
Results come back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.ops.ring_attention import ring_self_attention
from dllama_tpu_torch.parallel import sharding
from dllama_tpu_torch.parallel.group import make_grid, make_mesh
from dllama_tpu_torch.parallel.pipeline import pipeline_forward_train
from dllama_tpu_torch.runtime import checkpoint, train

_MESHES: dict = {}


def mesh(group, axes: dict):
    """This process's mesh of ``axes`` over ``group`` (made on first use)."""
    key = (group.size, tuple(axes.items()))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(group, axes)
    return _MESHES[key]


def host_of(params: dict) -> dict:
    """A params dict (tensors or numpy) as a host dict of numpy arrays."""
    def h(v):
        return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    out = {k: h(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: h(v) for k, v in params["layers"].items()}
    return out


def nest(flat: dict) -> dict:
    """{leaf path: array} (``train.leaf_items``' paths) as a params dict."""
    out = {k: v for k, v in flat.items() if not k.startswith("layers/")}
    out["layers"] = {k[len("layers/"):]: v for k, v in flat.items() if k.startswith("layers/")}
    return out


def _device(group, device) -> torch.device:
    return group.device if group is not None else torch.device(device)


def _tensors(host: dict, cfg, grid, device) -> dict:
    """The rank's shards of the host params, f32 tensors on ``device``
    needing grad."""
    def t(v):
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    full = {k: t(v) for k, v in host.items() if k != "layers"}
    full["layers"] = {k: t(v) for k, v in host["layers"].items()}
    return train.trainable(sharding.shard_mesh_params(full, cfg, grid))


def _numpy(params: dict, grads: bool = False) -> dict:
    return {k: (v.grad if grads else v).detach().cpu().numpy().copy()
            for k, v in train.leaf_items(params)}


AXES = ("dp", "sp", "pp", "ep", "tp")


def position(group, axes: dict) -> dict:
    """{axis: (index, size)} of this rank on the mesh, on every axis (size
    1 where the mesh lacks it)."""
    g = mesh(group, axes) if group is not None else None
    return {a: (g.index(a), g.size(a)) if g else (0, 1) for a in AXES}


def grid_case(group, ep: int) -> dict:
    """This rank's ``make_grid(group, ep)`` line: its place on ``ep`` and
    ``tp``, the world ranks of its ``tp`` line, and the sum of those world
    ranks by an all-reduce on the line's process group."""
    key = (group.size, "grid", ep)
    if key not in _MESHES:
        _MESHES[key] = make_grid(group, ep)
    g = _MESHES[key]
    total = torch.tensor([float(group.rank)])
    torch.distributed.all_reduce(total, group=g.pg)
    return {"ep": (g.ep_rank, g.ep), "tp": (g.rank, g.size),
            "line": [g.global_rank(i) for i in range(g.size)], "line_sum": float(total)}


def ring_case(group, axes: dict, q: np.ndarray, k: np.ndarray, v: np.ndarray,
              causal: bool) -> dict:
    """Ring attention on the rank's ``sp`` chunk of q, k, v [B, T, H, D]:
    its output chunk and the gradients of ``sum(out**2)`` over the chunks."""
    g = mesh(group, axes)
    n, i = g.size("sp"), g.index("sp")
    c = q.shape[1] // n
    qc, kc, vc = (torch.from_numpy(a[:, i * c:(i + 1) * c].copy()).to(group.device)
                  .requires_grad_(True) for a in (q, k, v))
    out = ring_self_attention(qc, kc, vc, g.group("sp"), causal)
    (out ** 2).sum().backward()
    return {"sp": i, "out": out.detach().cpu().numpy(),
            "grads": [t.grad.cpu().numpy() for t in (qc, kc, vc)]}


def loss_case(group, axes: dict, host: dict, cfg, tokens: np.ndarray, device="cpu") -> dict:
    """The mesh's lm_loss and the rank's gradients after ``sync_grads``."""
    g = mesh(group, axes) if group is not None else None
    params = _tensors(host, cfg, g, _device(group, device))
    loss = train.lm_loss(cfg, params, torch.from_numpy(tokens), grid=g)
    loss.backward()
    train.sync_grads(params, g)
    return {"loss": float(loss.detach()), "grads": _numpy(params, grads=True),
            "position": position(group, axes)}


def _optimizer(params: dict, opt: dict):
    kind = opt["kind"]
    kw = {k: v for k, v in opt.items() if k != "kind"}
    return getattr(torch.optim, kind)(train.leaves(params), **kw)


def step_case(group, axes: dict, host: dict, cfg, batches: list, opt: dict,
              device="cpu") -> dict:
    """``make_train_step`` on the mesh, one step per batch: the losses, the
    rank's leaves after and the last step's gradients."""
    g = mesh(group, axes) if group is not None else None
    params = _tensors(host, cfg, g, _device(group, device))
    optimizer = _optimizer(params, opt)
    step = train.make_train_step(cfg, g)
    losses = [float(step(params, optimizer, torch.from_numpy(b))) for b in batches]
    return {"losses": losses, "params": _numpy(params), "grads": _numpy(params, grads=True),
            "position": position(group, axes)}


def pipeline_case(group, axes: dict, host: dict, cfg, tokens: np.ndarray, micro: int,
                  remat: bool, device="cpu") -> dict:
    """The pipeline's logits on the mesh and the rank's gradients of
    ``mean(logits**2)`` (the embedding's summed over ``pp``)."""
    g = mesh(group, axes) if group is not None else None
    params = _tensors(host, cfg, g, _device(group, device))
    logits = pipeline_forward_train(cfg, params, torch.from_numpy(tokens), g,
                                    n_microbatches=micro, remat=remat)
    (logits ** 2).mean().backward()
    train.sync_grads(params, g)
    return {"logits": logits.detach().cpu().numpy(), "grads": _numpy(params, grads=True),
            "position": position(group, axes)}


ADAM = {"kind": "Adam", "lr": 1e-3}


def _moments(optimizer, params: dict) -> dict:
    """Adam's state of every leaf as numpy: ``exp_avg`` and ``exp_avg_sq``
    ({leaf path: array}, sharded as the leaves) and ``adam_step`` ({leaf
    path: count})."""
    state = train.optimizer_state(optimizer, params)
    return {"exp_avg": {k: v["exp_avg"].cpu().numpy().copy() for k, v in state.items()},
            "exp_avg_sq": {k: v["exp_avg_sq"].cpu().numpy().copy() for k, v in state.items()},
            "adam_step": {k: float(v["step"]) for k, v in state.items()}}


def checkpoint_save_case(group, axes: dict, host: dict, cfg, batches: list, after: list,
                         path: str) -> dict:
    """Adam steps on the mesh on ``batches``, a checkpoint, then the steps
    on ``after``: the continuing run's losses, with the leaves and Adam's
    state that were saved."""
    g = mesh(group, axes)
    params = _tensors(host, cfg, g, group.device)
    optimizer = _optimizer(params, ADAM)
    step = train.make_train_step(cfg, g)
    for b in batches:
        step(params, optimizer, torch.from_numpy(b))
    checkpoint.save(path, params, train.optimizer_state(optimizer, params), len(batches),
                    cfg, g)
    saved = {"saved": _numpy(params), **_moments(optimizer, params)}
    nxt = [float(step(params, optimizer, torch.from_numpy(b))) for b in after]
    return {"next_losses": nxt, **saved, "position": position(group, axes)}


def checkpoint_restore_case(group, axes: dict, host: dict, cfg, after: list,
                            path: str) -> dict:
    """Restore the checkpoint into this mesh's shards (fresh targets from
    other weights) and continue with Adam steps on ``after``: the step
    count, the restored leaves and Adam state, and the losses."""
    g = mesh(group, axes)
    like = _tensors(host, cfg, g, group.device)
    optimizer = _optimizer(like, ADAM)
    params, opt_state, step_no = checkpoint.restore(
        path, like, train.optimizer_state_like(optimizer, like), cfg, g)
    restored = _numpy(params)
    train.trainable(params)
    optimizer = _optimizer(params, ADAM)
    train.load_optimizer_state(optimizer, params, opt_state)
    moments = _moments(optimizer, params)
    step = train.make_train_step(cfg, g)
    nxt = [float(step(params, optimizer, torch.from_numpy(b))) for b in after]
    return {"step": step_no, "params": restored, **moments, "next_losses": nxt,
            "position": position(group, axes)}


def assemble(cfg, ranks: list, key: str) -> dict:
    """The whole leaves of the ranks' shards (``ranks[i][key]``: {leaf
    path: numpy}), placed at each rank's position."""
    return sharding.unshard_leaves(cfg, [(r["position"], r[key]) for r in ranks])
