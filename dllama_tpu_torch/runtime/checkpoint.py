"""Training checkpoints: save and restore the parameters, the optimiser's
state and the step counter, sharded (the port of
``dllama_tpu/runtime/checkpoint.py``, on ``torch.distributed.checkpoint``).

Each rank writes its own shards once: a leaf sharded over a mesh axis
(``sharding.mesh_specs``: tp, ep, pp) goes in as a ``DTensor`` with
``Shard(axis)`` on that mesh dimension and ``Replicate()`` on the others,
and the checkpoint keeps one copy of each replicated piece. A restore into
targets on another mesh (or on one rank, without any) reads the pieces its
shards overlap: ``torch.distributed.checkpoint`` reshards. An optimiser
state tensor shaped like its leaf is sharded as the leaf is; any other (a
step count) is replicated.

``torch.distributed.checkpoint`` keeps one rank's copy of a plain tensor,
so a shard saved as one would lose every other rank's: every sharded leaf
is wrapped. The tensors are staged in host memory (the mesh's device type
is "cpu"), which is where the writer copies them anyway.

A save writes beside ``path`` (``path.partial``) and, once every rank has
written, moves the checkpoint already at ``path`` to ``path.old``, renames
the new one into place and deletes the old one. A save stopped between the
two renames leaves ``path.old`` alone: :func:`restore` reads it, and the
next save puts it back first, so a checkpoint already at ``path`` is
replaced whole or not at all. The format is the port's own: it cannot read
an orbax checkpoint of the JAX package.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel import sharding


def _device_mesh(grid):
    """The ``DeviceMesh`` of ``grid``'s axes of more than one rank, built on
    its own groups (no new group), or None when it has none."""
    from torch.distributed.device_mesh import DeviceMesh

    names = [a for a, n in grid.sizes.items() if n > 1]
    if not names:
        return None
    ranks = np.arange(grid.world.size).reshape(list(grid.sizes.values()))
    ranks = np.vectorize(grid.world.global_rank)(ranks).reshape([grid.sizes[a] for a in names])
    pgs = [grid.group(a).pg or dist.group.WORLD for a in names]
    return DeviceMesh.from_group(pgs, "cpu", mesh=torch.as_tensor(ranks),
                                 mesh_dim_names=tuple(names))


def _flat(params: dict, opt_state: dict) -> dict:
    out = {f"params/{k}": v for k, v in params.items() if k != "layers"}
    out.update({f"params/layers/{k}": v for k, v in params["layers"].items()})
    for leaf, state in opt_state.items():
        out.update({f"opt/{leaf}/{n}": t for n, t in state.items()})
    return out


def _wrap(flat: dict, cfg, grid, dmesh) -> dict:
    """Host copies of ``flat``'s tensors, each sharded leaf (and each state
    tensor shaped like one) as a DTensor of its shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    specs = {} if dmesh is None else sharding.leaf_specs(sharding.mesh_specs(cfg, grid))
    shapes = {k.split("/", 1)[1]: tuple(v.shape) for k, v in flat.items()
              if k.startswith("params/")}
    out = {}
    for key, t in flat.items():
        if not isinstance(t, torch.Tensor):
            out[key] = t
            continue
        host = t.detach().to("cpu", copy=True)
        leaf = key.split("/", 1)[1] if key.startswith("params/") else key[4:].rsplit("/", 1)[0]
        spec = specs.get(leaf)
        if spec is None or tuple(t.shape) != shapes.get(leaf) or not any(spec):
            out[key] = host
            continue
        place = [Shard(spec.index(a)) if a in spec else Replicate()
                 for a in dmesh.mesh_dim_names]
        out[key] = DTensor.from_local(host, dmesh, place, run_check=False)
    return out


def _process_group(grid):
    return None if grid is None else (grid.world.pg or dist.group.WORLD)


def _barrier(grid) -> None:
    if grid is not None:
        dist.barrier(group=_process_group(grid))


def save(path: str, params: dict, opt_state: dict, step: int, cfg: ModelConfig = None,
         grid=None) -> str:
    """Write one checkpoint of ``params``, ``opt_state`` ({leaf path: {name:
    tensor}}, ``runtime.train.optimizer_state``) and ``step`` at ``path`` (a
    directory), replacing one already there whole. ``grid`` (a
    ``parallel.group.Mesh``, with ``cfg`` to name its shards): every rank of
    its world calls this with its shards; without one, this process alone
    writes whole leaves. Returns the absolute path."""
    path = os.path.abspath(path)
    partial, old = path + ".partial", path + ".old"
    lead = grid is None or grid.world.rank == 0
    if lead:
        if os.path.exists(old) and not os.path.exists(path):  # a save stopped mid-way
            os.replace(old, path)
        if os.path.exists(partial):
            shutil.rmtree(partial)
    _barrier(grid)
    flat = _wrap(_flat(params, opt_state), cfg, grid,
                 None if grid is None else _device_mesh(grid))
    flat["step"] = torch.tensor(int(step), dtype=torch.int64)
    dcp.save(flat, checkpoint_id=partial, process_group=_process_group(grid),
             no_dist=grid is None)
    _barrier(grid)
    if lead:
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(partial, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier(grid)
    return path


def restore(path: str, params_like: dict, opt_state_like: dict, cfg: ModelConfig = None,
            grid=None) -> tuple:
    """``(params, opt_state, step)`` from the checkpoint at ``path``, in the
    structure, shapes, dtypes and devices of ``params_like`` and
    ``opt_state_like`` (this rank's shards on ``grid``, whole leaves
    without one; the targets are not written). The grid may differ from the
    saving one: each rank reads the pieces its shards cover. Where a save
    was stopped between its renames, the checkpoint it replaced is read."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path += ".old"
    like = _flat(params_like, opt_state_like)
    flat = _wrap({k: (torch.empty_like(v) if isinstance(v, torch.Tensor) else v)
                  for k, v in like.items()}, cfg, grid,
                 None if grid is None else _device_mesh(grid))
    flat["step"] = torch.tensor(0, dtype=torch.int64)
    dcp.load(flat, checkpoint_id=path, process_group=_process_group(grid),
             no_dist=grid is None)

    def back(key):
        t = flat[key]
        t = t.to_local() if hasattr(t, "to_local") else t
        ref = like[key]
        return t.to(device=ref.device, dtype=ref.dtype) if isinstance(ref, torch.Tensor) else t

    params = {k: back(f"params/{k}") for k in params_like if k != "layers"}
    params["layers"] = {k: back(f"params/layers/{k}") for k in params_like["layers"]}
    opt_state = {leaf: {n: back(f"opt/{leaf}/{n}") for n in state}
                 for leaf, state in opt_state_like.items()}
    return params, opt_state, int(flat["step"])
