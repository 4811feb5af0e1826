"""The tensor-parallel world: one process per rank, joined by ``torch.distributed``.

The JAX package drives every local device from one process over a ``tp``
mesh (``dllama_tpu/parallel/mesh.py``) and joins hosts with
``jax.distributed`` (``cli.maybe_init_distributed``). PyTorch's idiom is one
process per rank: :func:`init_tp` joins this process to a world and returns
the :class:`TPGroup` that the model and the Engine take where the JAX
package takes ``tp_axis`` and ``mesh``. The backend and each rank's device
are the caller's explicit choice: NCCL with ``cuda:<local rank>`` (the CLI on
cards), gloo on the CPU (the tests), or gloo with every rank on one card
(``chip_smoke.py``'s multi-rank check on a one-card machine, through this
API only).

:func:`make_grid` lays an ``ep x tp`` grid over a world, as the JAX
package's ``make_mesh({"ep": E, "tp": T})``: the rank's :class:`TPGroup`
is then its ``tp`` subgroup, and its ``world`` the whole grid.

:func:`launch` runs a function as this process's rank and spawns the other
local ranks (the CLI's ``--tp N``). :class:`LocalWorld` keeps N spawned
ranks alive and runs task after task on all of them, or on the first n
through a subgroup (the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
#: seconds a collective (and a LocalWorld task) may wait before it fails
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class TPGroup:
    """One rank's view of a tensor-parallel world: its ``rank`` of ``size``,
    its ``device``, the ``torch.distributed`` process group ``pg`` (None:
    the default world), and ``sent_bytes``, the bytes its gathers sent
    (an all-gather receives as many: the Engine's S/R figures).

    A group holds the world's first ``size`` ranks, or the ranks
    ``members`` (a line of a :class:`Mesh`). In an ``ep x tp`` grid
    (:func:`make_grid`) the group is the rank's ``tp`` line, ``ep_rank``
    its row of ``ep``, and ``world`` the whole grid (the expert-parallel
    MoE FFN reduces over it); elsewhere ``world`` is None."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: object = None
    sent_bytes: int = 0
    ep: int = 1
    ep_rank: int = 0
    world: Optional["TPGroup"] = None
    #: the world ranks of the group, in group-rank order, where they are
    #: not the world's first ``size`` (a line of a :class:`Mesh`)
    members: Optional[tuple] = None

    def global_rank(self, rank: int) -> int:
        """The world rank of this group's ``rank`` (what ``torch.distributed``
        takes as a peer or a source)."""
        return rank if self.members is None else self.members[rank]

    @property
    def grid(self) -> "TPGroup":
        """The whole grid: ``world``, or this group when it is the world."""
        return self if self.world is None else self.world

    @property
    def sent_bytes_all(self) -> int:
        """The bytes this rank sent on its ``tp`` group and, in a grid, on
        the whole world."""
        return self.sent_bytes + (0 if self.world is None else self.world.sent_bytes)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank (picklable objects)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.global_rank(src), group=self.pg)
        return box[0]


def local_init_method() -> str:
    """A rendezvous address on this host (a free port)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init_tp(rank: int, size: int, *, backend: str, device, init_method: str,
            timeout_s: float = DEFAULT_TIMEOUT_S) -> TPGroup:
    """Join this process to a world of ``size`` ranks as ``rank`` through
    ``init_method`` (``tcp://host:port``, rank 0's address) and return its
    :class:`TPGroup`. ``backend`` is "nccl" (a CUDA device per rank) or
    "gloo"; a CUDA ``device`` becomes this process's current device. A
    collective that waits longer than ``timeout_s`` raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device on every rank, got {device}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return TPGroup(rank, size, device, backend)


def close_tp() -> None:
    """Leave the world this process joined (no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def subgroup(world: TPGroup, n: int) -> Optional[TPGroup]:
    """The group of the world's first ``n`` ranks. Making a group is
    collective: every rank of the world calls this, in the same order;
    ranks past ``n`` get None."""
    pg = dist.new_group(list(range(n)))
    if world.rank >= n:
        return None
    return TPGroup(world.rank, n, world.device, world.backend, pg)


def make_grid(world: TPGroup, ep: int) -> TPGroup:
    """This rank's ``tp`` line of the ``ep x tp`` grid
    ``make_mesh(world, {"ep": ep, "tp": size / ep})``: world rank r sits at
    (r // tp, r % tp), the axis order of the JAX package's ``make_mesh``.
    Making groups is collective: every rank of the world calls this. At
    ``ep`` 1 the grid is the world itself."""
    if ep < 1 or world.size % ep:
        raise ValueError(f"ep={ep} must divide the world's {world.size} ranks")
    if ep == 1:
        return world
    mesh = make_mesh(world, {"ep": ep, "tp": world.size // ep})
    line = mesh.group("tp")
    if line is None:  # tp 1: each rank's line is the rank alone
        pgs = [dist.new_group([world.global_rank(r)]) for r in range(world.size)]
        line = TPGroup(0, 1, world.device, world.backend, pgs[world.rank],
                       members=(world.global_rank(world.rank),))
    return dataclasses.replace(line, ep=ep, ep_rank=mesh.index("ep"), world=world)


@dataclasses.dataclass
class Mesh:
    """A rank's place on a named grid over a world (:func:`make_mesh`):
    ``sizes`` the ordered {axis: size}, ``coords`` the rank's index on each
    axis, ``groups`` the :class:`TPGroup` of the rank's line along each axis
    (and along each plane of axes made), None where the line holds this rank
    alone. An axis the mesh lacks has size 1."""

    sizes: dict
    coords: dict
    groups: dict
    world: TPGroup

    def size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.sizes.get(a, 1)
        return n

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, *axes: str) -> Optional[TPGroup]:
        """The group of the ranks that differ from this one only on
        ``axes`` (axes the mesh lacks are dropped); None when that line is
        this rank alone."""
        key = tuple(a for a in self.sizes if a in axes and self.sizes[a] > 1)
        return self.groups[key] if key else None


#: the planes of several axes a mesh also makes a group for: the expert
#: FFN reduces over the whole ``ep x tp`` plane
MESH_PLANES = (("ep", "tp"),)


def make_mesh(world: TPGroup, axes: dict) -> Mesh:
    """This rank's :class:`Mesh` of the grid ``axes`` (an ordered {axis:
    size} whose sizes multiply to ``world.size``) over ``world``: the
    counterpart of the JAX package's ``make_mesh``. The last axis is the
    innermost: world rank r sits at ``np.unravel_index(r, sizes)``, as JAX
    reshapes its devices. Each axis (and each plane of
    :data:`MESH_PLANES` the mesh holds) gets one subgroup per line of the
    other axes; a line that is the whole world is ``world`` itself. Making
    groups is collective: every rank of the default world calls this, and
    every rank makes every subgroup, in one order."""
    import numpy as np

    names = list(axes)
    sizes = [int(axes[a]) for a in names]
    if any(n < 1 for n in sizes) or int(np.prod(sizes)) != world.size:
        raise ValueError(f"mesh {axes} does not cover the world's {world.size} ranks")
    grid = np.arange(world.size).reshape(sizes)
    here = np.unravel_index(world.rank, sizes)
    coords = {a: int(i) for a, i in zip(names, here)}
    planes = [(a,) for a in names if axes[a] > 1]
    planes += [p for p in MESH_PLANES
               if all(a in axes for a in p) and sum(axes[a] > 1 for a in p) > 1]
    groups: dict = {}
    for plane in planes:
        keep = sorted(names.index(a) for a in plane)  # the key Mesh.group looks up
        plane = tuple(names[i] for i in keep)
        rest = [i for i in range(len(names)) if i not in keep]
        lines = np.moveaxis(grid, keep + rest, list(range(len(names))))
        lines = lines.reshape(int(np.prod([sizes[i] for i in keep])), -1).T
        mine = None
        for line in lines:
            members = tuple(world.global_rank(int(r)) for r in line)
            if len(line) == world.size:
                pg = world.pg
            else:
                if world.size != dist.get_world_size():
                    raise ValueError("a mesh with a proper sub-line is made on the whole "
                                     "default world")
                pg = dist.new_group(list(members))
            if world.rank in line:
                mine = TPGroup(int(list(line).index(world.rank)), len(line), world.device,
                               world.backend, pg, members=members)
        groups[plane] = mine
    return Mesh(dict(axes), coords, groups, world)


def _rank_main(rank, size, backend, device, init_method, timeout_s, fn, args):
    group = init_tp(rank, size, backend=backend, device=device, init_method=init_method,
                    timeout_s=timeout_s)
    try:
        return fn(group, *args)
    finally:
        close_tp()


def launch(fn: Callable, ranks, world_size: int, *, backend: str, devices: list,
           init_method: Optional[str] = None, args: tuple = (),
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(group, *args)`` on the local ranks ``ranks`` of a world of
    ``world_size``: ``ranks[0]`` runs in this process, on ``devices[0]``,
    and each other one in a process of its own (start method spawn) on its
    device. Returns this process's result; raises when a spawned rank
    fails. ``fn`` must be importable by name (a module-level function).
    ``init_method`` defaults to a free local port (a one-host world)."""
    ranks = list(ranks)
    if len(devices) != len(ranks):
        raise ValueError(f"{len(ranks)} local ranks but {len(devices)} devices")
    init_method = init_method or local_init_method()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, d, init_method, timeout_s, fn, args))
             for r, d in zip(ranks[1:], devices[1:])]
    for p in procs:
        p.start()
    try:
        out = _rank_main(ranks[0], world_size, backend, devices[0], init_method, timeout_s,
                         fn, args)
    except BaseException:
        for p in procs:  # they would wait in a collective until the timeout
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join()
    bad = {r: p.exitcode for r, p in zip(ranks[1:], procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"local ranks failed (rank: exit code): {bad}")
    return out


def _world_rank(rank, size, backend, device, init_method, timeout_s, threads, tasks, results):
    """A :class:`LocalWorld` rank: join, make the prefix subgroups, then run
    tasks ``(n, fn, args)`` until a None, replying ``(rank, ok, result or
    traceback)``."""
    if threads:
        torch.set_num_threads(threads)
    world = init_tp(rank, size, backend=backend, device=device, init_method=init_method,
                    timeout_s=timeout_s)
    groups = {size: world}
    for n in range(1, size):
        g = subgroup(world, n)
        if g is not None:
            groups[n] = g
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            n, fn, args = task
            try:
                results.put((rank, True, fn(groups[n], *args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        close_tp()


class LocalWorld:
    """``size`` ranks as spawned local processes that stay up: :meth:`run`
    runs ``fn(group, *args)`` on the first ``n`` of them (a subgroup when
    ``n`` < ``size``) and returns their results in rank order. This process
    is no rank; ``fn`` must be importable by name and return picklable host
    objects (numbers, lists, numpy arrays). A failed or timed-out task
    closes the world (its ranks may be stuck in a collective) and raises
    with the failing rank's traceback. ``threads`` sets each rank's
    ``torch.set_num_threads``; ``init_method`` the rendezvous address (a
    free port of this host by default)."""

    def __init__(self, size: int, *, backend: str = "gloo", devices: Optional[list] = None,
                 threads: Optional[int] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 init_method: Optional[str] = None):
        devices = devices if devices is not None else ["cpu"] * size
        if len(devices) != size:
            raise ValueError(f"{size} ranks but {len(devices)} devices")
        ctx = mp.get_context("spawn")
        self.size = size
        self._timeout = timeout_s
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        init = init_method or local_init_method()
        self._procs = [ctx.Process(target=_world_rank, daemon=True,
                                   args=(r, size, backend, devices[r], init, timeout_s, threads,
                                         self._tasks[r], self._results))
                       for r in range(size)]
        for p in self._procs:
            p.start()
        self._broken: Optional[str] = None

    @property
    def pids(self) -> list:
        """The ranks' process ids, in rank order."""
        return [p.pid for p in self._procs]

    def run(self, fn: Callable, *args, size: Optional[int] = None) -> list:
        n = self.size if size is None else size
        if not 1 <= n <= self.size:
            raise ValueError(f"a task on {n} ranks in a world of {self.size}")
        if self._broken is not None:
            raise RuntimeError(f"the world was closed after a failure: {self._broken}")
        for q in self._tasks[:n]:
            q.put((n, fn, args))
        got: dict = {}
        deadline = time.monotonic() + self._timeout
        while len(got) < n:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(self._procs) if not p.is_alive()}
                if dead:
                    self._fail(f"ranks exited (rank: exit code): {dead}")
                if time.monotonic() > deadline:
                    self._fail(f"{fn.__name__} took longer than {self._timeout} s")
                continue
            if not ok:
                self._fail(f"rank {rank} failed in {fn.__name__}:\n{payload}")
            got[rank] = payload
        return [got[r] for r in range(n)]

    def _fail(self, why: str) -> None:
        self._broken = why
        self._stop()
        raise RuntimeError(why)

    def _stop(self) -> None:
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join()
        for q in self._tasks:  # a task no rank read must not hold this process at exit
            q.cancel_join_thread()

    def close(self) -> None:
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(30)
        self._stop()

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
