"""Differentiable collectives for the training path.

``parallel.collectives`` moves tensors for the inference forwards, outside
autograd. Training needs each collective's transpose in the backward pass:
here each one is a ``torch.autograd.Function``, the port of what JAX derives
from ``psum`` and ``ppermute`` inside ``shard_map``, and of Megatron-LM's
conjugate pair f/g (Shoeybi et al., https://arxiv.org/abs/1909.08053):

* :func:`copy_to` (f): identity forward, all-reduce backward. A replicated
  activation enters a rank's column shard (its heads, its hidden slice, its
  vocab slice): each rank's backward holds its shard's part of the
  activation's gradient, and the parts are summed.
* :func:`reduce_from` (g): all-reduce forward, identity backward. A row
  shard's partial sums become the whole output on every rank; every rank
  then carries the same cotangent, which is already each partial's.
* :func:`group_sum` is ``reduce_from`` under its JAX name: the sum of a
  value over a group (the loss's parts over ``dp`` and ``sp``, the
  pipeline's finished microbatches over ``pp``). A replicated cotangent is
  not multiplied by the group's size on the way back.
* :func:`gather_from`: the last axis gathered in rank order forward (the
  logits' vocab shards), this rank's slice of the cotangent backward.
* :func:`ring_shift`: send to rank + step, receive from rank - step forward
  (``ppermute``), the reverse shift backward.

Every all-reduce is ``collectives.reduce_columns``, the pinned-order ring:
every rank holds the same bits, so replicas that step on summed gradients
stay bit-identical. Over gloo a CUDA tensor's hop goes through host memory
(gloo's send takes CPU tensors only). A group of None (or of one rank) makes
each of them the identity.

Issue order: every rank must issue the same collectives in the same order,
in the backward pass too, where autograd runs a node once every use of its
output has sent back its cotangent, and runs nothing that no path joins to
the loss. A shift whose output some rank never uses would never run its
backward there, and its peer would wait for ever. The callers keep every
shift's output on a path to the loss on every rank, the way the JAX package
masks values (``x * mask``, ``where``) instead of branching: then each
shift's backward waits for the next shift's, one fixed chain on every rank.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch.parallel.collectives import _start_ring_hop, gather_columns, reduce_columns


def _live(group) -> bool:
    return group is not None and group.size > 1


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in f32 on the pinned ring, in
    ``x``'s dtype and shape, the same bits on every rank."""
    if not _live(group):
        return x
    return reduce_columns(x.reshape(1, -1), group).reshape(x.shape).to(x.dtype)


def shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Send ``x`` to rank + ``step`` and return what rank - ``step`` sent
    (``x``'s shape on every rank), outside autograd: one ring hop of
    ``collectives``."""
    return _start_ring_hop(x.detach(), group, step).wait() if _live(group) else x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return gather_columns(x, group)

    @staticmethod
    def backward(ctx, g):
        r, c = ctx.group.rank, ctx.width
        return g[..., r * c:(r + 1) * c].contiguous(), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), ctx.group, -ctx.step), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the cotangent backward (Megatron's f)."""
    return _CopyTo.apply(x, group) if _live(group) else x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward (the pinned ring, f32 sums in ``x``'s dtype),
    identity backward (Megatron's g)."""
    return _ReduceFrom.apply(x, group) if _live(group) else x


#: the sum of a value over a group, whose cotangent is the replicated one
group_sum = reduce_from


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    """The last axis gathered in rank order forward; this rank's slice of
    the cotangent backward."""
    return _GatherFrom.apply(x, group) if _live(group) else x


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Send ``x`` to rank + ``step``, receive from rank - ``step`` (JAX's
    ``ppermute`` on a ring); backward, the reverse shift of the cotangent."""
    return _RingShift.apply(x, group, step) if _live(group) else x
