"""The activation gathers of the quantized tensor-parallel forward.

Every matrix is sharded on its output axis only (``parallel.quant_tp``), so
each matmul's input is gathered whole first: the port of the gather
direction of ``dllama_tpu/parallel/collectives.py``, the reference's
per-layer wire trips (`distributed-llama/src/tasks.cpp:44-90`). A gather is
one ``torch.distributed.all_gather`` (the list form, which NCCL and gloo
both take, gloo CUDA tensors included) and a concatenation in rank order.

``compress=True`` moves the activation as the reference's Q80 wire
(``--buffer-float-type q80``, ``quantizeQ80Row`` at
`distributed-llama/src/tasks.cpp:124-163`): int8 quants of 32-value blocks
followed by the bytes of each block's f32 scale, one payload per gather.
The codec is a copy of the JAX package's ``_q80_encode``/``_q80_decode``
with its order of operations, so the payload is bit-equal to JAX's on the
same input.

Each gather adds the bytes it sent to its group's ``sent_bytes``: (size -
1) times the local payload, as many as it receives, what a ring all-gather
moves through every rank (the JAX package's analytic count). A failed
collective raises; nothing falls back.

A paged row's export and import move its KV pages on the same group, exactly:
:func:`gather_axis` joins every rank's kv heads, :func:`broadcast_from_root`
hands rank 0's imported pages to every rank.

The REDUCE direction (``--tp-reduce``), the port of the JAX package's
``reduce_scatter_columns``: a K-sharded ``wo``/``w2`` gives full-width f32
partial sums on every rank; :func:`reduce_scatter_columns` sums them on a
ring with a PINNED order (rank i ends with chunk i summed as p[i+1], p[i+2],
..., p[i]), each hop one send to rank i + 1 and one receive from rank i - 1
(``batch_isend_irecv``), over the Q80 wire with ``compress``.
:func:`scatter_features` is the rank's chunk of a replicated row and
:func:`rms_inv_scattered_steps` the whole row's rmsnorm scale from the chunks: the
per-rank sums of squares are all-gathered and added in rank order, so every
rank holds the same bits (JAX's ``psum`` of one scalar a row; the gather
moves (size - 1) x 4 bytes a row where JAX's analytic count has (size - 1) /
size x 4). gloo's point-to-point calls take CPU tensors only, so a hop of a
CUDA tensor over gloo is staged through host memory; NCCL sends device
tensors.

Every collective is written once, as a generator of steps
(``*_steps``): it yields each operation it has issued (a :class:`Pending`)
and resumes with the operation's result. :func:`drive` runs one to its end,
waiting at once (the plain calls below are that); :func:`interleave` runs
two or more round robin, so that one's operation is in flight while another
computes — the microbatch overlap of ``--tp-overlap``. Every rank runs the
same schedule, so every rank issues its collectives in the same order.
"""

from __future__ import annotations

from typing import Callable, Generator

import torch
import torch.distributed as dist

QK = 32  # values per Q80 wire block


def _require_q80_blocks(f: int, what: str) -> None:
    """The Q80 wire packs 32-value blocks: a feature dim off that grid
    would mix quants and scale bytes in the payload."""
    if f % QK:
        raise ValueError(f"{what}: local feature dim {f} is not a multiple of the {QK}-value "
                         f"Q80 block; pad the shard to a {QK}-multiple or gather uncompressed")


def q80_encode(xf: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., f]`` -> ONE int8 payload ``[..., f + f//8]``: the int8
    quants (round half to even of ``x / scale``, ``scale = absmax / 127``
    per 32-value block, a zero block divided by 1) followed by the bytes of
    each block's f32 scale."""
    lead, f = xf.shape[:-1], xf.shape[-1]
    xb = xf.reshape(*lead, f // QK, QK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.where(scale == 0.0, 1.0, scale)).to(torch.int8)
    scale_bytes = scale[..., 0].contiguous().view(torch.int8).reshape(*lead, f // 8)
    return torch.cat([q.reshape(*lead, f), scale_bytes], dim=-1)


def q80_decode(payload: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`q80_encode`: ``[..., f + f//8]`` int8 -> f32
    ``[..., f]`` (each int8 x f32-scale product is exact in f32)."""
    lead = payload.shape[:-1]
    q = payload[..., :f].float().reshape(*lead, f // QK, QK)
    s = payload[..., f:].contiguous().view(torch.float32).reshape(*lead, f // QK, 1)
    return (q * s).reshape(*lead, f)


class Pending:
    """A collective in flight: :meth:`wait` waits on its works and returns
    ``done()``, the result."""

    def __init__(self, works: list, done: Callable):
        self._works, self._done = works, done

    def wait(self):
        for w in self._works:
            w.wait()
        return self._done()


#: a collective written as steps: yields Pendings, is sent their results,
#: returns its own result
Steps = Generator[Pending, object, object]


def drive(steps: Steps):
    """Run ``steps`` to its end, waiting on each operation as it is issued;
    returns its result."""
    try:
        op = next(steps)
        while True:
            op = steps.send(op.wait())
    except StopIteration as stop:
        return stop.value


def interleave(*steps: Steps) -> list:
    """Run generators of steps round robin and return their results in
    order: each runs until it has issued an operation, and that operation is
    waited on only when its generator's turn comes round again, after the
    others have run up to their own next operation. With two microbatches
    A and B: A computes and issues, B computes (A's operation in flight)
    and issues, A waits and goes on (B's in flight), and so on."""
    out: list = [None] * len(steps)
    ops: list = [None] * len(steps)
    live = []
    for i, st in enumerate(steps):
        try:
            ops[i] = next(st)
            live.append(i)
        except StopIteration as stop:
            out[i] = stop.value
    while live:
        for i in list(live):
            try:
                ops[i] = steps[i].send(ops[i].wait())
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


def _start_gather(x: torch.Tensor, group, dim: int = -1) -> Pending:
    """Issue the all-gather of ``x`` (every rank's, concatenated on ``dim``
    in rank order); counts the (size - 1) payloads this rank sends."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    work = dist.all_gather(parts, x, group=group.pg, async_op=True)
    group.sent_bytes += (group.size - 1) * x.numel() * x.element_size()
    return Pending([work], lambda: torch.cat(parts, dim=dim))


def gather_axis(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order, as it is
    (no wire codec)."""
    return _start_gather(x, group, dim).wait()


def broadcast_from_root(x: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of ``group`` (the others pass a tensor
    of the same shape and dtype to fill). Rank 0 counts the bytes it sent
    to the others."""
    x = x.contiguous()
    # a group's rank 0 is the world's (a subgroup holds the world's first ranks)
    dist.broadcast(x, src=0, group=group.pg)
    if group.rank == 0:
        group.sent_bytes += (group.size - 1) * x.numel() * x.element_size()
    return x


def gather_columns_steps(x: torch.Tensor, group, compress: bool = False) -> Steps:
    """:func:`gather_columns` as steps (one operation)."""
    if group is None:
        return x
    if not compress:
        return (yield _start_gather(x, group))
    lead, f = x.shape[:-1], x.shape[-1]
    _require_q80_blocks(f, "gather_columns(compress=True)")
    payload = yield _start_gather(q80_encode(x.float()), group)
    deq = q80_decode(payload.reshape(*lead, group.size, f + f // 8), f)
    return deq.reshape(*lead, group.size * f).to(x.dtype)


def gather_columns(x: torch.Tensor, group, compress: bool = False) -> torch.Tensor:
    """Concatenate the feature (last) axis across ``group`` (a
    ``group.TPGroup``; identity when None). A group of one still gathers
    through its backend. ``compress``: over the Q80 wire (the local feature
    dim a multiple of 32); the result is dequantized in ``x``'s dtype."""
    return drive(gather_columns_steps(x, group, compress))


def scatter_features(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous chunk of the feature (last) axis: a local
    slice, no communication (identity without a group or at size 1).
    ``gather_columns(scatter_features(x, g), g)`` is ``x``."""
    if group is None or group.size == 1:
        return x
    f = x.shape[-1]
    if f % group.size:
        raise ValueError(f"scatter_features: feature dim {f} is not divisible by "
                         f"tp={group.size}")
    c = f // group.size
    return x[..., group.rank * c:(group.rank + 1) * c]


def rms_inv_scattered_steps(x_s: torch.Tensor, group, full_dim: int, eps: float) -> Steps:
    """``1/sqrt(mean(x^2) + eps)`` f32 [...] of the WHOLE row from this
    rank's chunk ``x_s`` [..., full_dim / size]: the local f32 sum of squares,
    every rank's gathered (one operation) and added in rank order."""
    xf = x_s.float()
    ss = torch.sum(xf * xf, dim=-1)
    if group is not None and group.size > 1:
        parts = yield _start_gather(ss[None], group, 0)
        ss = parts[0]
        for p in parts[1:]:
            ss = ss + p
    return torch.reciprocal(torch.sqrt(ss / full_dim + eps))


def _start_ring_hop(payload: torch.Tensor, group) -> Pending:
    """Issue one ring hop: send ``payload`` to rank + 1, receive the same
    shape from rank - 1. Over gloo a CUDA payload goes through host memory
    (gloo's send and receive take CPU tensors). Counts the payload sent."""
    dev = payload.device
    staged = group.backend == "gloo" and dev.type != "cpu"
    send = payload.cpu() if staged else payload.contiguous()
    recv = torch.empty_like(send)
    # a group's ranks are the world's first ranks: group rank = global rank
    ops = [dist.P2POp(dist.isend, send, (group.rank + 1) % group.size, group.pg),
           dist.P2POp(dist.irecv, recv, (group.rank - 1) % group.size, group.pg)]
    works = dist.batch_isend_irecv(ops)
    group.sent_bytes += send.numel() * send.element_size()
    return Pending(works, (lambda: recv.to(dev)) if staged else (lambda: recv))


def reduce_scatter_columns_steps(partial: torch.Tensor, group,
                                 compress: bool = False) -> Steps:
    """:func:`reduce_scatter_columns` as steps: one operation a hop."""
    if group is None:
        return partial
    x = partial.float()
    tp = group.size
    if tp == 1:
        return x
    lead, f = x.shape[:-1], x.shape[-1]
    if f % tp:
        raise ValueError(f"reduce_scatter_columns: feature dim {f} is not divisible by "
                         f"tp={tp}: row-parallel partials must split into whole chunks")
    c = f // tp
    if compress:
        _require_q80_blocks(c, "reduce_scatter_columns(compress=True)")

    def chunk(h: int) -> torch.Tensor:
        k = (group.rank + tp - 1 - h) % tp
        return x[..., k * c:(k + 1) * c]

    acc = chunk(0)
    for hop in range(1, tp):
        if compress:
            wire = q80_decode((yield _start_ring_hop(q80_encode(acc), group)), c)
        else:
            wire = yield _start_ring_hop(acc, group)
        acc = wire + chunk(hop)
    return acc


def reduce_scatter_columns(partial: torch.Tensor, group, compress: bool = False) -> torch.Tensor:
    """Sum f32 partials ``[..., f]`` across ``group`` and return this rank's
    fully reduced chunk ``[..., f / size]`` (chunk ``rank``; identity
    without a group, the f32 partial itself at size 1).

    The ring has a PINNED order: rank i seeds its accumulator with its own
    chunk (i + size - 1) % size; on hop h every accumulator moves one step
    round the ring (i -> i + 1) and the receiver adds its chunk (i + size -
    1 - h) % size. After size - 1 hops rank i holds chunk i summed in ring
    order p[i+1], p[i+2], ..., p[i], the same bits run to run.
    ``compress``: each hop's accumulator goes as one Q80 payload (int8
    quants and the bytes of the f32 block scales, the gathers' wire),
    dequantized and added in f32 on arrival; an element's error is at most
    the sum over hops of half that hop's block scale."""
    return drive(reduce_scatter_columns_steps(partial, group, compress))
