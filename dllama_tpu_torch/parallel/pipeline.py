"""Pipeline parallelism: the layer stack cut into stages over a mesh's
``pp`` axis, run on the GPipe microbatch schedule (the port of
``dllama_tpu/parallel/pipeline.py``).

Each rank holds ``n_layers / S`` consecutive layers (the stacked layer
leaves cut on their leading axis, ``sharding.shard_mesh_params``). The
batch is cut into ``M`` microbatches and the schedule runs ``M + S - 1``
ticks: stage 0 ingests a fresh microbatch on each of the first ``M`` ticks,
every stage runs its layers on what it holds and hands the result to the
next stage with one ``grad_collectives.ring_shift``, and the last stage
finishes a microbatch on each of the final ``M`` ticks. Its outputs reach
every stage through ``grad_collectives.group_sum`` of the outputs masked to
the last stage, as the JAX package's ``psum``. The bubble is the usual
(S - 1) / (M + S - 1) of the ticks.

A stage with no microbatch on a tick (the bubble) runs no layers: it hands
on its input times zero, and stage 0 adds zero times what it received to
each microbatch it ingests (JAX's ``where(idx == 0, xt, buf)``). That keeps, as the JAX package's masks keep, every
shift's output on a path to the loss on every rank, so every rank runs
every shift's backward, in one order (see ``grad_collectives``). The
embedding and the head run outside the pipeline on every rank; the
embedding's gradient lands on stage 0 alone and the training step sums it
over ``pp`` (``runtime.train.sync_grads``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel.grad_collectives import group_sum, ring_shift


def pipeline_forward_train(cfg: ModelConfig, params: dict, tokens, grid, rope: dict = None,
                           n_microbatches: int = None, remat: bool = False) -> torch.Tensor:
    """Cache-free causal forward with the layers pipelined over ``grid``'s
    ``pp`` axis: logits [B / dp, T, vocab] f32 of this rank's ``dp`` rows,
    equal to ``llama.forward_train`` within rounding. ``tokens`` is the
    whole batch [B, T]; ``params`` holds the rank's stage of the layers.
    ``remat``: each stage's layers run under activation checkpointing
    (``torch.utils.checkpoint``, recomputed in the backward pass).

    Requires ``n_layers % S == 0`` and ``B % n_microbatches == 0`` (of the
    rank's rows), and no ``sp`` or ``tp`` axis."""
    S = grid.size("pp") if grid is not None else 1
    if grid is not None and grid.size("sp", "tp", "ep") > 1:
        raise ValueError("the pipeline runs its stages on whole layers: no sp, tp or ep axis")
    dev = params["embedding"].device
    tokens = torch.as_tensor(tokens, device=dev)
    rows, _ = llama.train_block(grid, *tokens.shape)
    tokens = tokens[rows]
    B, T = tokens.shape
    M = n_microbatches if n_microbatches is not None else max(S, 1)
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={S}")
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    cos, sin = llama.train_rope(cfg, rope if rope is not None else llama.rope_tables(cfg, dev),
                                0, T)
    layers = params["layers"]
    n_local = layers["wq"].shape[0]
    if n_local != cfg.n_layers // S:
        raise ValueError(f"a stage holds {n_local} layers where pp={S} gives "
                         f"{cfg.n_layers // S}: pass the rank's stage")

    def stage(h):
        for i in range(n_local):
            h = llama.train_layer(cfg, llama._layer_params(layers, i), cos, sin, h)
        return h

    pp = None if grid is None else grid.group("pp")
    idx = 0 if grid is None else grid.index("pp")
    xs = llama.embed(cfg, params, tokens).reshape(M, B // M, T, cfg.dim)
    # a leaf that needs grad: every hand-off then carries one on every rank
    buf = torch.zeros_like(xs[0]).requires_grad_(True)
    outs = []
    for t in range(M + S - 1):
        if 0 <= t - idx < M:  # this stage holds microbatch t - idx
            inp = xs[t] + 0.0 * buf if idx == 0 else buf
            out = checkpoint(stage, inp, use_reentrant=False) if remat else stage(inp)
        else:
            out = buf * 0.0
        outs.append(out)
        if t < M + S - 2:  # the last tick's hand-off would be read by no one
            buf = ring_shift(out, pp)
    finished = torch.stack(outs[S - 1:])
    mask = 1.0 if idx == S - 1 else 0.0
    y = group_sum(finished * mask, pp).reshape(B, T, cfg.dim)
    return llama.train_logits(cfg, params, y)
