"""Mixture-of-experts FFN (Grok-1 / Mixtral).

Reference semantics (`distributed-llama/src/grok1-tasks.cpp:56-243`):
router logits -> softmax over ALL experts -> top-k (k = n_active_experts)
-> selected probs renormalized to sum 1 -> per selected expert:
``down_e( up_e(x) * act(gate_e(x)) )`` weighted-summed.

The port of ``dllama_tpu/models/moe.py``, with its tensor-parallel
branches: quantized (``tp``: every expert plane an output shard,
``parallel.quant_tp``) and dense (``dense``: ``parallel.sharding``'s
column/row shards, with the expert axis over ``ep`` on a grid). Two compute
paths, as there:

* Dense combine (dense stacks, or quantized ones at T * k >= E): every
  expert runs, and a [.., E] weight matrix that is zero off the top-k
  combines them. The expert index is a host loop index, so a quantized
  expert is the view ``w[e]`` through the ordinary K1/K3 launches (the
  decode GEMV up to 8 rows, the tile beyond).
* Selected (quantized stacks, a 2-D input and T * k < E: solo decode,
  batched decode at B <= 3 and verify steps at T <= 3 for E = 8, k = 2):
  only the union of the rows' top-k experts runs, picked on the device.
  Its indices never reach the host: the expert-indexed launches of K1 and
  K3 (``qmatmul.q40_matmul_stacked`` / ``q80_matmul_stacked``) read them
  from device memory, one launch for every picked expert's up|gate and one
  for their downs, so the step captures in a CUDA graph and makes no host
  sync.

Under ``tp`` each path gathers twice, like the dense FFN: the experts'
hidden slices (the selected path: all picked experts' in one collective)
before the downs, and the combined output slice at the end (JAX
``moe.py:185,197,237,241``). Dense under ``tp``, the dense combine runs on
the rank's slice of the hidden of each expert it holds (all of them, or its
n_experts / ep on a grid), its combine weights cut to those experts, and one
``reduce_columns`` over the whole grid sums the partial outputs: what the
JAX package's GSPMD partitions from the same einsums. Routing stays
replicated, in f32, on the same bits on every rank.

Training (``moe_ffn_train``) runs the dense combine under autograd, as the
JAX package's ``forward_train`` does; on a mesh's ``ep x tp`` plane the
rank's experts and hidden slice give partial outputs summed by the
differentiable ``grad_collectives.reduce_from``, and the input and the
combine weights enter through ``copy_to``, so their gradients (the router's
with them) are the plane's sums on every rank.

Top-k order: ``jax.lax.top_k`` puts the lowest index first among equal
values. A stable descending sort does the same (``torch.topk`` promises
no order among ties). The order matters beyond the indices: the selected
path accumulates its experts one by one in the activation dtype, in the
union's order, as the JAX package does.
"""

from __future__ import annotations

import torch

from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.activations import ACTIVATIONS
from dllama_tpu_torch.ops.qmatmul import QuantTensor, matmul_any, slice_to_in_features
from dllama_tpu_torch.parallel.collectives import gather_columns, reduce_columns
from dllama_tpu_torch.parallel.grad_collectives import copy_to, reduce_from


def top_k(v: torch.Tensor, k: int) -> tuple:
    """(values, int64 indices) of the ``k`` largest entries along the last
    axis, ties broken lowest index first — ``jax.lax.top_k``'s order."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(cfg: ModelConfig, router_kernel: torch.Tensor, xb: torch.Tensor) -> tuple:
    """Top-k routing -> (indices [..., k] int64, renormalized weights
    [..., k] f32). Router math runs in f32, like the reference (router
    matmul outputs F32, `distributed-llama/src/grok1-tasks.cpp:56-60`);
    selected probabilities are renormalized to sum 1 (`:99-114`). Both
    compute paths route through here, so decode and prefill agree."""
    logits = xb.float() @ router_kernel.float()  # [..., E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, cfg.n_active_experts)
    return topi, topv / topv.sum(dim=-1, keepdim=True)


def route(cfg: ModelConfig, router_kernel: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Top-k routing -> dense combine weights [..., E] f32 (zeros off the
    top-k)."""
    topi, weights = route_topk(cfg, router_kernel, xb)
    zeros = torch.zeros((*topi.shape[:-1], cfg.n_experts), dtype=torch.float32,
                        device=xb.device)
    return zeros.scatter(-1, topi, weights)


def flat_experts(qt: QuantTensor) -> QuantTensor:
    """A layer-stacked expert stack [L, E, ...] (or a per-layer one [E,
    ...]) as one flat stack [n, ...] of planes, for the indexed launches:
    views of the same memory."""
    def flat(a):
        return a.reshape(-1, *a.shape[-2:])

    s2 = flat(qt.s2) if qt.kind == "q40" else qt.s2.reshape(-1)
    return QuantTensor(flat(qt.w), flat(qt.s), s2, qt.kind, qt.k_logical)


def _expert_up(xb: torch.Tensor, w, layer=None) -> torch.Tensor:
    """``xb [..., D] x w [E, D, H] -> [..., E, H]``; ``w`` a dense stack or
    a quantized one ([L, E, ...] with ``layer``), one launch per expert on
    its view."""
    if not isinstance(w, QuantTensor):
        return torch.einsum("...d,edh->...eh", xb, w)
    w = w if layer is None else w.layer(layer)
    lead = xb.shape[:-1]
    x2 = xb.reshape(-1, xb.shape[-1])
    outs = torch.stack([matmul_any(x2, w, e) for e in range(w.w.shape[0])])
    return outs.transpose(0, 1).reshape(*lead, outs.shape[0], outs.shape[-1])


def _expert_down(h: torch.Tensor, w, layer=None) -> torch.Tensor:
    """``h [..., E, H] x w [E, H, D] -> [..., E, D]`` (dense or quantized)."""
    if not isinstance(w, QuantTensor):
        return torch.einsum("...eh,ehd->...ed", h, w)
    w = w if layer is None else w.layer(layer)
    lead = h.shape[:-2]
    E, H = h.shape[-2], h.shape[-1]
    hm = h.reshape(-1, E, H).transpose(0, 1)  # [E, N, H]
    outs = torch.stack([matmul_any(hm[e], w, e) for e in range(E)])
    return outs.transpose(0, 1).reshape(*lead, E, outs.shape[-1])


def _moe_decode_selected(cfg: ModelConfig, lp: dict, xb: torch.Tensor, layer, tp=None,
                         tp_compress: bool = False) -> torch.Tensor:
    """Small-T decode/verify with quantized experts: run only the union of
    the rows' top-k experts. ``T * k`` bounds the union, so the top ``cap
    = min(E, T * k)`` column maxima of the combine weights cover it; slots
    past it (ties among zero columns) carry zero weight for every row and
    add nothing. Each picked expert's planes are read at ``base +
    expert_ids[j]`` by the expert-indexed launch: one for every expert's
    up|gate (the input shared), one for their downs (each its own hidden).
    The downs accumulate in the activation dtype in the union's order, as
    the JAX package's scan does."""
    act = ACTIVATIONS[cfg.hidden_act]
    E, k = cfg.n_experts, cfg.n_active_experts
    T = xb.shape[0]
    cap = min(E, T * k)
    combine = route(cfg, lp["moe_router"], xb)  # [T, E] f32, zero off top-k
    _, expert_ids = top_k(combine.max(dim=0).values, cap)  # [cap]
    ids = expert_ids.to(torch.int32)
    base = 0 if layer is None else layer * E

    fused = "moe_upgate" in lp
    up = flat_experts(lp["moe_upgate" if fused else "moe_up"])
    down = flat_experts(lp["moe_down"])
    if fused:
        ug = matmul_any(xb, up, ids, base)  # [cap, T, 2H]
        half = ug.shape[-1] // 2
        hs = ug[..., :half] * act(ug[..., half:])
    else:
        gate = flat_experts(lp["moe_gate"])
        hs = matmul_any(xb, up, ids, base) * act(matmul_any(xb, gate, ids, base))
    hs = gather_columns(hs, tp, tp_compress)  # [cap, T, whole hidden] in one gather
    d = matmul_any(hs, down, ids, base)  # [cap, T, D] (this rank's D / tp under tp)
    w_sel = combine.index_select(1, expert_ids).to(xb.dtype)  # [T, cap]
    acc = torch.zeros((T, d.shape[-1]), dtype=xb.dtype, device=xb.device)
    for j in range(cap):
        acc = acc + d[j] * w_sel[:, j:j + 1]
    return gather_columns(acc, tp, tp_compress)


def _moe_dense_tp(cfg: ModelConfig, lp: dict, xb: torch.Tensor, tp) -> torch.Tensor:
    """The dense combine on a rank's dense shards: its experts' up/gate
    hidden slices, their downs' partial outputs weighted by the rank's
    columns of the combine weights, then one f32 all-reduce over the grid
    (``tp.grid``), cast back to the activation dtype."""
    act = ACTIVATIONS[cfg.hidden_act]
    combine = route(cfg, lp["moe_router"], xb).to(xb.dtype)  # [..., E]
    held = lp["moe_down"].shape[0]
    lo = tp.ep_rank * held
    h = _expert_up(xb, lp["moe_up"]) * act(_expert_up(xb, lp["moe_gate"]))
    part = torch.einsum("...ed,...e->...d", _expert_down(h, lp["moe_down"]),
                        combine[..., lo:lo + held])
    return reduce_columns(part.float(), tp.grid).to(xb.dtype)


def moe_ffn(cfg: ModelConfig, lp: dict, xb: torch.Tensor, layer=None, tp=None,
            tp_compress: bool = False, dense: bool = False) -> torch.Tensor:
    """MoE FFN over xb [..., dim] -> [..., dim].

    ``lp`` holds moe_router [dim, E], moe_up/moe_gate [E, dim, hidden] (or
    the fused moe_upgate [E, dim, 2 hidden]) and moe_down [E, hidden, dim],
    each expert stack dense or quantized. With ``layer`` (a host int), the
    quantized stacks are layer-stacked [L, E, ...] and the dense leaves are
    that layer's already, as in the JAX package's layer scan; the forward
    passes each layer's views and no ``layer``. The selected path needs
    quantized stacks, a 2-D ``xb`` and T * k < E — the JAX package's gate
    (its layer scan always has a layer index; the port's forward always
    hands quantized experts over as that layer's views). ``tp``,
    ``tp_compress``: a tensor-parallel rank's expert shards, gathered as the
    module docstring says; ``dense``: its dense shards, all-reduced."""
    if dense:
        return _moe_dense_tp(cfg, lp, xb, tp)
    act = ACTIVATIONS[cfg.hidden_act]
    up_names = ("moe_upgate",) if "moe_upgate" in lp else ("moe_up", "moe_gate")
    quant_experts = all(isinstance(lp.get(n), QuantTensor) for n in up_names + ("moe_down",))
    if (quant_experts and xb.dim() == 2
            and xb.shape[0] * cfg.n_active_experts < cfg.n_experts):
        return _moe_decode_selected(cfg, lp, xb, layer, tp, tp_compress)

    combine = route(cfg, lp["moe_router"], xb).to(xb.dtype)  # [..., E]
    if "moe_upgate" in lp:  # fused up|gate expert stacks (llama.fuse_qkv_ffn)
        ug = _expert_up(xb, lp["moe_upgate"], layer)
        half = ug.shape[-1] // 2
        h = ug[..., :half] * act(ug[..., half:])
    else:
        h = _expert_up(xb, lp["moe_up"], layer) * act(_expert_up(xb, lp["moe_gate"], layer))
    h = slice_to_in_features(gather_columns(h, tp, tp_compress), lp["moe_down"])
    down = _expert_down(h, lp["moe_down"], layer)
    return gather_columns(torch.einsum("...ed,...e->...d", down, combine), tp, tp_compress)


def moe_ffn_train(cfg: ModelConfig, lp: dict, xb: torch.Tensor, grid=None) -> torch.Tensor:
    """The dense combine under autograd on dense expert stacks: the whole
    FFN without a mesh (``moe_ffn``'s dense path), or a rank's part on a
    mesh's ``ep x tp`` plane: its ``n_experts / ep`` experts' hidden slices
    weighted by their columns of the combine weights, summed over the plane.
    Routing runs replicated in f32 on every rank."""
    plane = None if grid is None else grid.group("ep", "tp")
    if plane is None:
        return moe_ffn(cfg, lp, xb)
    act = ACTIVATIONS[cfg.hidden_act]
    combine = copy_to(route(cfg, lp["moe_router"], xb).to(xb.dtype), plane)  # [..., E]
    held = lp["moe_down"].shape[0]
    lo = grid.index("ep") * held
    xin = copy_to(xb, plane)
    h = _expert_up(xin, lp["moe_up"]) * act(_expert_up(xin, lp["moe_gate"]))
    part = torch.einsum("...ed,...e->...d", _expert_down(h, lp["moe_down"]),
                        combine[..., lo:lo + held])
    return reduce_from(part.float(), plane).to(xb.dtype)
