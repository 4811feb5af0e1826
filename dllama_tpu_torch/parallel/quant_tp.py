"""Output-sharded quantized weights: the port of the gather-only scheme of
``dllama_tpu/parallel/quant_tp.py``.

Every quantized matrix, and each of its planes (packed bits ``w``, scale
planes ``s``/``s2``), is sharded on its OUTPUT axis; the packed K axis is
never split, so every shard keeps the K layout the kernels (K1, K3 and
their expert-indexed forms) take for the whole matrix. Each output element
is computed from the full K on one rank: no partial sums, and the only
communication is the activation all-gathers of ``parallel.collectives``,
four a layer (the attention heads, wo's output, the FFN hidden, w2's
output), then the logits when the vocab shards. MoE expert stacks shard
like their dense twins: every rank holds a 1/tp output slice of every
expert (the reference's scheme,
`distributed-llama/src/transformer.cpp:479-487`).

Lane alignment, kept from the JAX package: the FFN hidden axis pads to
``ffn_padded_width`` = lcm(K_MULTIPLE, 128·tp) on w1/w3's output and on
w2's packed input alike, so the gathered hidden feeds w2 as it is; a
sharded wcls pads its vocab to a multiple of 128·tp and the forward slices
the gathered logits back to ``vocab_size`` (a zero logit in the pad would
beat real negative ones in an argmax). Pad columns and rows carry zero
scales and contribute exactly 0. The Hopper kernels need no other width:
they take any output width and a K that is a multiple of 64.

Row-parallel mode (``--tp-reduce``), kept from the JAX package: ``wo`` and
``w2`` alone shard their K (input) axis instead, so they take the rank's
own heads and its own slice of the FFN hidden with no gather, and give
full-width f32 partial sums that ``collectives.reduce_scatter_columns``
adds on a ring. Each K chunk is packed on its own (:func:`row_shard_quant_leaf`:
the chunk's K padded to ``K_MULTIPLE`` with inert zero-scale rows), so a
rank's shard is an ordinary QuantTensor whose ``k_logical`` is the chunk;
a chunk must hold whole scale rows (64 input rows for Q40's twin scale
planes, 32 for Q80), which :func:`validate_tp_reduce` checks.

The port fuses wq|wk|wv into ``wqkv``, w1|w3 into ``w13`` and
moe_up|moe_gate into ``moe_upgate`` (``models.llama.fuse_qkv_ffn``). A
slice of a fused tensor's output axis would give rank 0 all of q and none
of k or v, so sharding always works on the parts: :func:`shard_params`
splits a fused leaf into its parts, shards each, and returns the rank's
unfused parts for the caller to fuse.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.qmatmul import K_MULTIPLE, QuantTensor, _pad_up

#: per-layer matrices that shard their output axis
SHARDED_MATRICES = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "moe_up", "moe_gate", "moe_down"}
)
#: the port's fused projections and their parts, in output order
FUSED_PARTS = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3"),
               "moe_upgate": ("moe_up", "moe_gate")}
#: matrices whose output axis is the FFN hidden (lane-padded under tp)
HIDDEN_OUT = frozenset({"w1", "w3", "moe_up", "moe_gate"})
#: matrices whose packed input axis is the FFN hidden
HIDDEN_IN = frozenset({"w2", "moe_down"})
#: matrices that K-shard (row-parallel) under ``--tp-reduce``: the two whose
#: inputs the preceding matmuls leave sharded (a rank's heads feed wo, its
#: up/gate slice feeds w2)
ROW_SHARDED_MATRICES = frozenset({"wo", "w2"})
#: K rows one scale-plane row covers: Q40's s/s2 twins each span half of a
#: 64-row superblock, a Q80 scale one 32-row block
ROW_SHARD_GRANULARITY = {"q40": 64, "q80": 32}
#: the ROADMAP item that holds what this slice leaves out
NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 8)"


def check_tp_compatible(cfg: ModelConfig, n_tp: int) -> None:
    if cfg.n_kv_heads % n_tp != 0:
        raise ValueError(
            f"tp={n_tp} must divide n_kv_heads={cfg.n_kv_heads} "
            "(the reference's nSlices<=nKvHeads constraint)"
        )
    if cfg.hidden_dim % n_tp != 0:
        raise ValueError(f"tp={n_tp} must divide hidden_dim={cfg.hidden_dim}")


def validate_quant_tp(cfg: ModelConfig, n_tp: int) -> None:
    check_tp_compatible(cfg, n_tp)
    if cfg.dim % n_tp or cfg.kv_dim % n_tp:
        raise ValueError(f"tp={n_tp} must divide dim={cfg.dim} and kv_dim={cfg.kv_dim}")


def ffn_padded_width(cfg: ModelConfig, kind: str, n_tp: int) -> int:
    return _pad_up(cfg.hidden_dim, math.lcm(K_MULTIPLE[kind], 128 * n_tp))


def row_shard_chunk_k(cfg: ModelConfig, name: str, kind: str, n_tp: int) -> int:
    """Logical K rows each rank's row shard of ``name`` takes: wo the local
    head concat (dim / tp), w2 the local slice of the lane-padded hidden
    that w1/w3 give (ffn_padded_width / tp)."""
    base = cfg.dim if name == "wo" else ffn_padded_width(cfg, kind, n_tp)
    return base // n_tp


def validate_tp_reduce(cfg: ModelConfig, kind: str, n_tp: int):
    """None when row-parallel wo/w2 can engage, else the reason it declines
    (the Engine's warning, and ``/stats``)."""
    if cfg.is_moe:
        return ("moe: row-parallel reduce needs a dense FFN (the "
                "selected-experts union spans all rows)")
    for name in sorted(ROW_SHARDED_MATRICES):
        chunk = row_shard_chunk_k(cfg, name, kind, n_tp)
        gran = ROW_SHARD_GRANULARITY[kind]
        if chunk % gran:
            return (f"{name}: per-shard K {chunk} off the {kind} slicing "
                    f"granularity {gran} (scale planes cover {gran} input "
                    f"rows; need dim and the padded hidden divisible by "
                    f"{gran}*tp)")
    return None


def shards_wcls(cfg: ModelConfig, n_tp: int) -> bool:
    """wcls shards (and the logits are gathered) only when tp divides the
    vocab; otherwise every rank holds it whole and computes every logit."""
    return cfg.vocab_size % n_tp == 0


def padded_out(name: str, cfg: ModelConfig, kind: str, n_tp: int, width: int) -> int:
    """The output width of matrix ``name`` (``width`` unpadded) before it is
    cut into ``n_tp`` shards."""
    if n_tp <= 1:
        return width
    if name in HIDDEN_OUT:
        return ffn_padded_width(cfg, kind, n_tp)
    if name == "wcls" and shards_wcls(cfg, n_tp):
        return _pad_up(cfg.vocab_size, 128 * n_tp)
    return width


def is_sharded(name: str, cfg: ModelConfig, n_tp: int) -> bool:
    return name in SHARDED_MATRICES or (name == "wcls" and shards_wcls(cfg, n_tp))


def shard_bounds(width: int, rank: int, size: int) -> tuple:
    """[start, stop) of ``rank``'s shard of an output axis of ``width``."""
    if width % size:
        raise ValueError(f"an output axis of {width} does not split into {size} shards")
    per = width // size
    return rank * per, (rank + 1) * per


def kv_head_bounds(cfg: ModelConfig, rank: int, size: int) -> tuple:
    """[start, stop) of the kv heads whose K/V ``rank`` computes and caches:
    wk and wv shard their output axis (kv_dim = n_kv_heads x head_size) as
    :func:`shard_params` cuts them, in rank order."""
    lo, hi = shard_bounds(cfg.kv_dim, rank, size)
    return lo // cfg.head_size, hi // cfg.head_size


def _pad_axis(arr, axis: int, target: int):
    """``arr`` (numpy or torch) zero-padded on ``axis`` to ``target``; an
    empty placeholder plane (q80's s2) stays as it is."""
    if arr.ndim == 0 or arr.shape[axis] in (0, target):
        return arr
    extra = target - arr.shape[axis]
    if isinstance(arr, np.ndarray):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, extra)
        return np.pad(arr, pad)
    shape = list(arr.shape)
    shape[axis] = extra
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _pad_last(arr, target: int):
    return _pad_axis(arr, -1, target)


def _pad_qt_out(qt: QuantTensor, target_o: int) -> QuantTensor:
    return QuantTensor(_pad_last(qt.w, target_o), _pad_last(qt.s, target_o),
                       _pad_last(qt.s2, target_o), qt.kind, qt.k_logical)


def _pad_qt_in(qt: QuantTensor, target_k: int) -> QuantTensor:
    """Extend the packed K axis with zero-scale rows (inert: zero scales x
    anything = 0), e.g. w2's input to the padded FFN width."""
    if qt.kind == "q40":
        return QuantTensor(_pad_axis(qt.w, -2, target_k // 2), _pad_axis(qt.s, -2, target_k // 64),
                           _pad_axis(qt.s2, -2, target_k // 64), qt.kind, qt.k_logical)
    return QuantTensor(_pad_axis(qt.w, -2, target_k), _pad_axis(qt.s, -2, target_k // 32),
                       qt.s2, qt.kind, qt.k_logical)


def zero_quant(kind: str, k_padded: int, width: int, k_logical: int) -> QuantTensor:
    """An all-padding host QuantTensor [k_padded, width]: a rank whose shard
    lies wholly past the file's rows (a padded vocab's last shard)."""
    f32 = np.float32
    if kind == "q40":
        return QuantTensor(np.zeros((k_padded // 2, width), np.uint8),
                           np.zeros((k_padded // 64, width), f32),
                           np.zeros((k_padded // 64, width), f32), kind, k_logical)
    return QuantTensor(np.zeros((k_padded, width), np.int8), np.zeros((k_padded // 32, width), f32),
                       np.zeros((0,), f32), kind, k_logical)


def prepare_quant_leaf(name: str, leaf, cfg: ModelConfig, n_tp: int):
    """Lane-align one param leaf for tp (see above). Identity for dense
    arrays, unsharded matrices, already-aligned dims and n_tp 1."""
    if not isinstance(leaf, QuantTensor) or n_tp <= 1:
        return leaf
    if name in HIDDEN_OUT:
        return _pad_qt_out(leaf, ffn_padded_width(cfg, leaf.kind, n_tp))
    if name in HIDDEN_IN:
        return _pad_qt_in(leaf, ffn_padded_width(cfg, leaf.kind, n_tp))
    if name == "wcls" and shards_wcls(cfg, n_tp):
        return _pad_qt_out(leaf, _pad_up(cfg.vocab_size, 128 * n_tp))
    return leaf


def row_shard_quant_leaf(name: str, leaf: QuantTensor, cfg: ModelConfig, rank: int,
                         size: int) -> QuantTensor:
    """``rank``'s K chunk of ``wo`` or ``w2`` for row-parallel execution:
    logical input rows [rank·chunk, (rank + 1)·chunk) of every plane (w2
    first padded to the FFN's padded width), the chunk's K padded to
    ``K_MULTIPLE`` on its own with zero-scale rows, ``k_logical`` the
    chunk. The JAX package's ``row_shard_quant_leaf`` packs every chunk so
    and concatenates them on the packed K axis: this is that pack's
    ``rank``-th piece, bit for bit. Planes stay where they are (numpy or
    torch), copied out."""
    kind = leaf.kind
    chunk = row_shard_chunk_k(cfg, name, kind, size)
    gran = ROW_SHARD_GRANULARITY[kind]
    if chunk % gran:
        raise ValueError(f"row-parallel {name}: per-shard K {chunk} is not a multiple of the "
                         f"{kind} scale-plane granularity {gran}: the K slice would split a "
                         f"superblock (use validate_tp_reduce to gate)")
    kp_shard = _pad_up(chunk, K_MULTIPLE[kind])
    if name == "w2":
        leaf = _pad_qt_in(leaf, ffn_padded_width(cfg, kind, size))

    def cut(plane, per: int):  # ``per``: logical K rows a plane row covers
        part = _pad_axis(plane[..., rank * chunk // per:(rank + 1) * chunk // per, :], -2,
                         kp_shard // per)
        return np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part.contiguous()

    if kind == "q40":
        return QuantTensor(cut(leaf.w, 2), cut(leaf.s, 64), cut(leaf.s2, 64), kind, chunk)
    return QuantTensor(cut(leaf.w, 1), cut(leaf.s, 32), leaf.s2, kind, chunk)


def shard_quant_leaf(leaf: QuantTensor, rank: int, size: int) -> QuantTensor:
    """``rank``'s slice of the output axis of every plane (``w``, ``s``,
    ``s2``) of ``leaf``, copied out (numpy or torch, where the planes are),
    so the whole leaf can be freed; empty placeholder planes stay as they
    are. The counterpart of the JAX package's output-axis partition specs
    plus ``device_put``."""
    def cut(a):
        if a.ndim == 0 or a.shape[-1] == 0:
            return a
        lo, hi = shard_bounds(a.shape[-1], rank, size)
        part = a[..., lo:hi]
        return np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part.contiguous()

    return QuantTensor(cut(leaf.w), cut(leaf.s), cut(leaf.s2), leaf.kind, leaf.k_logical)


def shard_leaf(name: str, leaf, cfg: ModelConfig, rank: int, size: int,
               tp_reduce: bool = False):
    """One unfused leaf of a full model -> ``rank``'s leaf: lane-aligned,
    then output-sharded when ``name`` shards; replicated leaves (embedding,
    norms, the MoE router, an unsharded wcls) pass through. ``tp_reduce``:
    wo and w2 take their K chunk instead (:func:`row_shard_quant_leaf`)."""
    if tp_reduce and name in ROW_SHARDED_MATRICES and isinstance(leaf, QuantTensor):
        return row_shard_quant_leaf(name, leaf, cfg, rank, size)
    leaf = prepare_quant_leaf(name, leaf, cfg, size)
    if not is_sharded(name, cfg, size):
        return leaf
    if not isinstance(leaf, QuantTensor):
        raise ValueError(f"tensor parallelism takes quantized (q40/q80) matrices; {name} is "
                         f"dense: dense-weight TP is {NOT_PORTED}")
    return shard_quant_leaf(leaf, rank, size)


def _split_out(qt: QuantTensor, widths: tuple) -> list:
    """A fused QuantTensor's parts, as views of its planes."""
    out, lo = [], 0
    for w in widths:
        out.append(QuantTensor(qt.w[..., lo:lo + w], qt.s[..., lo:lo + w],
                               qt.s2 if qt.s2.shape[-1] == 0 else qt.s2[..., lo:lo + w],
                               qt.kind, qt.k_logical))
        lo += w
    return out


def shard_params(params: dict, cfg: ModelConfig, rank: int, size: int,
                 tp_reduce: bool = False) -> dict:
    """``rank``'s params of a ``size``-way tensor-parallel model from the
    full ``params`` (numpy or torch planes, fused or not): fused
    projections come back as their unfused parts, each sharded, for the
    caller to fuse (``llama.fuse_qkv_ffn``; the Engine does). The same
    full params give every rank exactly its slice. ``tp_reduce``: wo and w2
    are the rank's row shards (the caller checks ``validate_tp_reduce``
    first; a misfit raises)."""
    validate_quant_tp(cfg, size)
    widths = {"wqkv": (cfg.dim, cfg.kv_dim, cfg.kv_dim), "w13": (cfg.hidden_dim,) * 2,
              "moe_upgate": (cfg.hidden_dim,) * 2}
    layers = {}
    for name, leaf in params["layers"].items():
        if name in FUSED_PARTS:
            for part, sub in zip(FUSED_PARTS[name], _split_out(leaf, widths[name])):
                layers[part] = shard_leaf(part, sub, cfg, rank, size)
        else:
            layers[name] = shard_leaf(name, leaf, cfg, rank, size, tp_reduce)
    return {"embedding": params["embedding"], "rms_final": params["rms_final"],
            "wcls": shard_leaf("wcls", params["wcls"], cfg, rank, size), "layers": layers}


def check_shards(params: dict, cfg: ModelConfig, size: int, tp_reduce: bool = False) -> None:
    """Raise unless ``params`` hold one rank's quantized shards of a
    ``size``-way model: wo's output width dim / size, or, with ``tp_reduce``,
    wo's row shard (K dim / size, dim outputs). A whole model handed to a
    tensor-parallel engine would compute garbage, not fail."""
    wo = params["layers"].get("wo")
    if not isinstance(wo, QuantTensor):
        raise ValueError(f"tensor parallelism takes quantized (q40/q80) weights; dense-weight "
                         f"TP is {NOT_PORTED}")
    if tp_reduce:  # at size 1 a row shard and an output shard are the whole wo
        if (wo.in_features, wo.out_features) != (cfg.dim // size, cfg.dim):
            raise ValueError(f"wo is [{wo.in_features}, {wo.out_features}] where a rank's row "
                             f"shard of a tp={size} model is [{cfg.dim // size}, {cfg.dim}]: "
                             f"shard with tp_reduce (quant_tp.shard_params, or load with "
                             f"tp= and tp_reduce=)")
        return
    if wo.out_features != cfg.dim // size:
        raise ValueError(f"wo has {wo.out_features} output columns where a rank of a tp={size} "
                         f"model holds {cfg.dim // size}: pass this rank's shard "
                         f"(quant_tp.shard_params, or load with tp=)")
