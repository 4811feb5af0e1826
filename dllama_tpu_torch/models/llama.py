"""Llama-family transformer — dense Llama and the mixture-of-experts archs
Mixtral and Grok-1 — the solo, batched and verify forward passes.

The JAX package scans a jitted layer step over stacked parameters; here the
forward is a Python loop over a layer index, with stacked parameter leaves
(``[L, ...]`` tensors, or QuantTensors whose planes carry a leading L axis)
indexed as views — the TPU's scalar-prefetched layer selection becomes a
pointer offset. The KV cache ``[L, S, kv, hd]`` is written in place where the
JAX forward returns an updated (donated) cache.

Math parity notes:
* rmsnorm eps semantics: `distributed-llama/src/funcs.cpp:94-123`.
* attention: `distributed-llama/src/llama2-tasks.cpp:54-94` (see ops.attention).
* SwiGLU: ``w2( act(w1 x) * (w3 x) )`` — `distributed-llama/src/llama2-tasks.cpp:158-189`.
* MoE FFN (mixtral, grok1): ``models.moe`` — its expert stacks are ``[L,
  E, ...]`` leaves, each layer's ``[E, ...]`` view handed to ``moe_ffn``.
* logits: final rmsnorm then ``wcls`` matmul — `distributed-llama/src/llama2-tasks.cpp:222-241`.

Weights use kernel layout ``[in_features, out_features]`` (transposed from the
file's ``[out, in]`` rows). Decode steps (T <= 16) take one launch for q's
rope, K's rope and the cache write (reading q, k and v straight from the
projection output) and flash-decode attention; prefill (T > 16) takes
``apply_rope``, a slice assignment and ``gqa_attention`` — the split the JAX
package's kernel gates make.

``forward_batched`` is one decode step for B independent sequences over a
batch cache ``[L, B, S, kv, hd]``, each at its own position (a device
vector): the projections are ordinary [B, K] matmuls, and rope, the cache
write and attention are per row, through the batched launch forms of the
same two kernels.

``forward_decode`` is the solo decode step in that form: ``forward_batched``
at B = 1 on the solo cache's ``[:, None]`` view, the position a device
int32 [1], bit-equal to ``forward`` at T = 1. It is the step the engine's
CUDA graphs capture (``runtime.graphs``).

Tensor parallelism (``tp``, a ``parallel.group.TPGroup``, in ``forward``,
``forward_batched`` and ``forward_batched_verify``): the JAX forward's
``tp_axis`` branches. Every quantized matrix is an output shard
(``parallel.quant_tp``), so a rank's heads, kv heads and FFN hidden are its
slice; the activations are gathered whole after each output-sharded matmul
(four gathers a layer, then the logits), so everything between the gathers
is replicated and every rank holds the same residual stream.
``quant_params_from_reader(..., tp=)`` loads a rank's shard. With
``tp_reduce`` (``--tp-reduce``) wo and w2 are row shards instead and the
residual rides the layers scattered (:func:`_layer_steps`). A layer is
written as a generator of collective steps (``parallel.collectives``):
the plain forwards wait on each collective as it is issued, and the
``*_overlap`` twins run two microbatches' steps interleaved
(``--tp-overlap``).

Dense weights under tensor parallelism (``tp_reduce="dense"``, chosen by
the Engine for the dense shards of ``parallel.sharding``): wq, wk, wv, w1
and w3 are output shards and wo and w2 input shards, so a rank's heads (its
hidden slice) feed its chunk of wo (w2) with no gather, and the f32 partial
sums go through ``collectives.reduce_columns``, a pinned-order all-reduce:
two a layer (the MoE FFN's over the whole ``ep x tp`` grid), then the
logits' gather when the vocab shards. The residual stays whole and the
same bits on every rank. The JAX package partitions its forward with
GSPMD instead (``allow_flash=False``); the port runs K4 and K5 on the
rank's kv heads, as under quantized TP.

``forward_batched_verify`` is the batched speculative-verify step: B
sequences of T candidate rows each, every matmul on the flattened [B*T,
dim] rows (K1/K3's tile past 8 rows), rope and the cache write through the
verify launch form of the rope + cache-write kernel, and attention in plain
PyTorch (``gqa_attention_batched``), as the reference attends it.

``forward_traced`` is the forward the native export traces
(``export_native``): dense params, positions as device tensors, the plain
attention path of the JAX package's default flags, no hand-written kernel.

``forward_train`` is the cache-free causal forward of the training step
(``runtime.train``), on dense leaves under autograd: ``torch.matmul``
products and f32 softmax attention, as the JAX package leaves them to XLA
outside any Pallas kernel. On a ``parallel.group.Mesh`` it runs a rank's
block: its ``dp`` rows and ``sp`` chunk of the batch (ring attention over
``sp``), its ``tp`` heads and hidden slice (``sharding``'s column/row
shards) joined by the differentiable collectives of
``parallel.grad_collectives``, and its ``ep`` experts.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch import resolve_device
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.models.moe import moe_ffn, moe_ffn_train
from dllama_tpu_torch.ops import flash_decode
from dllama_tpu_torch.ops.activations import ACTIVATIONS
from dllama_tpu_torch.ops.attention import gqa_attention, gqa_attention_batched
from dllama_tpu_torch.ops.fused_rope_cache import (
    cast_cache, rope_cache_update, rope_cache_update_batched, rope_cache_update_verify,
)
from dllama_tpu_torch.ops.norms import rmsnorm
from dllama_tpu_torch.ops.qmatmul import (
    K_MULTIPLE, QuantTensor, _pad_up, matmul_any, norm_fusion_engages, qmatmul_norm,
    quantize_tensor, repack_q40, repack_q80, slice_to_in_features,
)
from dllama_tpu_torch.ops.ring_attention import ring_self_attention
from dllama_tpu_torch.ops.rope import apply_rope, rope_table
from dllama_tpu_torch.parallel import quant_tp
from dllama_tpu_torch.parallel.grad_collectives import copy_to, gather_from, reduce_from
from dllama_tpu_torch.parallel.collectives import (
    Steps, drive, gather_columns, gather_columns_steps, interleave, reduce_columns_steps,
    reduce_scatter_columns_steps, rms_inv_scattered_steps, scatter_features,
)
from dllama_tpu_torch.quants import blocks

#: per-layer matrices eligible for quantized storage
QUANTIZABLE = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
#: expert stacks [L, E, in, out] eligible for quantized storage
MOE_QUANTIZABLE = ("moe_up", "moe_gate", "moe_down")
#: the attention matrices (every arch; the dense FFN adds w1, w2, w3)
ATTN_MATRICES = ("wq", "wk", "wv", "wo")
#: decode-sized steps take the kernels (the JAX flash/rope-cache gates' bound)
DECODE_MAX_T = 16


def _layer_vectors(cfg: ModelConfig) -> tuple:
    """The per-layer norm weights of ``cfg``'s arch (Grok-1 adds two)."""
    return ("rms_att", "rms_ffn") + (("rms_moe", "rms_ffn2") if cfg.post_norms else ())


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def params_to(params: dict, device) -> dict:
    """Every leaf (numpy array, tensor or QuantTensor) placed on ``device``."""
    def put(leaf):
        if isinstance(leaf, QuantTensor):
            return leaf.to(device)
        if isinstance(leaf, np.ndarray):
            leaf = np.ascontiguousarray(leaf)
            leaf = torch.from_numpy(leaf if leaf.flags.writeable else leaf.copy())
        return leaf.to(device)

    out = {k: put(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: put(v) for k, v in params["layers"].items()}
    return out


def params_from_reader(reader: WeightFileReader, cfg: ModelConfig, device,
                       dtype=None) -> dict:
    """Load `.m` tensors into the stacked-layer dict, dense, on ``device``.
    Matrices (the MoE router and expert stacks ``[L, E, in, out]`` too)
    take ``dtype`` (default the compute dtype); the embedding and norms stay
    f32, as in the reference."""
    dtype = dtype or cfg.torch_dtype

    def mat(name):
        t = torch.from_numpy(reader.read_tensor(name, np.float32).T.copy())
        return t.to(device=device, dtype=dtype)

    def vec(name):
        return torch.from_numpy(reader.read_tensor(name, np.float32)).to(device)

    p = {
        "embedding": vec("token_embedding"),
        "rms_final": vec("rms_final"),
        "wcls": mat("wcls"),
        "layers": {},
    }
    L = range(cfg.n_layers)
    for n in ATTN_MATRICES if cfg.is_moe else QUANTIZABLE:
        p["layers"][n] = torch.stack([mat(f"layers.{i}.{n}") for i in L])
    if cfg.is_moe:
        p["layers"]["moe_router"] = torch.stack([mat(f"layers.{i}.moe_router") for i in L])
        for kind in ("up", "gate", "down"):
            p["layers"][f"moe_{kind}"] = torch.stack([
                torch.stack([mat(f"layers.{i}.experts.{e}.{kind}")
                             for e in range(cfg.n_experts)]) for i in L])
    for n in _layer_vectors(cfg):
        p["layers"][n] = torch.stack([vec(f"layers.{i}.{n}") for i in L])
    return p


def quantize_params(params: dict, kind: str) -> dict:
    """Dense layer matrices, expert stacks (and wcls) -> stacked
    QuantTensors with the reference's block math. Embedding, norms and the
    MoE router stay dense. Leaves stay on the device they came from."""
    def quant(w: torch.Tensor) -> QuantTensor:
        return quantize_tensor(w.float().cpu().numpy(), kind, w.device)

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in QUANTIZABLE:
        if name in out["layers"]:
            stacked = out["layers"][name]
            out["layers"][name] = _stack([quant(stacked[i]) for i in range(stacked.shape[0])])
    for name in MOE_QUANTIZABLE:
        if name in out["layers"]:
            stacked = out["layers"][name]  # [L, E, in, out]
            out["layers"][name] = _stack([_stack([quant(w) for w in layer]) for layer in stacked])
    out["wcls"] = quant(params["wcls"])
    return out


def _stack(qts: list) -> QuantTensor:
    """Stack per-layer QuantTensors along a new leading axis."""
    def st(xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    q0 = qts[0]
    return QuantTensor(st([q.w for q in qts]), st([q.s for q in qts]),
                       st([q.s2 for q in qts]), q0.kind, q0.k_logical)


def quant_params_from_reader(reader: WeightFileReader, cfg: ModelConfig, device,
                             kind: str = "q40", tp=None, tp_reduce: bool = False) -> dict:
    """Load a `.m` file with the big matrices block-quantized for the
    kernels. When the file's own float type matches ``kind`` the file bits
    are repacked losslessly (a byte shuffle: on ``device`` when it is a card,
    one matrix at a time, milliseconds where the host's cores take ~0.2 s a
    Llama-3-8B FFN matrix; else on the host). Planes are staged
    and fused on the host, then placed, so the unfused originals never reach
    the device. The expert
    stacks of a MoE arch are staged one layer at a time — each layer's
    ``moe_up|moe_gate`` fused to ``moe_upgate`` and copied into its slot of
    the stack on the device — so the host holds one layer of them. The
    router stays dense in the compute dtype.

    ``tp`` (a ``parallel.group.TPGroup``, or anything with ``rank`` and
    ``size``): this rank's shard of a tensor-parallel model
    (``parallel.quant_tp``). Each sharded matrix is read as the band of file
    rows (the output axis) its shard covers, lane-padded, and fused from the
    rank's own parts, so neither the whole model nor a whole sharded matrix
    reaches the device or the host; the embedding, the norms, the router
    and an unsharded wcls are read whole. Quantized matrices only.
    ``tp_reduce``: wo and w2 are the rank's row shards instead
    (``quant_tp.row_shard_quant_leaf``: its K chunk of each file row, the
    JAX package's row-parallel pack cut at this rank, bit for bit): each
    layer's matrix is read whole on the host, cut, and let go (the caller
    checks ``quant_tp.validate_tp_reduce`` first)."""
    file_ft = reader.spec.weights_float_type
    lossless = (kind == "q40" and file_ft == blocks.Q40) or (
        kind == "q80" and file_ft == blocks.Q80)
    repack = repack_q40 if kind == "q40" else repack_q80
    kernel_multiple = 64 if kind == "q40" else 32
    rank, size = (0, 1) if tp is None else (tp.rank, tp.size)
    quant_tp.validate_quant_tp(cfg, size)
    shuffle_on = torch.device(device) if torch.device(device).type == "cuda" else "cpu"

    def band(name: str, lo: int, hi: int) -> QuantTensor:
        """File rows [lo, hi) of matrix ``name`` as a host QuantTensor [n, hi
        - lo]; rows past the file's (lane padding) are zero."""
        e = reader.entry(name)
        stop = min(hi, e.d)
        if stop <= lo:
            return quant_tp.zero_quant(kind, _pad_up(e.n, K_MULTIPLE[kind]), hi - lo,
                                       e.n).to("cpu")
        rows = slice(lo, stop)
        if lossless:
            qt = repack(reader.read_raw_rows(name, rows), stop - lo, e.n, shuffle_on).to("cpu")
        else:
            qt = quantize_tensor(reader.read_tensor_rows(name, rows).T, kind)
        return quant_tp._pad_qt_out(qt, hi - lo)

    def load_matrix(name: str, role: str):
        e = reader.entry(name)
        if e.n % kernel_multiple != 0:
            if tp is not None:
                raise ValueError(f"{name}: input width {e.n} is not packable as {kind}; "
                                 f"tensor parallelism takes quantized matrices only")
            # valid in the file format but not packable: keep it dense
            dense = reader.read_tensor(name, np.float32).T.copy()
            return torch.from_numpy(dense).to(cfg.torch_dtype)
        if tp_reduce and role in quant_tp.ROW_SHARDED_MATRICES:
            return quant_tp.row_shard_quant_leaf(role, band(name, 0, e.d), cfg, rank, size)
        lo, hi = 0, e.d
        if quant_tp.is_sharded(role, cfg, size):  # the whole axis at size 1
            lo, hi = quant_tp.shard_bounds(quant_tp.padded_out(role, cfg, kind, size, e.d),
                                           rank, size)
        qt = band(name, lo, hi)
        if role in quant_tp.HIDDEN_IN:  # a no-op at size 1: the pack's own K pad
            qt = quant_tp._pad_qt_in(qt, quant_tp.ffn_padded_width(cfg, kind, size))
        return qt

    def stacked(leaves: list):
        return (_stack(leaves) if isinstance(leaves[0], QuantTensor)
                else torch.stack(leaves))

    def experts(i: int, part: str):
        return stacked([load_matrix(f"layers.{i}.experts.{e}.{part}", f"moe_{part}")
                        for e in range(cfg.n_experts)])

    p = {
        "embedding": reader.read_tensor("token_embedding", np.float32),
        "rms_final": reader.read_tensor("rms_final", np.float32),
        "wcls": load_matrix("wcls", "wcls"),
        "layers": {},
    }
    for n in ATTN_MATRICES if cfg.is_moe else QUANTIZABLE:
        p["layers"][n] = stacked([load_matrix(f"layers.{i}.{n}", n)
                                  for i in range(cfg.n_layers)])
    for n in _layer_vectors(cfg):
        p["layers"][n] = np.stack([reader.read_tensor(f"layers.{i}.{n}", np.float32)
                                   for i in range(cfg.n_layers)])
    out = params_to(fuse_qkv_ffn(p), device)
    if cfg.is_moe:
        out["layers"]["moe_router"] = torch.stack([
            torch.from_numpy(reader.read_tensor(f"layers.{i}.moe_router", np.float32).T.copy())
            for i in range(cfg.n_layers)]).to(device=device, dtype=cfg.torch_dtype)
        stacks: dict = {}
        for i in range(cfg.n_layers):
            layer = fuse_qkv_ffn({"layers": {f"moe_{k}": experts(i, k)
                                             for k in ("up", "gate", "down")}})["layers"]
            for name, leaf in layer.items():
                _place_layer(stacks, name, leaf, i, cfg.n_layers, device)
        out["layers"].update(stacks)
    return out


def _place_layer(stacks: dict, name: str, leaf, i: int, n_layers: int, device) -> None:
    """Copy layer ``i``'s leaf (a host QuantTensor or a tensor) into slot
    ``i`` of ``stacks[name]``, a stack on ``device`` made at layer 0."""
    planes = (leaf.w, leaf.s, leaf.s2) if isinstance(leaf, QuantTensor) else (leaf,)
    planes = [p if isinstance(p, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(p))
              for p in planes]
    if name not in stacks:
        made = [torch.empty((n_layers, *p.shape), dtype=p.dtype, device=device) for p in planes]
        stacks[name] = (QuantTensor(*made, leaf.kind, leaf.k_logical)
                        if isinstance(leaf, QuantTensor) else made[0])
    st = stacks[name]
    for dst, src in zip((st.w, st.s, st.s2) if isinstance(st, QuantTensor) else (st,), planes):
        dst[i].copy_(src)


def fuse_qkv_ffn(params: dict) -> dict:
    """Concatenate quantized projections that share an input into one kernel
    call each: wq|wk|wv -> ``wqkv`` [D, D+2KV], w1|w3 -> ``w13`` [D, 2H],
    moe_up|moe_gate -> ``moe_upgate`` [E, D, 2H]. Exact: planes concatenate
    along the output axis, scales travel with their columns."""
    out = dict(params)
    out["layers"] = layers = dict(params["layers"])

    def cat(*qts):
        def c(xs):
            return (torch.cat(xs, dim=-1) if isinstance(xs[0], torch.Tensor)
                    else np.concatenate(xs, axis=-1))

        return QuantTensor(c([q.w for q in qts]), c([q.s for q in qts]),
                           c([q.s2 for q in qts]), qts[0].kind, qts[0].k_logical)

    for fused, parts in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3")),
                         ("moe_upgate", ("moe_up", "moe_gate"))):
        if all(isinstance(layers.get(n), QuantTensor) for n in parts):
            layers[fused] = cat(*(layers.pop(n) for n in parts))
    return out


def has_quant_leaves(params: dict) -> bool:
    return isinstance(params.get("wcls"), QuantTensor) or any(
        isinstance(v, QuantTensor) for v in params["layers"].values())


def random_quant_params(cfg: ModelConfig, device, generator: torch.Generator,
                        kind: str = "q40", tp=None, tp_reduce: bool = False) -> dict:
    """Random ``kind`` (q40 or q80) params built directly on ``device`` from
    ``generator`` — the benchmark-shape model with quantized residency and
    no host-side copy (the counterpart of the JAX package's
    ``device_random_quant_params``). Q40 planes are random valid nibbles
    with scales ``U[0,1) * 0.004``; Q80 planes are int8 in [-127, 127] with
    scales ``U[0,1) * 0.0003``. The model is numerically plausible but
    meaningless. The projections are made already fused (``wqkv``,
    ``w13``, ``moe_upgate``), which is how ``fuse_qkv_ffn`` would lay out
    independent random parts. A MoE arch gets expert stacks [L, E, ...],
    filled one layer at a time in place (a full Mixtral never holds a
    second copy of a stack on the card), and a dense f32 router ``N(0,
    0.02)``. ``tp`` (a ``parallel.group.TPGroup``): this rank's shard of
    the same model (``quant_tp.shard_params``: the parts unfused, for the
    Engine to fuse), the whole model made first on ``device``, leaf by leaf
    sliced and dropped, so every rank drawing from the same seed holds
    exactly its slice (``tp_reduce``: wo and w2 as row shards)."""
    if kind not in K_MULTIPLE:
        raise ValueError(f"unknown quant kind {kind!r}")
    L, D, H, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim

    def rand(*shape, scale):
        return torch.rand(shape, device=device, generator=generator) * scale

    def qrand(K_, O_, prefix=(L,)):
        kp = _pad_up(K_, K_MULTIPLE[kind])
        if kind == "q80":
            w = torch.randint(-127, 128, (*prefix, kp, O_), dtype=torch.int8,
                              device=device, generator=generator)
            return QuantTensor(w=w, s=rand(*prefix, kp // 32, O_, scale=0.0003),
                               s2=torch.zeros((*prefix, 0), device=device),
                               kind="q80", k_logical=K_)
        w = torch.randint(0, 256, (*prefix, kp // 2, O_), dtype=torch.uint8,
                          device=device, generator=generator)
        s = rand(*prefix, kp // 64, O_, scale=0.004)
        s2 = rand(*prefix, kp // 64, O_, scale=0.004)
        return QuantTensor(w=w, s=s, s2=s2, kind="q40", k_logical=K_)

    def qrand_experts(K_, O_):
        E, kp = cfg.n_experts, _pad_up(K_, K_MULTIPLE[kind])
        if kind == "q80":
            qt = QuantTensor(w=torch.empty((L, E, kp, O_), dtype=torch.int8, device=device),
                             s=torch.empty((L, E, kp // 32, O_), device=device),
                             s2=torch.zeros((L, E, 0), device=device), kind="q80", k_logical=K_)
            for i in range(L):
                qt.w[i].random_(-127, 128, generator=generator)
                qt.s[i].uniform_(0.0, 0.0003, generator=generator)
            return qt
        qt = QuantTensor(w=torch.empty((L, E, kp // 2, O_), dtype=torch.uint8, device=device),
                         s=torch.empty((L, E, kp // 64, O_), device=device),
                         s2=torch.empty((L, E, kp // 64, O_), device=device), kind="q40",
                         k_logical=K_)
        for i in range(L):
            qt.w[i].random_(0, 256, generator=generator)
            qt.s[i].uniform_(0.0, 0.004, generator=generator)
            qt.s2[i].uniform_(0.0, 0.004, generator=generator)
        return qt

    layers = {
        "wqkv": qrand(D, D + 2 * KV),
        "wo": qrand(D, D),
        **({} if cfg.is_moe else {"w13": qrand(D, 2 * H), "w2": qrand(H, D)}),
        **{n: torch.ones((L, D), device=device) for n in _layer_vectors(cfg)},
    }
    if cfg.is_moe:
        layers["moe_router"] = torch.randn((L, D, cfg.n_experts), device=device,
                                           generator=generator) * 0.02
        layers["moe_upgate"] = qrand_experts(D, 2 * H)
        layers["moe_down"] = qrand_experts(H, D)
    params = {
        "embedding": torch.randn((cfg.vocab_size, D), device=device, generator=generator) * 0.02,
        "rms_final": torch.ones(D, device=device),
        "wcls": qrand(D, cfg.vocab_size, prefix=()),
        "layers": layers,
    }
    if tp is None:
        return params
    return quant_tp.shard_params(params, cfg, tp.rank, tp.size, tp_reduce)


def random_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded synthetic weights in the compute dtype: the same numpy draws,
    in the same order, as the JAX package's ``random_params``, so one seed
    gives both packages the same model. On the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def w(*shape):
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=cfg.torch_dtype)

    L, D, H, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    layers = {
        "wq": w(L, D, D),
        "wk": w(L, D, KV),
        "wv": w(L, D, KV),
        "wo": w(L, D, D),
        **{n: torch.ones((L, D), device=device) for n in _layer_vectors(cfg)},
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layers.update({"moe_router": w(L, D, E), "moe_up": w(L, E, D, H),
                       "moe_gate": w(L, E, D, H), "moe_down": w(L, E, H, D)})
    else:
        layers.update({"w1": w(L, D, H), "w2": w(L, H, D), "w3": w(L, D, H)})
    return {
        "embedding": w(cfg.vocab_size, D).float(),
        "rms_final": torch.ones(D, device=device),
        "wcls": w(D, cfg.vocab_size),
        "layers": layers,
    }


def device_random_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random params drawn on ``device`` (the card unless asked otherwise)
    from a seeded ``torch.Generator``, each matrix N(0, 0.02²) in the
    compute dtype as it is drawn, so no f32 or host copy of a large model
    is made: the counterpart of the JAX package's ``device_random_params``,
    with its leaves, shapes and dtypes (the embedding and the router f32,
    expert stacks ``moe_up``/``moe_gate``/``moe_down`` [L, E, ...]) and its
    norms of ones. For benchmarks and the training smoke run."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, H, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim

    def w(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(0.02)

    layers = {"wq": w((L, D, D)), "wk": w((L, D, KV)), "wv": w((L, D, KV)),
              "wo": w((L, D, D))}
    if cfg.is_moe:
        E = cfg.n_experts
        layers.update(moe_router=w((L, D, E), torch.float32), moe_up=w((L, E, D, H)),
                      moe_gate=w((L, E, D, H)), moe_down=w((L, E, H, D)))
    else:
        layers.update(w1=w((L, D, H)), w2=w((L, H, D)), w3=w((L, D, H)))
    layers.update({n: torch.ones((L, D), device=device) for n in _layer_vectors(cfg)})
    return {"embedding": w((cfg.vocab_size, D), torch.float32),
            "rms_final": torch.ones(D, device=device),
            "wcls": w((D, cfg.vocab_size)), "layers": layers}


def init_cache(cfg: ModelConfig, cache_dtype=torch.float32, device=None,
               tp_size: int = 1) -> dict:
    """Fixed-size per-layer KV cache [L, seq_len, n_kv_heads / tp_size,
    head_size] (a tensor-parallel rank holds its kv heads), on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    shape = (cfg.n_layers, cfg.seq_len, cfg.n_kv_heads // tp_size, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


def init_batch_cache(cfg: ModelConfig, batch: int, cache_dtype=torch.float32,
                     device=None, tp_size: int = 1) -> dict:
    """KV cache for ``batch`` independent sequences: [L, B, seq_len,
    n_kv_heads / tp_size, head_size], on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.seq_len, cfg.n_kv_heads // tp_size, cfg.head_size)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


def rope_tables(cfg: ModelConfig, device=None) -> dict:
    """The rope cos/sin tables [seq_len, head_size/2] f32, on the card unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    cos, sin = rope_table(cfg.seq_len, cfg.head_size, cfg.rope_theta)
    return {"cos": torch.from_numpy(cos).to(device), "sin": torch.from_numpy(sin).to(device)}


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ Grok's input scale) in the compute dtype.
    The scale is rounded to the compute dtype first, as the JAX package's
    ``jnp.asarray(scale, dtype)``, and made by a fill on the device (a
    tensor copied from the host cannot be captured in a CUDA graph)."""
    x = params["embedding"][tokens].to(cfg.torch_dtype)
    if cfg.embedding_scale != 1.0:
        x = x * torch.full((), cfg.embedding_scale, dtype=cfg.torch_dtype, device=x.device)
    return x


def _norm_proj(x: torch.Tensor, norm_w: torch.Tensor, w, eps: float) -> torch.Tensor:
    """``rmsnorm(x, norm_w) @ w``. With DLLAMA_FUSE_NORM and a quantized
    ``w`` the norm rides inside the matmul kernel as an epilogue on each
    activation tile (``qmatmul_norm``: bit-equal, one fewer pass over the
    activation)."""
    if norm_fusion_engages(w):
        return qmatmul_norm(x, norm_w, w, eps)
    return matmul_any(rmsnorm(x, norm_w, eps), w)


def _dense_ffn_steps(cfg: ModelConfig, lp: dict, x: torch.Tensor, norm_w, tp=None,
                     tp_compress: bool = False, dense: bool = False) -> Steps:
    """FFN half on the RAW (pre-norm) residual ``x``: the ``rms_ffn`` norm is
    applied through ``_norm_proj`` so it can fuse into the up/gate kernels.
    Under ``tp`` the up/gate projections give this rank's slice of the
    (lane-padded) hidden, gathered whole for w2, whose output slice is
    gathered in turn (JAX ``llama.py:646-647``). ``dense``: the rank's
    hidden slice feeds its input chunk of w2 and the f32 partial sums are
    all-reduced (``reduce_columns``)."""
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.norm_eps
    if dense:
        partial = _dense_ffn_row(cfg, lp, rmsnorm(x, norm_w, eps))
        return (yield from reduce_columns_steps(partial, tp)).to(x.dtype)
    if "w13" in lp:  # fused single-kernel up|gate projection (fuse_qkv_ffn)
        u = _norm_proj(x, norm_w, lp["w13"], eps)
        half = u.shape[-1] // 2
        h = act(u[..., :half]) * u[..., half:]
    else:
        h = act(_norm_proj(x, norm_w, lp["w1"], eps)) * _norm_proj(x, norm_w, lp["w3"], eps)
    h = slice_to_in_features((yield from gather_columns_steps(h, tp, tp_compress)), lp["w2"])
    return (yield from gather_columns_steps(matmul_any(h, lp["w2"]), tp, tp_compress))


def _ffn_residual_steps(cfg: ModelConfig, lp: dict, x: torch.Tensor, att_out: torch.Tensor,
                        tp=None, tp_compress: bool = False, dense: bool = False) -> Steps:
    """Post-attention half of a layer, all three archs:

    * llama: ``x += att; x += dense_ffn(rmsnorm(x, rms_ffn))``
      (`distributed-llama/src/llama2-tasks.cpp:125-212`)
    * mixtral: the same joins with the MoE FFN
      (`distributed-llama/src/mixtral-tasks.cpp:24-46`)
    * grok1: the attention output and the MoE output are each rmsnorm'd
      before their residual adds, with an extra pre-MoE norm:
      ``x += rmsnorm(att, rms_ffn); x += rmsnorm(moe(rmsnorm(x, rms_moe)), rms_ffn2)``
      (`distributed-llama/src/grok1-tasks.cpp:16-54,239-262,280-320`)

    Under ``tp`` the FFN gathers (``dense``: all-reduces) its own output, so
    every rank holds the whole residual stream. The MoE FFN gathers as it
    goes (a MoE model never takes the microbatch overlap)."""
    eps = cfg.norm_eps
    kw = {"tp": tp, "tp_compress": tp_compress, "dense": dense}
    if cfg.is_moe and cfg.post_norms:  # grok1
        x = x + rmsnorm(att_out, lp["rms_ffn"], eps)
        xb = rmsnorm(x, lp["rms_moe"], eps)
        return x + rmsnorm(moe_ffn(cfg, lp, xb, **kw), lp["rms_ffn2"], eps)
    x = x + att_out
    if cfg.is_moe:
        return x + moe_ffn(cfg, lp, rmsnorm(x, lp["rms_ffn"], eps), **kw)
    return x + (yield from _dense_ffn_steps(cfg, lp, x, lp["rms_ffn"], **kw))


def _check_tp_reduce(cfg: ModelConfig, tp_reduce) -> bool:
    """Whether the reduce mode ``tp_reduce`` (None, "plain", "q80" or
    "dense") is on; a bad mode or a MoE model in a row-parallel quantized
    mode raises (the expert stacks keep output shards: no K-sharded
    down-projection gives partial sums)."""
    if tp_reduce is None:
        return False
    if tp_reduce not in ("plain", "q80", "dense"):
        raise ValueError(f"tp_reduce must be None, 'plain', 'q80' or 'dense', "
                         f"got {tp_reduce!r}")
    if cfg.is_moe and tp_reduce != "dense":
        raise ValueError(
            "tp_reduce requires a dense FFN: MoE expert stacks shard their "
            "output axis (a slice of every expert per device), so no "
            "row-parallel down-projection exists to produce partial sums")
    return True


def _check_overlap_split(cfg: ModelConfig, batch: int) -> int:
    """The row where the microbatch overlap cuts a batch of ``batch`` rows:
    ``batch // 2``. MoE is refused (its selected-experts union spans all
    rows, so a split changes which experts run) and so is a batch of one."""
    if cfg.is_moe:
        raise ValueError(
            "tp_overlap requires a dense FFN: the MoE selected-experts "
            "union spans all rows, so a microbatch split changes the "
            "expert schedule (not bit-identical)")
    if batch < 2:
        raise ValueError(f"tp_overlap needs batch >= 2 rows, got {batch}")
    return batch // 2


def _row_norm_gather_steps(x_s: torch.Tensor, norm_w: torch.Tensor, tp, tp_compress: bool,
                           eps: float, full_dim: int) -> Steps:
    """The row-parallel norm epilogue: the rmsnorm of the SCATTERED residual
    ``x_s`` [rows, dim / tp] (the whole row's scale from one gather of the
    per-rank sums of squares), the normalized chunks gathered whole, then
    the norm weight: JAX's ``_row_norm_gather``, its order of operations
    and its rounding to the activation dtype before the gather."""
    inv = yield from rms_inv_scattered_steps(x_s, tp, full_dim, eps)
    xn = yield from gather_columns_steps((x_s.float() * inv[..., None]).to(x_s.dtype), tp,
                                         tp_compress)
    return (norm_w.float() * xn.float()).to(x_s.dtype)


def _dense_ffn_row(cfg: ModelConfig, lp: dict, xn: torch.Tensor) -> torch.Tensor:
    """The row-parallel FFN on the already normalized whole rows ``xn``: the
    rank's up/gate slices feed its K-sharded w2 with no gather; returns the
    f32 partial sums [rows, dim] for the ring reduce-scatter."""
    act = ACTIVATIONS[cfg.hidden_act]
    if "w13" in lp:
        u = matmul_any(xn, lp["w13"])
        half = u.shape[-1] // 2
        h = act(u[..., :half]) * u[..., half:]
    else:
        h = act(matmul_any(xn, lp["w1"])) * matmul_any(xn, lp["w3"])
    return matmul_any(h, lp["w2"]).float()


def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, row_mode: bool = False) -> tuple:
    """The attention projections of x [T, dim] (rms_att applied, fused into
    the kernel under DLLAMA_FUSE_NORM; ``row_mode``: x arrives normalized
    and goes to the kernel as it is): q [T, dim], k and v [T, kv_dim], or a
    tensor-parallel rank's [T, dim / tp] and [T, kv_dim / tp]: the fused
    projection splits at widths taken from its own shape."""
    def proj(w):
        return matmul_any(x, w) if row_mode else _norm_proj(x, lp["rms_att"], w, cfg.norm_eps)

    if "wqkv" in lp:  # fused single-kernel projection (fuse_qkv_ffn)
        qkv = proj(lp["wqkv"])
        d = qkv.shape[-1] * cfg.dim // (cfg.dim + 2 * cfg.kv_dim)
        kv = (qkv.shape[-1] - d) // 2
        return qkv[:, :d], qkv[:, d:d + kv], qkv[:, d + kv:]
    return tuple(proj(lp[n]) for n in ("wq", "wk", "wv"))


def _heads_solo(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, layer: int,
                row_mode: bool = False) -> torch.Tensor:
    """The attention heads [T, heads·hd] of one sequence's T rows at ``pos``
    (before ``wo``); writes this step's K/V into the stacked caches [L, S,
    kv, hd] in place. Under tensor parallelism the heads are the rank's —
    counted from the shapes, as K4 and K5 size themselves from q's and the
    cache's."""
    T = x.shape[0]
    q, k, v = (t.reshape(T, -1, cfg.head_size) for t in _qkv(cfg, lp, x, row_mode))
    if T <= DECODE_MAX_T:
        # q's rope, K's rope and the cache write: one launch, reading q, k
        # and v where the projection left them
        q = rope_cache_update(q, k, v, rope["cos"], rope["sin"], k_cache, v_cache, pos, layer,
                              cfg.rope_style)
        out = flash_decode.flash_decode_attention(q, k_cache, v_cache, pos, layer)
    else:
        # the table slice start clamps like the JAX dynamic_slice
        r0 = min(max(pos, 0), cfg.seq_len - T)
        cos = rope["cos"][r0:r0 + T, None, :]
        sin = rope["sin"][r0:r0 + T, None, :]
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)
        k_cache[layer, pos:pos + T] = cast_cache(k, k_cache.dtype)
        v_cache[layer, pos:pos + T] = cast_cache(v, v_cache.dtype)
        out = gqa_attention(q, k_cache[layer], v_cache[layer], pos)
    return out.reshape(T, -1)


def _heads_batched(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor, layer: int,
                   bound: int | None, row0: int = 0, row_mode: bool = False) -> torch.Tensor:
    """Batched-decode attention heads [B, heads·hd]: x [B, dim] carries B
    independent sequences, row b at ``pos[b]`` (int32 [B] on x's device) and
    at cache row ``row0`` + b of the whole cache [L, Bc, S, kv, hd] (a
    microbatch of the overlap takes rows of it in place). The projections
    are [B, K] matmuls (K1/K3 at T = B); the batched rope + cache-write
    launch rotates q and K with each row's own angle and lands row b at
    (layer, row0 + b, pos[b]); the batched flash decode reads row b's own
    prefix."""
    B = x.shape[0]
    q, k, v = (t.reshape(B, -1, cfg.head_size) for t in _qkv(cfg, lp, x, row_mode))
    q = rope_cache_update_batched(q, k, v, rope["cos"], rope["sin"], k_cache, v_cache, pos,
                                  layer, cfg.rope_style, row0)
    out = flash_decode.flash_decode_attention_batched(q, k_cache, v_cache, pos, layer, bound,
                                                      row0)
    return out.reshape(B, -1)


def _heads_verify(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor, layer: int,
                  B: int, row0: int = 0, row_mode: bool = False) -> torch.Tensor:
    """Verify-step attention heads [B*T, heads·hd]: x [B*T, dim] holds B
    sequences of T candidate rows, sequence b's first row at ``pos[b]``
    (int32 [B] on x's device) and at cache row ``row0`` + b. The
    projections run on all B*T rows at once; the verify rope + cache-write
    launch rotates q and K and lands row b's T rows at (layer, row0 + b,
    pos[b]..); attention is dense over each row's slab."""
    T = x.shape[0] // B
    q, k, v = (t.reshape(B, T, -1, cfg.head_size) for t in _qkv(cfg, lp, x, row_mode))
    # angles of positions pos[b]..pos[b]+T-1, clamped at the table's end as
    # JAX's gather clamps (a row that close to the end is emission-capped
    # by the caller)
    q = rope_cache_update_verify(q, k, v, rope["cos"], rope["sin"], k_cache, v_cache, pos,
                                 layer, cfg.rope_style, row0)
    rows = slice(row0, row0 + B)
    out = gqa_attention_batched(q, k_cache[layer, rows], v_cache[layer, rows], pos)
    return out.reshape(B * T, -1)


def _wo_partials(lp: dict, heads: torch.Tensor) -> torch.Tensor:
    """The rank's heads into its K-sharded ``wo``, no gather: the f32
    partial sums [rows, dim] for a ring reduce."""
    return matmul_any(heads, lp["wo"]).float()


def _attn_steps(lp: dict, heads: torch.Tensor, tp, tp_compress: bool) -> Steps:
    """``wo`` on the attention heads, gather-only: the heads are gathered
    whole before ``wo`` and its output slice after it (JAX ``llama.py:766-767``)."""
    heads = yield from gather_columns_steps(heads, tp, tp_compress)
    return (yield from gather_columns_steps(matmul_any(heads, lp["wo"]), tp, tp_compress))


def _layer_steps(cfg: ModelConfig, lp: dict, x: torch.Tensor, heads, tp, tp_compress: bool,
                 tp_reduce) -> Steps:
    """One layer on the residual ``x``; ``heads(x_in, row_mode)`` computes
    the attention heads (rope, cache write, attention) of the layer.

    Gather-only: x [rows, dim] whole on every rank, four gathers. Row mode
    (``tp_reduce`` "plain" or "q80", JAX ``llama.py:858-874``): x is this
    rank's chunk [rows, dim / tp] of the residual; each sub-block normalizes
    it with the scattered-norm epilogue (one scalar gather and one gather of
    the normalized rows), runs the rank's heads into its K-sharded ``wo``
    (or its up/gate slices into its K-sharded ``w2``) and adds the ring
    reduce-scatter of the f32 partials to the chunk (Q80 hops with "q80").

    Dense (``tp_reduce`` "dense", dense shards of ``parallel.sharding``): x
    whole on every rank; the rank's heads feed its input chunk of ``wo``
    and the f32 partials are all-reduced, then the FFN's the same way."""
    if tp_reduce is None:
        att = yield from _attn_steps(lp, heads(x, False), tp, tp_compress)
        return (yield from _ffn_residual_steps(cfg, lp, x, att, tp, tp_compress))
    if tp_reduce == "dense":
        att = yield from reduce_columns_steps(_wo_partials(lp, heads(x, False)), tp)
        return (yield from _ffn_residual_steps(cfg, lp, x, att.to(x.dtype), tp, dense=True))
    eps, dim, hop_q80 = cfg.norm_eps, cfg.dim, tp_reduce == "q80"
    xn = yield from _row_norm_gather_steps(x, lp["rms_att"], tp, tp_compress, eps, dim)
    att_p = _wo_partials(lp, heads(xn, True))
    x = x + (yield from reduce_scatter_columns_steps(att_p, tp, hop_q80)).to(x.dtype)
    xn = yield from _row_norm_gather_steps(x, lp["rms_ffn"], tp, tp_compress, eps, dim)
    ffn_p = _dense_ffn_row(cfg, lp, xn)
    return x + (yield from reduce_scatter_columns_steps(ffn_p, tp, hop_q80)).to(x.dtype)


def _layer_params(layers: dict, i: int) -> dict:
    return {name: (leaf.layer(i) if isinstance(leaf, QuantTensor) else leaf[i])
            for name, leaf in layers.items()}


def _stack_steps(cfg: ModelConfig, params: dict, x: torch.Tensor, heads_of, tp,
                 tp_compress: bool, tp_reduce, last_pos: int | None = None) -> Steps:
    """Every layer on the embedded rows ``x``, then the final norm: returns
    the normalized rows [rows, dim] the classifier takes (``last_pos``: only
    that row). ``heads_of(lp, i)`` gives layer i's ``heads`` (see
    :func:`_layer_steps`). In row mode the residual rides the layers
    scattered and the final norm is the scattered-norm epilogue on the
    rows kept (JAX ``llama.py:886-892``)."""
    row = tp_reduce in ("plain", "q80")
    if row:
        x = scatter_features(x, tp)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_params(layers, i)
        x = yield from _layer_steps(cfg, lp, x, heads_of(lp, i), tp, tp_compress, tp_reduce)
    if last_pos is not None:
        x = x[last_pos:last_pos + 1]
    if row:
        return (yield from _row_norm_gather_steps(x, params["rms_final"], tp, tp_compress,
                                                  cfg.norm_eps, cfg.dim))
    return rmsnorm(x, params["rms_final"], cfg.norm_eps)


def _classify(cfg: ModelConfig, params: dict, xn: torch.Tensor, tp=None) -> torch.Tensor:
    """The classifier on the normalized rows ``xn``: f32 logits [rows,
    vocab]. Under ``tp`` with wcls sharded the f32 logits are gathered
    (never compressed) and cut back to the vocab: a zero logit in the lane
    pad must not reach the sampler (JAX ``llama.py:896-899``); with wcls
    whole every rank computes them all."""
    logits = matmul_any(xn, params["wcls"]).float()
    if tp is not None and quant_tp.shards_wcls(cfg, tp.size):
        logits = gather_columns(logits, tp)[..., :cfg.vocab_size]
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def _row_mode(cfg: ModelConfig, tp, tp_reduce):
    """The reduce mode a forward runs: ``tp_reduce`` when it is on and there
    is a tensor-parallel group, else None (gather-only)."""
    return tp_reduce if _check_tp_reduce(cfg, tp_reduce) and tp is not None else None


def forward(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
            cache: dict, pos: int, last_pos: int | None = None, tp=None,
            tp_compress: bool = False, tp_reduce=None) -> tuple:
    """Process T tokens starting at ``pos``. Returns (logits [T, vocab] f32,
    cache), the cache updated in place.

    ``last_pos``: compute the classifier only at that row — logits come back
    [1, vocab]; every layer still processes (and caches) all T positions.

    ``tp`` (a ``parallel.group.TPGroup``): the quantized tensor-parallel
    forward (``parallel.quant_tp``): ``params`` and ``cache`` are this
    rank's shards, activations are gathered after each output-sharded
    matmul (over the Q80 wire with ``tp_compress``), and every rank returns
    the same logits. The port of the JAX forward's ``tp_axis`` branches.
    ``tp_reduce`` (None, "plain" or "q80"; ``params`` with row shards of
    wo/w2, ``quant_tp.shard_params(..., tp_reduce=True)``): the row-parallel
    forward of :func:`_layer_steps`; "dense" (``params`` a rank's dense
    shards, ``parallel.sharding``): the dense-weight TP forward, each
    partial product all-reduced."""
    red = _row_mode(cfg, tp, tp_reduce)

    def heads_of(lp, i):
        return lambda x, row: _heads_solo(cfg, lp, rope, x, cache["k"], cache["v"], pos, i, row)

    xn = drive(_stack_steps(cfg, params, embed(cfg, params, tokens), heads_of, tp, tp_compress,
                            red, last_pos))
    return _classify(cfg, params, xn, tp), cache


def _batched_steps(cfg, params, rope, x, cache, pos, bound, row0, tp, tp_compress, red):
    """:func:`_stack_steps` of batched-decode rows [row0, row0 + len(x))."""
    def heads_of(lp, i):
        return lambda xi, row: _heads_batched(cfg, lp, rope, xi, cache["k"], cache["v"], pos,
                                              i, bound, row0, row)

    return _stack_steps(cfg, params, x, heads_of, tp, tp_compress, red)


def forward_batched(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                    cache: dict, pos: torch.Tensor, bound: int | None = None, tp=None,
                    tp_compress: bool = False, tp_reduce=None) -> tuple:
    """One decode step for B independent sequences -> (logits [B, vocab]
    f32, cache), the cache ``{"k", "v": [L, B, S, kv, hd]}`` updated in place.

    ``tokens`` [B] (one pending token per sequence) and ``pos`` int32 [B]
    (each sequence's own position) stay on the device: nothing here reads
    them back. ``bound``: a host upper bound of every ``pos + 1`` (default
    seq_len), which only sizes flash decode's grid. The weights stream once
    for all B rows; row b's math is ``forward`` at T = 1 and pos[b], summed
    in the order the kernels take at B rows. ``tp``, ``tp_compress``,
    ``tp_reduce``: as in :func:`forward`."""
    red = _row_mode(cfg, tp, tp_reduce)
    xn = drive(_batched_steps(cfg, params, rope, embed(cfg, params, tokens), cache, pos, bound,
                              0, tp, tp_compress, red))
    return _classify(cfg, params, xn, tp), cache


def forward_batched_overlap(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                            cache: dict, pos: torch.Tensor, bound: int | None = None, tp=None,
                            tp_compress: bool = False, tp_reduce=None) -> tuple:
    """:func:`forward_batched` with the rows cut into two microbatches, [0,
    h) and [h, B) with h = B // 2, whose layers run interleaved: each half's
    collectives are issued as asynchronous work and waited on only after
    the other half has issued its own next one
    (``collectives.interleave``), so one half's gathers and reduce hops are
    on the wire while the other computes — the TokenWeave-style overlap of
    the JAX package's ``forward_batched_overlap``, where XLA's
    latency-hiding scheduler found that order. Both halves read each layer's
    weights, the halves' K4/K5 launches take their rows of the one cache in
    place (``row0``), and the classifier runs once on the rejoined rows.

    Row b's math is :func:`forward_batched`'s: every op is per row, and a
    K4 launch of half the rows plans each row's chunks from the cache's row
    count. What can differ is a matmul's summation order at h rows against
    B (the dequant-matmuls' split plans depend on the row count on the
    card; the CPU's matmul takes another path at one row), so the halves
    agree with the monolithic step bit for bit where those orders agree and
    within the decode-step tolerance elsewhere. MoE and B < 2 are refused
    (:func:`_check_overlap_split`)."""
    B = tokens.shape[0]
    h = _check_overlap_split(cfg, B)
    red = _row_mode(cfg, tp, tp_reduce)
    x = embed(cfg, params, tokens)
    xa, xb = interleave(*(_batched_steps(cfg, params, rope, x[r0:r1], cache, pos[r0:r1], bound,
                                         r0, tp, tp_compress, red)
                          for r0, r1 in ((0, h), (h, B))))
    return _classify(cfg, params, torch.cat([xa, xb]), tp), cache


def forward_decode(cfg: ModelConfig, params: dict, rope: dict, token: torch.Tensor,
                   cache: dict, pos: torch.Tensor) -> tuple:
    """One solo decode step with the position on the device -> (logits
    [1, vocab] f32, cache), the solo cache ``{"k", "v": [L, S, kv, hd]}``
    updated in place: :func:`forward_batched` at B = 1 on the cache's
    ``[:, None]`` view with the grid bound ``seq_len``. ``token`` [1] and
    ``pos`` int32 [1] stay on the device, so nothing in the step depends on
    a host integer and a CUDA graph can capture it.

    Bit-equal to ``forward`` at T = 1: the rope angle is the same table row
    (row pos, the solo form's clamped slice at T = 1), the batched rope +
    cache write and flash decode at B = 1 are the solo launches' kernels,
    and flash decode plans each row's chunks from its own position, whatever
    the grid bound (empty chunks weigh 0 in the merge)."""
    view = {"k": cache["k"][:, None], "v": cache["v"][:, None]}
    logits, _ = forward_batched(cfg, params, rope, token, view, pos, cfg.seq_len)
    return logits, cache


def forward_traced(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                   cache: dict, pos: torch.Tensor, last: torch.Tensor | None = None,
                   in_place: bool = True) -> tuple:
    """The forward ``torch.export`` traces: T tokens at the 0-d int tensor
    ``pos`` -> (logits [T, vocab] f32, or [1, vocab] at row ``last`` (a 0-d
    int tensor), cache). The JAX package's forward at its default flags, on
    dense params: the rope rows and the K/V writes start where its
    ``dynamic_slice`` and ``dynamic_update_slice`` clamp them,
    ``min(max(pos, 0), S - T)``; attention is ``gqa_attention_batched`` over
    the layer's whole cache, masked at ``pos``. Nothing reads ``pos`` back
    and no hand-written kernel launches: this path takes the plain
    operations by construction, on every device.

    ``in_place``: the caches are written in place (the step and prefill
    programs); otherwise the returned cache is new and the given one is left
    as it was (a ``while_loop`` carry, which a loop body must not mutate)."""
    if cfg.is_moe or has_quant_leaves(params):
        raise ValueError("forward_traced takes a dense Llama model")
    T, S = tokens.shape[0], cfg.seq_len
    start = torch.clamp(pos.long(), 0, S - T)
    rows = start + torch.arange(T, device=tokens.device)
    cos = rope["cos"].index_select(0, rows)[:, None, :]
    sin = rope["sin"].index_select(0, rows)[:, None, :]
    x = embed(cfg, params, tokens.long())
    eps, slabs = cfg.norm_eps, {"k": [], "v": []}
    for i in range(cfg.n_layers):
        # a plain loop, no layer generators: a while_loop body is traced by
        # dynamo, which must capture it whole
        lp = _layer_params(params["layers"], i)
        q, k, v = (t.reshape(T, -1, cfg.head_size) for t in _qkv(cfg, lp, x))
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)
        layer = {}
        for name, new in (("k", k), ("v", v)):
            slab, new = cache[name][i], cast_cache(new, cache[name].dtype)
            dst, src = slab, new
            if new.element_size() == 1:
                # float8 rows move as their bytes: index_copy has no float8
                # kernel on the CPU
                dst, src = slab.view(torch.uint8), new.view(torch.uint8)
            if in_place:
                dst.index_copy_(0, rows, src)
            else:
                slab = dst.index_copy(0, rows, src).view(slab.dtype)
                slabs[name].append(slab)
            layer[name] = slab
        heads = gqa_attention_batched(q[None], layer["k"][None], layer["v"][None],
                                      pos.reshape(1))
        x = x + matmul_any(heads.reshape(T, -1), lp["wo"])
        xn = rmsnorm(x, lp["rms_ffn"], eps)
        h = ACTIVATIONS[cfg.hidden_act](matmul_any(xn, lp["w1"])) * matmul_any(xn, lp["w3"])
        x = x + matmul_any(h, lp["w2"])
    xn = rmsnorm(x, params["rms_final"], eps)
    if last is not None:
        xn = xn.index_select(0, last.reshape(1).long())
    if not in_place:
        cache = {name: torch.stack(slabs[name]) for name in ("k", "v")}
    return _classify(cfg, params, xn), cache


def _verify_steps(cfg, params, rope, x, cache, pos, B, row0, tp, tp_compress, red):
    """:func:`_stack_steps` of verify rows: B sequences [row0, row0 + B) of
    x's rows [B*T, dim]."""
    def heads_of(lp, i):
        return lambda xi, row: _heads_verify(cfg, lp, rope, xi, cache["k"], cache["v"], pos, i,
                                             B, row0, row)

    return _stack_steps(cfg, params, x, heads_of, tp, tp_compress, red)


def forward_batched_verify(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                           cache: dict, pos: torch.Tensor, tp=None,
                           tp_compress: bool = False, tp_reduce=None) -> tuple:
    """T candidate tokens for each of B sequences -> (logits [B, T, vocab]
    f32, cache): the batched speculative-verify step, the cache ``{"k", "v":
    [L, B, S, kv, hd]}`` updated in place. ``tokens`` [B, T] and ``pos``
    int32 [B] (the position of ``tokens[b, 0]``) stay on the device. Row b's
    math is ``forward`` at (T, pos[b]), summed in the order of B*T rows
    (a MoE layer routes all B*T rows at once, as the JAX package's does).
    ``tp``, ``tp_compress``: as in :func:`forward` (the JAX package's
    ``quant_tp.make_tp_verify_batched``): the heads, wo's output, the FFN
    hidden and w2's output are gathered over all B*T rows at once;
    ``tp_reduce`` as in :func:`forward`."""
    B, T = tokens.shape
    red = _row_mode(cfg, tp, tp_reduce)
    xn = drive(_verify_steps(cfg, params, rope, embed(cfg, params, tokens.reshape(B * T)),
                             cache, pos, B, 0, tp, tp_compress, red))
    return _classify(cfg, params, xn, tp).reshape(B, T, -1), cache


def forward_batched_verify_overlap(cfg: ModelConfig, params: dict, rope: dict,
                                   tokens: torch.Tensor, cache: dict, pos: torch.Tensor,
                                   tp=None, tp_compress: bool = False, tp_reduce=None) -> tuple:
    """:func:`forward_batched_verify` as two interleaved microbatches of
    sequences [0, h) and [h, B), h = B // 2: the verify twin of
    :func:`forward_batched_overlap`, with the same exactness."""
    B, T = tokens.shape
    h = _check_overlap_split(cfg, B)
    red = _row_mode(cfg, tp, tp_reduce)
    x = embed(cfg, params, tokens.reshape(B * T))
    xa, xb = interleave(*(_verify_steps(cfg, params, rope, x[r0 * T:r1 * T], cache, pos[r0:r1],
                                        r1 - r0, r0, tp, tp_compress, red)
                          for r0, r1 in ((0, h), (h, B))))
    return _classify(cfg, params, torch.cat([xa, xb]), tp).reshape(B, T, -1), cache


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def train_block(grid, B: int, T: int) -> tuple:
    """(rows, (c0, c1)) of a rank's block of a [B, T] batch on ``grid``:
    its ``dp`` slice of the rows and its ``sp`` chunk of the positions."""
    if grid is None:
        return slice(0, B), (0, T)
    dp, sp = grid.size("dp"), grid.size("sp")
    if B % dp or T % sp:
        raise ValueError(f"batch [{B}, {T}] does not split over dp={dp}, sp={sp}")
    b, c = B // dp, T // sp
    i, j = grid.index("dp"), grid.index("sp")
    return slice(i * b, (i + 1) * b), (j * c, (j + 1) * c)


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense causal GQA attention of JAX ``llama.py:1563-1570``: f32 scores
    masked with -1e30, softmax, back to q's dtype. q [B, T, Hq, D], k and v
    [B, T, Hkv, D] (a rank's heads under tp) -> [B, T, Hq, D]."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    qf = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    scores = torch.einsum("btkgh,bskh->bkgts", qf, k.float())
    scores = scores / float(np.sqrt(np.float32(D)))
    scores = torch.where(causal, scores, torch.full((), -1e30, device=q.device))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", att, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _row_sum(partial: torch.Tensor, tp, dtype) -> torch.Tensor:
    """A row shard's partial products summed over ``tp`` (differentiable),
    in the activation dtype; the product itself without a group."""
    return partial if tp is None else reduce_from(partial.float(), tp).to(dtype)


def _ffn_residual_train(cfg: ModelConfig, lp: dict, x: torch.Tensor, att: torch.Tensor,
                        grid) -> torch.Tensor:
    """The post-attention half of a layer under autograd: the arch joins of
    :func:`_ffn_residual_steps` with the dense FFN (its hidden slice under
    tp: copy in, w1/w3 column shards, w2 row shard, reduce out) or the MoE
    FFN's dense combine (``moe.moe_ffn_train``)."""
    eps = cfg.norm_eps
    if cfg.is_moe and cfg.post_norms:  # grok1
        x = x + rmsnorm(att, lp["rms_ffn"], eps)
        xb = rmsnorm(x, lp["rms_moe"], eps)
        return x + rmsnorm(moe_ffn_train(cfg, lp, xb, grid), lp["rms_ffn2"], eps)
    x = x + att
    xb = rmsnorm(x, lp["rms_ffn"], eps)
    if cfg.is_moe:
        return x + moe_ffn_train(cfg, lp, xb, grid)
    tp = None if grid is None else grid.group("tp")
    xin = copy_to(xb, tp)
    h = ACTIVATIONS[cfg.hidden_act](xin @ lp["w1"]) * (xin @ lp["w3"])
    return x + _row_sum(h @ lp["w2"], tp, x.dtype)


def train_layer(cfg: ModelConfig, lp: dict, cos: torch.Tensor, sin: torch.Tensor,
                x: torch.Tensor, grid=None) -> torch.Tensor:
    """One cache-free causal layer on x [B, T, dim] (JAX ``llama.py:1536``),
    shared by :func:`forward_train` and the pipeline's stages. ``cos``/``sin``
    are the rope rows of x's positions, [1, T, 1, hd/2]. On ``grid``: the
    rank's heads from its column shards of wq/wk/wv, its row shard of wo
    summed over ``tp``, ring attention over ``sp``."""
    B, T = x.shape[:2]
    hd = cfg.head_size
    tp = None if grid is None else grid.group("tp")
    sp = None if grid is None else grid.group("sp")
    xin = copy_to(rmsnorm(x, lp["rms_att"], cfg.norm_eps), tp)
    q = (xin @ lp["wq"]).reshape(B, T, -1, hd)
    k = (xin @ lp["wk"]).reshape(B, T, -1, hd)
    v = (xin @ lp["wv"]).reshape(B, T, -1, hd)
    q = apply_rope(q, cos, sin, cfg.rope_style)
    k = apply_rope(k, cos, sin, cfg.rope_style)
    out = ring_self_attention(q, k, v, sp) if sp is not None else _causal_attention(q, k, v)
    att = _row_sum(out.reshape(B, T, -1) @ lp["wo"], tp, x.dtype)
    return _ffn_residual_train(cfg, lp, x, att, grid)


def train_rope(cfg: ModelConfig, rope: dict, c0: int, c1: int) -> tuple:
    """The rope rows of positions [c0, c1) as [1, T, 1, hd/2] f32."""
    return (rope["cos"][c0:c1][None, :, None, :], rope["sin"][c0:c1][None, :, None, :])


def train_logits(cfg: ModelConfig, params: dict, x: torch.Tensor, grid=None) -> torch.Tensor:
    """The final norm and the classifier on x [..., dim]: f32 logits
    (JAX: ``(x @ wcls)`` cast to f32, times ``logit_scale``). A vocab-sharded
    wcls's logits are gathered whole."""
    x = rmsnorm(x, params["rms_final"], cfg.norm_eps)
    tp = None if grid is None else grid.group("tp")
    if tp is not None and params["wcls"].shape[-1] != cfg.vocab_size:
        logits = gather_from((copy_to(x, tp) @ params["wcls"]).float(), tp)
    else:
        logits = (x @ params["wcls"]).float()
    return logits * cfg.logit_scale if cfg.logit_scale != 1.0 else logits


def forward_train(cfg: ModelConfig, params: dict, tokens, rope: dict = None,
                  grid=None) -> torch.Tensor:
    """Batched cache-free causal forward: tokens [B, T] -> logits [B, T,
    vocab] f32, differentiable in the dense leaves of ``params`` (JAX
    ``llama.py:1485``). The same math per position as :func:`forward`, the
    attention over the in-flight K/V of the sequence instead of a cache.

    ``grid`` (a ``parallel.group.Mesh``): ``tokens`` is the whole batch on
    every rank and the result is this rank's block [B / dp, T / sp, vocab]
    (:func:`train_block`); ``params`` are the rank's shards
    (``sharding.shard_mesh_params``)."""
    dev = params["embedding"].device
    tokens = torch.as_tensor(tokens, device=dev)
    rows, (c0, c1) = train_block(grid, *tokens.shape)
    x = embed(cfg, params, tokens[rows, c0:c1])
    cos, sin = train_rope(cfg, rope if rope is not None else rope_tables(cfg, dev), c0, c1)
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        x = train_layer(cfg, _layer_params(layers, i), cos, sin, x, grid)
    return train_logits(cfg, params, x, grid)
