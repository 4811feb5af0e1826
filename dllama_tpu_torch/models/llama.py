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

Tensor parallelism (``tp``, a ``parallel.group.TPGroup``, in ``forward``
and ``forward_batched``): the JAX forward's ``tp_axis`` branches. Every
quantized matrix is an output shard (``parallel.quant_tp``), so a rank's
heads, kv heads and FFN hidden are its slice; the activations are gathered
whole after each output-sharded matmul (four gathers a layer, then the
logits), so everything between the gathers is replicated and every rank
holds the same residual stream. ``quant_params_from_reader(..., tp=)``
loads a rank's shard.

``forward_batched_verify`` is the batched speculative-verify step: B
sequences of T candidate rows each, every matmul on the flattened [B*T,
dim] rows (K1/K3's tile past 8 rows), rope and the cache write through the
verify launch form of the rope + cache-write kernel, and attention in plain
PyTorch (``gqa_attention_batched``), as the reference attends it.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch import resolve_device
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.models.moe import moe_ffn
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
from dllama_tpu_torch.ops.rope import apply_rope, rope_table
from dllama_tpu_torch.parallel import quant_tp
from dllama_tpu_torch.parallel.collectives import gather_columns
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
                             kind: str = "q40", tp=None) -> dict:
    """Load a `.m` file with the big matrices block-quantized for the
    kernels. When the file's own float type matches ``kind`` the file bits
    are repacked losslessly (by torch on the host's cores). Planes are staged
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
    and an unsharded wcls are read whole. Quantized matrices only."""
    file_ft = reader.spec.weights_float_type
    lossless = (kind == "q40" and file_ft == blocks.Q40) or (
        kind == "q80" and file_ft == blocks.Q80)
    repack = repack_q40 if kind == "q40" else repack_q80
    kernel_multiple = 64 if kind == "q40" else 32
    rank, size = (0, 1) if tp is None else (tp.rank, tp.size)
    quant_tp.validate_quant_tp(cfg, size)

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
            qt = repack(reader.read_raw_rows(name, rows), stop - lo, e.n, "cpu")
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
                        kind: str = "q40", tp=None) -> dict:
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
    exactly its slice."""
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
    return quant_tp.shard_params(params, cfg, tp.rank, tp.size)


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


def _dense_ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor, norm_w, tp=None,
               tp_compress: bool = False) -> torch.Tensor:
    """FFN half on the RAW (pre-norm) residual ``x``: the ``rms_ffn`` norm is
    applied through ``_norm_proj`` so it can fuse into the up/gate kernels.
    Under ``tp`` the up/gate projections give this rank's slice of the
    (lane-padded) hidden, gathered whole for w2, whose output slice is
    gathered in turn (JAX ``llama.py:646-647``)."""
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.norm_eps
    if "w13" in lp:  # fused single-kernel up|gate projection (fuse_qkv_ffn)
        u = _norm_proj(x, norm_w, lp["w13"], eps)
        half = u.shape[-1] // 2
        h = act(u[..., :half]) * u[..., half:]
    else:
        h = act(_norm_proj(x, norm_w, lp["w1"], eps)) * _norm_proj(x, norm_w, lp["w3"], eps)
    h = slice_to_in_features(gather_columns(h, tp, tp_compress), lp["w2"])
    return gather_columns(matmul_any(h, lp["w2"]), tp, tp_compress)


def _ffn_residual(cfg: ModelConfig, lp: dict, x: torch.Tensor, att_out: torch.Tensor,
                  tp=None, tp_compress: bool = False) -> torch.Tensor:
    """Post-attention half of a layer, all three archs:

    * llama: ``x += att; x += dense_ffn(rmsnorm(x, rms_ffn))``
      (`distributed-llama/src/llama2-tasks.cpp:125-212`)
    * mixtral: the same joins with the MoE FFN
      (`distributed-llama/src/mixtral-tasks.cpp:24-46`)
    * grok1: the attention output and the MoE output are each rmsnorm'd
      before their residual adds, with an extra pre-MoE norm:
      ``x += rmsnorm(att, rms_ffn); x += rmsnorm(moe(rmsnorm(x, rms_moe)), rms_ffn2)``
      (`distributed-llama/src/grok1-tasks.cpp:16-54,239-262,280-320`)

    Under ``tp`` the FFN gathers its own output, so every rank holds the
    whole residual stream."""
    eps = cfg.norm_eps
    kw = {"tp": tp, "tp_compress": tp_compress}
    if cfg.is_moe and cfg.post_norms:  # grok1
        x = x + rmsnorm(att_out, lp["rms_ffn"], eps)
        xb = rmsnorm(x, lp["rms_moe"], eps)
        return x + rmsnorm(moe_ffn(cfg, lp, xb, **kw), lp["rms_ffn2"], eps)
    x = x + att_out
    if cfg.is_moe:
        return x + moe_ffn(cfg, lp, rmsnorm(x, lp["rms_ffn"], eps), **kw)
    return x + _dense_ffn(cfg, lp, x, lp["rms_ffn"], **kw)


def _attn_block(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                layer: int, tp=None, tp_compress: bool = False) -> torch.Tensor:
    """One attention sub-block of layer ``layer``; writes this step's K/V
    into the stacked caches in place and returns the output [T, dim].

    Under ``tp`` (a ``parallel.group.TPGroup``) the projections are this
    rank's output shards, so its heads are local — counted from the shapes,
    as K4 and K5 size themselves from q's and the cache's — and the cache
    holds its kv heads; the heads' output is gathered before ``wo`` and
    ``wo``'s output after it (JAX ``llama.py:766-767``)."""
    T = x.shape[0]
    q, k, v = (t.reshape(T, -1, cfg.head_size) for t in _qkv(cfg, lp, x))
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
    out = gather_columns(out.reshape(T, -1), tp, tp_compress)
    return gather_columns(matmul_any(out, lp["wo"]), tp, tp_compress)


def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> tuple:
    """The attention projections of x [T, dim] (rms_att applied, fused into
    the kernel under DLLAMA_FUSE_NORM): q [T, dim], k and v [T, kv_dim], or
    a tensor-parallel rank's [T, dim / tp] and [T, kv_dim / tp]: the fused
    projection splits at widths taken from its own shape."""
    if "wqkv" in lp:  # fused single-kernel projection (fuse_qkv_ffn)
        qkv = _norm_proj(x, lp["rms_att"], lp["wqkv"], cfg.norm_eps)
        d = qkv.shape[-1] * cfg.dim // (cfg.dim + 2 * cfg.kv_dim)
        kv = (qkv.shape[-1] - d) // 2
        return qkv[:, :d], qkv[:, d:d + kv], qkv[:, d + kv:]
    return tuple(_norm_proj(x, lp["rms_att"], lp[n], cfg.norm_eps) for n in ("wq", "wk", "wv"))


def _attn_block_batched(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                        layer: int, bound: int | None, tp=None,
                        tp_compress: bool = False) -> torch.Tensor:
    """Batched-decode attention of layer ``layer``: x [B, dim] carries B
    independent sequences, row b at ``pos[b]`` (int32 [B] on x's device).
    The projections are [B, K] matmuls (K1/K3 at T = B); the batched rope +
    cache-write launch rotates q and K with each row's own angle and lands
    row b at (layer, b, pos[b]); the batched flash decode reads row b's own
    prefix. Returns the output [B, dim]; ``tp`` as in :func:`_attn_block`."""
    B = x.shape[0]
    q, k, v = (t.reshape(B, -1, cfg.head_size) for t in _qkv(cfg, lp, x))
    q = rope_cache_update_batched(q, k, v, rope["cos"], rope["sin"], k_cache, v_cache, pos,
                                  layer, cfg.rope_style)
    out = flash_decode.flash_decode_attention_batched(q, k_cache, v_cache, pos, layer, bound)
    out = gather_columns(out.reshape(B, -1), tp, tp_compress)
    return gather_columns(matmul_any(out, lp["wo"]), tp, tp_compress)


def _attn_block_verify(cfg: ModelConfig, lp: dict, rope: dict, x: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                       layer: int, B: int) -> torch.Tensor:
    """Verify-step attention of layer ``layer``: x [B*T, dim] holds B
    sequences of T candidate rows, sequence b's first row at ``pos[b]``
    (int32 [B] on x's device). The projections run on all B*T rows at once;
    the verify rope + cache-write launch rotates q and K and lands row b's T
    rows at (layer, b, pos[b]..); attention is dense over each row's slab.
    Returns [B*T, dim]."""
    T = x.shape[0] // B
    q, k, v = (t.reshape(B, T, -1, cfg.head_size) for t in _qkv(cfg, lp, x))
    # angles of positions pos[b]..pos[b]+T-1, clamped at the table's end as
    # JAX's gather clamps (a row that close to the end is emission-capped
    # by the caller)
    q = rope_cache_update_verify(q, k, v, rope["cos"], rope["sin"], k_cache, v_cache, pos,
                                 layer, cfg.rope_style)
    out = gqa_attention_batched(q, k_cache[layer], v_cache[layer], pos)
    return matmul_any(out.reshape(B * T, -1), lp["wo"])


def _layer_params(layers: dict, i: int) -> dict:
    return {name: (leaf.layer(i) if isinstance(leaf, QuantTensor) else leaf[i])
            for name, leaf in layers.items()}


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Final rmsnorm, then the classifier: f32 logits [rows, vocab]. Under
    ``tp`` with wcls sharded the f32 logits are gathered (never
    compressed) and cut back to the vocab: a zero logit in the lane pad
    must not reach the sampler (JAX ``llama.py:896-899``); with wcls whole
    every rank computes them all."""
    logits = matmul_any(rmsnorm(x, params["rms_final"], cfg.norm_eps), params["wcls"]).float()
    if tp is not None and quant_tp.shards_wcls(cfg, tp.size):
        logits = gather_columns(logits, tp)[..., :cfg.vocab_size]
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def forward(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
            cache: dict, pos: int, last_pos: int | None = None, tp=None,
            tp_compress: bool = False) -> tuple:
    """Process T tokens starting at ``pos``. Returns (logits [T, vocab] f32,
    cache), the cache updated in place.

    ``last_pos``: compute the classifier only at that row — logits come back
    [1, vocab]; every layer still processes (and caches) all T positions.

    ``tp`` (a ``parallel.group.TPGroup``): the quantized tensor-parallel
    forward (``parallel.quant_tp``): ``params`` and ``cache`` are this
    rank's shards, activations are gathered after each output-sharded
    matmul (over the Q80 wire with ``tp_compress``), and every rank returns
    the same logits. The port of the JAX forward's ``tp_axis`` branches."""
    x = embed(cfg, params, tokens)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_params(layers, i)
        att_out = _attn_block(cfg, lp, rope, x, cache["k"], cache["v"], pos, i, tp, tp_compress)
        x = _ffn_residual(cfg, lp, x, att_out, tp, tp_compress)
    if last_pos is not None:
        x = x[last_pos:last_pos + 1]
    return _logits(cfg, params, x, tp), cache


def forward_batched(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                    cache: dict, pos: torch.Tensor, bound: int | None = None, tp=None,
                    tp_compress: bool = False) -> tuple:
    """One decode step for B independent sequences -> (logits [B, vocab]
    f32, cache), the cache ``{"k", "v": [L, B, S, kv, hd]}`` updated in place.

    ``tokens`` [B] (one pending token per sequence) and ``pos`` int32 [B]
    (each sequence's own position) stay on the device: nothing here reads
    them back. ``bound``: a host upper bound of every ``pos + 1`` (default
    seq_len), which only sizes flash decode's grid. The weights stream once
    for all B rows; row b's math is ``forward`` at T = 1 and pos[b], summed
    in the order the kernels take at B rows. ``tp``, ``tp_compress``: as
    in :func:`forward`."""
    x = embed(cfg, params, tokens)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_params(layers, i)
        att_out = _attn_block_batched(cfg, lp, rope, x, cache["k"], cache["v"], pos, i, bound,
                                      tp, tp_compress)
        x = _ffn_residual(cfg, lp, x, att_out, tp, tp_compress)
    return _logits(cfg, params, x, tp), cache


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


def forward_batched_verify(cfg: ModelConfig, params: dict, rope: dict, tokens: torch.Tensor,
                           cache: dict, pos: torch.Tensor) -> tuple:
    """T candidate tokens for each of B sequences -> (logits [B, T, vocab]
    f32, cache): the batched speculative-verify step, the cache ``{"k", "v":
    [L, B, S, kv, hd]}`` updated in place. ``tokens`` [B, T] and ``pos``
    int32 [B] (the position of ``tokens[b, 0]``) stay on the device. Row b's
    math is ``forward`` at (T, pos[b]), summed in the order of B*T rows
    (a MoE layer routes all B*T rows at once, as the JAX package's does).
    Single device."""
    B, T = tokens.shape
    x = embed(cfg, params, tokens.reshape(B * T))
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_params(layers, i)
        att_out = _attn_block_verify(cfg, lp, rope, x, cache["k"], cache["v"], pos, i, B)
        x = _ffn_residual(cfg, lp, x, att_out)
    return _logits(cfg, params, x).reshape(B, T, -1), cache
