"""Dense-weight tensor parallelism: the reference's weight slicing as a
shard plan, the port of ``dllama_tpu/parallel/sharding.py``.

* ``RowMatmulSlice`` (wq, wk, wv, w1, w3 and each expert's up and gate,
  `distributed-llama/src/transformer.cpp:454-493`): the kernel's OUTPUT
  axis shards over ``tp``; a rank computes its heads and its slice of the
  FFN hidden from the whole input.
* ``ColMatmulSlice`` (wo, w2 and each expert's down): the kernel's INPUT
  axis shards over ``tp``; a rank's heads (its hidden slice) feed its chunk
  and give full-width partial sums, which ``collectives.reduce_columns``
  adds on a pinned-order ring (where the JAX package's GSPMD emits one
  all-reduce: the reference's gather-then-root-sum collapsed into one
  collective, `distributed-llama/src/llama2-tasks.cpp:115-131`).
* The KV cache and the attention heads shard by kv head
  (`distributed-llama/src/transformer.cpp:161-181`); the reference's
  ``nSlices <= nKvHeads`` constraint is ``n_kv_heads % tp == 0``.
* ``ep``: MoE expert stacks also shard their expert axis, a rank holding
  ``n_experts / ep`` experts (expert parallelism, beyond the reference).
* wcls shards its vocab when ``tp`` divides it and is replicated otherwise;
  the embedding, the norms and the MoE router are replicated.

The dense path pads nothing: ``tp`` must divide ``n_kv_heads`` and
``hidden_dim`` (and so dim), as in the JAX package, unlike the quantized
path's lane padding (``parallel.quant_tp``). Kernels are stored ``[in,
out]`` with a leading layer axis (and an expert axis for the stacks), so
an "output" shard cuts the last axis and an "input" shard the one before.

On a training mesh (``group.make_mesh``, :func:`mesh_specs`) the layer
stacks also shard their leading layer axis over ``pp`` (a pipeline stage's
layers), and every leaf is replicated over ``dp`` and ``sp``.

The table (:func:`param_specs`) names, for each leaf and each of its axes,
the grid axis that shards it (``"tp"``, ``"ep"`` or None), the content of
the JAX package's PartitionSpecs; :func:`shard_params` cuts a rank's leaves
from it and :func:`sharded_params_from_reader` reads only those from a
`.m` file.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.qmatmul import QuantTensor, decode_rows

TP = "tp"
EP = "ep"
PP = "pp"
#: file rows decoded at a time while loading (bounds the f32 staging)
LOAD_BAND_ROWS = 16384


def check_tp_compatible(cfg: ModelConfig, n_tp: int) -> None:
    """The constraints every tensor-parallel layout shares (the quantized
    one, ``quant_tp``, adds its own)."""
    if cfg.n_kv_heads % n_tp != 0:
        raise ValueError(
            f"tp={n_tp} must divide n_kv_heads={cfg.n_kv_heads} "
            "(the reference's nSlices<=nKvHeads constraint)"
        )
    if cfg.hidden_dim % n_tp != 0:
        raise ValueError(f"tp={n_tp} must divide hidden_dim={cfg.hidden_dim}")


def check_ep_compatible(cfg: ModelConfig, ep: int) -> None:
    if uses_ep(cfg, ep) and cfg.n_experts % ep != 0:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")


def uses_ep(cfg: ModelConfig, ep: int) -> bool:
    """Whether the expert stacks shard over ``ep`` (a MoE model on a grid
    with more than one ``ep`` row; a dense FFN replicates over it)."""
    return cfg.is_moe and ep > 1


def layer_specs(cfg: ModelConfig, use_ep: bool = False) -> dict:
    """Per-layer leaf -> the grid axis of each of its axes."""
    specs = {
        "wq": (None, None, TP),  # output slice: heads
        "wk": (None, None, TP),
        "wv": (None, None, TP),
        "wo": (None, TP, None),  # input slice + all-reduce
        "rms_att": (None, None),
        "rms_ffn": (None, None),
    }
    if cfg.is_moe:
        ep = EP if use_ep else None
        specs.update({
            "moe_router": (None, None, None),
            "moe_up": (None, ep, None, TP),
            "moe_gate": (None, ep, None, TP),
            "moe_down": (None, ep, TP, None),
        })
        if cfg.post_norms:
            specs["rms_moe"] = (None, None)
            specs["rms_ffn2"] = (None, None)
    else:
        specs.update({"w1": (None, None, TP), "w2": (None, TP, None), "w3": (None, None, TP)})
    return specs


def shards_wcls(cfg: ModelConfig, n_tp: int) -> bool:
    """wcls shards its vocab (and the logits are gathered) only when tp
    divides it; otherwise every rank holds it whole and computes every
    logit. The quantized path (``quant_tp``) shards it alike."""
    return cfg.vocab_size % n_tp == 0


def param_specs(cfg: ModelConfig, n_tp: int, use_ep: bool = False) -> dict:
    return {
        "embedding": (None, None),
        "rms_final": (None,),
        "wcls": (None, TP) if shards_wcls(cfg, n_tp) else (None, None),
        "layers": layer_specs(cfg, use_ep),
    }


def checked_specs(cfg: ModelConfig, n_tp: int, ep: int = 1) -> dict:
    check_tp_compatible(cfg, n_tp)
    check_ep_compatible(cfg, ep)
    return param_specs(cfg, n_tp, uses_ep(cfg, ep))


def grid_position(rank: int, size: int, ep: int = 1) -> dict:
    """{"tp": (tp rank, tp), "ep": (ep rank, ep)} of world rank ``rank`` of
    ``size`` on an ``ep x tp`` grid (rank r at (r // tp, r % tp))."""
    if ep < 1 or size % ep:
        raise ValueError(f"ep={ep} must divide the world's {size} ranks")
    tp = size // ep
    return {TP: (rank % tp, tp), EP: (rank // tp, ep)}


def group_position(group) -> dict:
    """:func:`grid_position` of a ``parallel.group.TPGroup`` (a grid's tp
    subgroup, or a world of its own); one device without a group."""
    if group is None:
        return {TP: (0, 1), EP: (0, 1)}
    return {TP: (group.rank, group.size), EP: (group.ep_rank, group.ep)}


def axis_bounds(width: int, axis: str, pos: dict) -> tuple:
    """[start, stop) of this rank's shard of an axis of ``width`` cut over
    the grid axis ``axis`` (None: the whole axis)."""
    if axis is None:
        return 0, width
    i, n = pos[axis]
    if width % n:
        raise ValueError(f"an axis of {width} does not split into {n} shards over {axis}")
    per = width // n
    return i * per, (i + 1) * per


def cut_leaf(leaf, spec: tuple, pos: dict) -> torch.Tensor:
    """This rank's block of ``leaf`` (numpy or torch) under ``spec``, as a
    torch tensor of its own (the whole leaf can be freed)."""
    if isinstance(leaf, QuantTensor):
        raise ValueError("parallel.sharding cuts dense leaves; quantized weights shard "
                         "through parallel.quant_tp")
    t = torch.from_numpy(np.ascontiguousarray(leaf)) if isinstance(leaf, np.ndarray) else leaf
    if len(spec) != t.dim():
        raise ValueError(f"a leaf of shape {tuple(t.shape)} under a spec of {len(spec)} axes")
    index = tuple(slice(*axis_bounds(t.shape[a], ax, pos)) for a, ax in enumerate(spec))
    return t[index].clone()


def shard_params(params: dict, cfg: ModelConfig, rank: int, size: int, ep: int = 1) -> dict:
    """World rank ``rank``'s dense leaves of a model run on ``size`` ranks
    laid out ``ep x tp`` (tp = size / ep): every leaf cut by the table,
    numpy or torch in, torch out, on the device the leaf was on. The
    counterpart of the JAX package's ``shard_params`` (its
    ``addressable_shards``)."""
    pos = grid_position(rank, size, ep)
    return _cut_params(params, checked_specs(cfg, pos[TP][1], ep), pos)


def _cut_params(params: dict, specs: dict, pos: dict) -> dict:
    out = {k: cut_leaf(params[k], specs[k], pos) for k in ("embedding", "rms_final", "wcls")}
    out["layers"] = {n: cut_leaf(leaf, specs["layers"][n], pos)
                     for n, leaf in params["layers"].items()}
    return out


def mesh_specs(cfg: ModelConfig, mesh) -> dict:
    """The table of a ``group.Mesh``: :func:`param_specs` at its ``tp`` and
    ``ep`` sizes, the layer stacks' leading axis over ``pp`` when it has one
    (a pipeline's stage holds n_layers / pp consecutive layers)."""
    return specs_at(cfg, mesh.size(TP), mesh.size(EP), mesh.size(PP))


def specs_at(cfg: ModelConfig, n_tp: int, ep: int = 1, pp: int = 1) -> dict:
    """:func:`mesh_specs` from the axis sizes."""
    specs = checked_specs(cfg, n_tp, ep)
    if pp > 1:
        if cfg.n_layers % pp:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={pp}")
        specs["layers"] = {n: (PP,) + spec[1:] for n, spec in specs["layers"].items()}
    return specs


def leaf_specs(specs: dict) -> dict:
    """A table as {leaf path: spec}: the top-level leaves, then
    ``layers/<name>`` (``runtime.train.leaf_items``' paths)."""
    out = {k: v for k, v in specs.items() if k != "layers"}
    out.update({f"layers/{n}": v for n, v in specs["layers"].items()})
    return out


def unshard_leaves(cfg: ModelConfig, parts: list) -> dict:
    """The whole leaves {path: numpy} from every rank's shards: ``parts`` is
    [(position, {path: numpy shard})], each position a rank's
    :func:`mesh_position` (ranks that replicate one another may repeat)."""
    pos0 = parts[0][0]
    specs = leaf_specs(specs_at(cfg, pos0[TP][1], pos0[EP][1], pos0[PP][1]))
    out = {}
    for name, spec in specs.items():
        shard = np.asarray(parts[0][1][name])
        full = np.zeros([d * (pos0[a][1] if a else 1) for d, a in zip(shard.shape, spec)],
                        shard.dtype)
        for pos, leaves in parts:
            full[tuple(slice(pos[a][0] * d, (pos[a][0] + 1) * d) if a else slice(None)
                       for d, a in zip(shard.shape, spec))] = leaves[name]
        out[name] = full
    return out


def mesh_position(mesh) -> dict:
    """{axis: (index, size)} of a ``group.Mesh`` rank on the axes that cut
    leaves (tp, ep, pp; size 1 where the mesh lacks one)."""
    return {a: (mesh.index(a), mesh.size(a)) for a in (TP, EP, PP)}


def shard_mesh_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """A mesh rank's dense leaves of the whole ``params`` (numpy or torch):
    every leaf cut by :func:`mesh_specs` at the rank's place, torch out, on
    the device the leaf was on. Without a mesh, the leaves as tensors."""
    if mesh is None:
        return shard_params(params, cfg, 0, 1)
    return _cut_params(params, mesh_specs(cfg, mesh), mesh_position(mesh))


def check_shards(params: dict, cfg: ModelConfig, n_tp: int, ep: int = 1) -> None:
    """Raise unless ``params`` hold one rank's dense shards of a model at
    ``n_tp`` (and ``ep``): wo's input rows dim / tp (a whole model handed
    to a tensor-parallel engine would compute garbage, not fail), and each
    expert stack's n_experts / ep experts."""
    checked_specs(cfg, n_tp, ep)
    wo = params["layers"]["wo"]
    if isinstance(wo, QuantTensor):
        raise ValueError("parallel.sharding checks dense shards; quantized weights: "
                         "parallel.quant_tp.check_shards")
    want = (cfg.dim // n_tp, cfg.dim)
    if tuple(wo.shape[-2:]) != want:
        raise ValueError(f"wo is [{wo.shape[-2]}, {wo.shape[-1]}] where a rank of a "
                         f"tp={n_tp} model holds its input rows [{want[0]}, {want[1]}]: pass "
                         f"this rank's shard (sharding.shard_params, or load with "
                         f"sharding.sharded_params_from_reader)")
    if cfg.is_moe:
        down = params["layers"]["moe_down"]
        want = (cfg.n_experts // ep if uses_ep(cfg, ep) else cfg.n_experts,
                cfg.hidden_dim // n_tp, cfg.dim)
        if tuple(down.shape[-3:]) != want:
            raise ValueError(f"moe_down is {list(down.shape[-3:])} where a rank of a "
                             f"tp={n_tp}, ep={ep} model holds {list(want)}")


def sharded_params_from_reader(reader, cfg: ModelConfig, device, dtype=None, tp=None) -> dict:
    """Load a `.m` file as this rank's dense shards (``tp``: a
    ``parallel.group.TPGroup``, a grid's tp subgroup included; None: the
    whole model) on ``device``: matrices, the router and the expert stacks
    in ``dtype`` (default the compute dtype), the embedding and the norms
    f32, as ``models.llama.params_from_reader`` makes them, equal to
    :func:`shard_params` of that whole load bit for bit.

    Each rank reads only what it keeps: the band of file rows (the output
    axis) of a column-sharded matrix, every row of a row-sharded one cut to
    its input chunk, and with ``ep`` only its experts. The file's bytes go
    to ``device`` and are decoded there (``qmatmul.decode_rows``), a band of
    rows at a time, into stacks made on ``device`` at the first layer: the
    host never holds more than one matrix's bytes, and never its f32
    values."""
    dtype = dtype or cfg.torch_dtype
    pos = group_position(tp)
    specs = checked_specs(cfg, pos[TP][1], pos[EP][1])
    lspecs = specs["layers"]

    def read(name: str, spec: tuple, out_dtype) -> torch.Tensor:
        """Matrix ``name`` (file [out, in]) in kernel layout [in, out],
        this rank's block of it under ``spec`` (of the [in, out] axes)."""
        e = reader.entry(name)
        c0, c1 = axis_bounds(e.n, spec[0], pos)  # input axis: the file's columns
        r0, r1 = axis_bounds(e.d, spec[1], pos)  # output axis: the file's rows
        out = torch.empty((c1 - c0, r1 - r0), dtype=out_dtype, device=device)
        for b0 in range(r0, r1, LOAD_BAND_ROWS):
            b1 = min(r1, b0 + LOAD_BAND_ROWS)
            rows = decode_rows(reader.read_raw_rows(name, slice(b0, b1)), e.float_type,
                               b1 - b0, e.n, device)
            out[:, b0 - r0:b1 - r0] = rows[:, c0:c1].T.to(out_dtype)
        return out

    def vec(name: str) -> torch.Tensor:
        return torch.from_numpy(reader.read_tensor(name, np.float32)).to(device)

    stacks: dict = {}

    def place(name: str, index: tuple, leaf: torch.Tensor, lead: tuple) -> None:
        if name not in stacks:
            stacks[name] = torch.empty((*lead, *leaf.shape), dtype=leaf.dtype, device=device)
        stacks[name][index].copy_(leaf)

    L = cfg.n_layers
    emb = reader.entry("token_embedding")
    params = {
        "embedding": decode_rows(reader.read_raw_rows("token_embedding", slice(0, emb.d)),
                                 emb.float_type, emb.d, emb.n, device),
        "rms_final": vec("rms_final"),
        "wcls": read("wcls", specs["wcls"], dtype),
        "layers": {n: torch.stack([vec(f"layers.{i}.{n}") for i in range(L)])
                   for n in lspecs if n.startswith("rms_")},
    }
    for i in range(L):
        ffn = ("moe_router",) if cfg.is_moe else ("w1", "w2", "w3")
        for n in ("wq", "wk", "wv", "wo") + ffn:
            place(n, (i,), read(f"layers.{i}.{n}", lspecs[n][1:], dtype), (L,))
        if cfg.is_moe:
            e0, e1 = axis_bounds(cfg.n_experts, lspecs["moe_up"][1], pos)
            for part in ("up", "gate", "down"):
                spec = lspecs[f"moe_{part}"][2:]
                for j, x in enumerate(range(e0, e1)):
                    place(f"moe_{part}", (i, j),
                          read(f"layers.{i}.experts.{x}.{part}", spec, dtype), (L, e1 - e0))
    params["layers"].update(stacks)
    return params
