"""Carry the JAX package's parameter dict across to the port.

``from_jax_params`` takes the JAX parameter pytree with every array leaf
already turned into numpy (``np.asarray``), and QuantTensor leaves as any
object with ``w``/``s``/``s2``/``kind``/``k_logical`` attributes whose planes
are numpy arrays. The layouts are the same on both sides (kernel layout
``[in, out]``, layer-stacked leaves, the packed Q40 planes), so carrying
them across is a copy. Nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.qmatmul import QuantTensor
from dllama_tpu_torch.parallel import quant_tp


def _is_quant(x) -> bool:
    return all(hasattr(x, a) for a in ("w", "s", "s2", "kind", "k_logical"))


def _host_quant(x) -> QuantTensor:
    return QuantTensor(np.asarray(x.w), np.asarray(x.s), np.asarray(x.s2), str(x.kind),
                       int(x.k_logical))


def _leaf(x, device, dtype: torch.dtype | None):
    if _is_quant(x):
        return _host_quant(x).to(device)
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(np_params: dict, cfg: ModelConfig, device, tp=None) -> dict:
    """The port's parameter dict for ``np_params`` on ``device``. Dense layer
    matrices and ``wcls`` take the config's compute dtype; the embedding and
    the norms stay f32, as in the JAX package. ``tp`` (a
    ``parallel.group.TPGroup``): this rank's shard of the quantized params
    (``quant_tp.shard_params``, cut on the host before placing), the parts
    unfused for the Engine to fuse."""
    if tp is not None:
        host = {k: v for k, v in np_params.items() if k != "layers"}
        host["wcls"] = _host_quant(host["wcls"]) if _is_quant(host["wcls"]) else host["wcls"]
        host["layers"] = {k: _host_quant(v) if _is_quant(v) else v
                          for k, v in np_params["layers"].items()}
        np_params = quant_tp.shard_params(host, cfg, tp.rank, tp.size)
    dense = cfg.torch_dtype
    out = {
        "embedding": _leaf(np_params["embedding"], device, torch.float32),
        "rms_final": _leaf(np_params["rms_final"], device, torch.float32),
        "wcls": _leaf(np_params["wcls"], device, dense),
        "layers": {},
    }
    for name, leaf in np_params["layers"].items():
        dt = torch.float32 if name.startswith("rms_") else dense
        out["layers"][name] = _leaf(leaf, device, dt)
    return out
