"""Rank-side cases of the port's tensor-parallel tests.

``parallel.group.LocalWorld`` runs each function here on every rank of a
gloo world of CPU processes (``fn(group, *args)``): the functions must be
importable by name in a spawned process, so they live in this module, which
imports only torch and the port (never JAX, so a rank starts in a second).
Called with ``group=None`` they are the single-device reference. Params
travel as host dicts: numpy arrays, and port QuantTensors with numpy planes
(``host_params``).
"""

from __future__ import annotations

import numpy as np
import torch

from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.ops.qmatmul import QuantTensor
from dllama_tpu_torch.parallel.collectives import gather_columns
from dllama_tpu_torch.runtime.generate import Engine
from dllama_tpu_torch.runtime.sampler import SamplerConfig

#: 19 tokens: a prefill on the dense attention route (T > 16)
PROMPT = [1, 5, 9, 13, 2, 7, 3, 4, 11, 12, 40, 41, 42, 43, 44, 45, 46, 47, 48]


def host_params(np_params: dict) -> dict:
    """A JAX parameter tree (numpy leaves, JAX QuantTensors) as a host dict
    a rank can unpickle without JAX: numpy arrays and port QuantTensors."""
    def leaf(x):
        if all(hasattr(x, a) for a in ("w", "s", "s2", "kind", "k_logical")):
            return QuantTensor(np.asarray(x.w), np.asarray(x.s), np.asarray(x.s2), str(x.kind),
                               int(x.k_logical))
        return np.asarray(x)

    out = {k: leaf(v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = {k: leaf(v) for k, v in np_params["layers"].items()}
    return out


def shard_input(seed: int, rank: int, rows: int, f: int, dtype=torch.float32) -> torch.Tensor:
    """Rank ``rank``'s local activation [rows, f] of a gather case; every
    fourth 32-value block all zero."""
    g = torch.Generator().manual_seed(seed * 100 + rank)
    x = torch.randn((rows, f), generator=g) * (1 + rank)
    x.reshape(rows, f // 32, 32)[:, ::4] = 0.0
    return x.to(dtype)


def gather_case(group, seed: int, rows: int, f: int, compress: bool, dtype) -> tuple:
    """(gathered f32 [rows, size*f], bytes sent) of one gather of this
    rank's :func:`shard_input`."""
    group.sent_bytes = 0
    x = shard_input(seed, group.rank, rows, f, dtype)
    out = gather_columns(x, group, compress)
    assert out.dtype == dtype
    return out.float().numpy(), group.sent_bytes


def engine(group, host: dict, cfg, compress: bool = False, temperature: float = 0.0,
           seed: int = 0) -> Engine:
    params = from_jax_params(host, cfg, "cpu", tp=group)
    return Engine(cfg, params, SamplerConfig(temperature=temperature, seed=seed), device="cpu",
                  cuda_graphs=False, tp=group, tp_compress=compress, metrics=None)


def logits_case(group, host: dict, cfg, compress: bool, tokens: list) -> dict:
    """Logits of ``forward`` on ``tokens`` at position 0 of a fresh cache
    ("first"); and the chain of a :data:`PROMPT` prefill then two greedy
    decode steps ("chain"); the bytes this rank sent ("sent")."""
    eng = engine(group, host, cfg, compress)
    sent0 = 0 if group is None else group.sent_bytes
    kw = {"tp": group, "tp_compress": compress}
    first, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor(tokens), eng.new_cache(), 0,
                             **kw)
    cache = eng.new_cache()
    lg, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor(PROMPT), cache, 0, **kw)
    chain = [lg.numpy()]
    for i in range(2):
        tok = int(lg[-1].argmax())
        lg, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor([tok]), cache,
                              len(PROMPT) + i, **kw)
        chain.append(lg.numpy())
    return {"first": first.numpy(), "chain": chain,
            "sent": 0 if group is None else group.sent_bytes - sent0}


def decode_case(group, host: dict, cfg, compress: bool, prompt: list, steps: int,
                temperature: float = 0.0, seed: int = 0) -> dict:
    """``generate`` (tokens and each token's sent bytes) and
    ``generate_fused`` tokens of one engine."""
    eng = engine(group, host, cfg, compress, temperature, seed)
    stream = list(eng.generate(prompt, steps))
    fused, _, _ = eng.generate_fused(prompt, steps)
    return {"tokens": [t for t, _ in stream], "fused": fused,
            "sent_kb": [s.sent_kb for _, s in stream], "recv_kb": [s.recv_kb for _, s in stream]}


def batch_case(group, host: dict, cfg, prompts: list, steps: int) -> list:
    return engine(group, host, cfg).generate_batch(prompts, steps)


def reader_case(group, path: str, cfg, kind: str, prompt: list, steps: int) -> dict:
    """Greedy tokens of an engine on this rank's shard read from the `.m`
    file at ``path``, and the shapes of its planes."""
    with WeightFileReader(path) as reader:
        params = llama.quant_params_from_reader(reader, cfg, "cpu", kind, tp=group)
    shapes = {n: tuple(v.w.shape) for n, v in params["layers"].items()
              if isinstance(v, QuantTensor)}
    eng = Engine(cfg, params, SamplerConfig(temperature=0.0), device="cpu", tp=group,
                 metrics=None)
    return {"tokens": [t for t, _ in eng.generate(prompt, steps)], "shapes": shapes}


def moe_case(group, host: dict, cfg, tokens: list) -> dict:
    """Logits of ``forward`` on ``tokens`` at position 0 of a MoE model, and
    how many of its layers took the selected-experts path."""
    from dllama_tpu_torch.models import moe

    eng = engine(group, host, cfg)
    orig, calls = moe._moe_decode_selected, []

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    moe._moe_decode_selected = spy
    try:
        logits, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor(tokens),
                                  eng.new_cache(), 0, tp=group)
    finally:
        moe._moe_decode_selected = orig
    return {"logits": logits.numpy(), "selected": len(calls)}
