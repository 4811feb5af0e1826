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
from dllama_tpu_torch.parallel import quant_tp
from dllama_tpu_torch.parallel.collectives import (
    drive, gather_axis, gather_columns, reduce_scatter_columns, rms_inv_scattered_steps,
    scatter_features,
)
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
           seed: int = 0, tp_reduce: str = "off", tp_overlap: bool = False,
           metrics=None) -> Engine:
    """A rank's engine on its shard of ``host``; wo/w2 load as row shards
    where ``tp_reduce`` will engage (as ``cli.load_engine`` decides)."""
    kind = host["wcls"].kind if isinstance(host["wcls"], QuantTensor) else "q40"
    row = (group is not None and tp_reduce != "off"
           and quant_tp.validate_tp_reduce(cfg, kind, group.size) is None)
    params = from_jax_params(host, cfg, "cpu", tp=group, tp_reduce=row)
    return Engine(cfg, params, SamplerConfig(temperature=temperature, seed=seed), device="cpu",
                  cuda_graphs=False, tp=group, tp_compress=compress, metrics=metrics,
                  tp_reduce=tp_reduce, tp_overlap=tp_overlap)


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


# -- speculative decoding under TP (tests/test_torch_tp_spec.py) -------------

def spec_case(group, host: dict, cfg, prompt: list, prompts: list, steps: int,
              draft_len: int, compress: bool = False) -> dict:
    """``generate_spec`` greedy and sampled (temperature 0.8, seed 5) and
    ``generate_batch_spec`` of one engine, each verify step counted."""
    eng = engine(group, host, cfg, compress)
    eng._m_spec_steps, eng._m_spec_accepted, eng._m_spec_emitted = _Count(), _Count(), _Count()
    greedy = [t for t, _ in eng.generate_spec(prompt, steps, draft_len=draft_len)]
    solo_steps = eng._m_spec_steps.n
    sampled = [t for t, _ in eng.generate_spec(
        prompt, steps, draft_len=draft_len, sampler=SamplerConfig(temperature=0.8, seed=5))]
    rows, stats = eng.generate_batch_spec(prompts, steps, draft_len=draft_len)
    return {"greedy": greedy, "solo_steps": solo_steps, "sampled": sampled, "rows": rows,
            "stats": stats}


class _Count:
    """A stand-in for the engine's spec counters: counts what goes in."""

    def __init__(self):
        self.n = 0

    def inc(self, n: int = 1) -> None:
        self.n += n


def spec_drive(eng, prompt: list, prompts: list, steps: int, draft_len: int) -> dict:
    """The speculative calls a chat or a server makes on ``eng`` (an Engine
    or rank 0's TPEngine): a greedy stream read to its end, a sampled one
    abandoned after 3 tokens, then a batch whose row 1 its ``row_cancel``
    finishes once it has emitted 3 tokens (``on_step`` counts them)."""
    stream = [t for t, _ in eng.generate_spec(prompt, steps, draft_len=draft_len)]
    part = eng.generate_spec(prompt, steps, draft_len=draft_len,
                             sampler=SamplerConfig(temperature=0.8, seed=5))
    abandoned = [next(part)[0] for _ in range(3)]
    del part  # the followers drop theirs with the next op
    seen = [0] * len(prompts)
    fresh_log = []

    def on_step(fresh):
        fresh_log.append(fresh)
        for b, f in enumerate(fresh):
            seen[b] += len(f)

    rows, stats = eng.generate_batch_spec(prompts, steps, draft_len=draft_len,
                                          on_step=on_step, row_cancel=lambda b: b == 1
                                          and seen[1] >= 3)
    return {"stream": stream, "abandoned": abandoned, "rows": rows, "stats": stats,
            "fresh": fresh_log}


def spec_plane_case(group, host: dict, cfg, *args) -> dict:
    """Rank 0: :func:`spec_drive` over a ``TPEngine`` and its stop report;
    every other rank: its follow report."""
    from dllama_tpu_torch.parallel.control import TPEngine, follow

    eng = engine(group, host, cfg)
    if group.rank != 0:
        return {"report": follow(eng, group)}
    plane = TPEngine(eng, group)
    got = spec_drive(plane, *args)
    return {"report": plane.stop(), "drive": got}


# -- a paged row's export and import under TP (tests/test_torch_tp_rows.py) --

#: the paged sessions of the row tests: 8-token pages, 4-step chunks
PAGED = dict(max_batch=2, chunk=4, prefill_chunk=5, kv_pages=8)


def _drain(sess, h) -> list:
    out = []
    while not sess.is_done(h):
        sess.prefill_step()
        out.extend(sess.step_chunk().get(h, []))
    return out


def export_case(group, host: dict, cfg, prompt: list, steps: int, temperature: float) -> dict:
    """A paged row admitted in pieces, decoded two chunks and exported, then
    decoded to its end in place: {"snap", "first", "kept"} (the tokens
    before the export, and the whole stream)."""
    eng = engine(group, host, cfg)
    sess = eng.batch_session(**PAGED)
    h = sess.admit_begin(prompt, steps, sampler=SamplerConfig(temperature=temperature,
                                                              topp=0.5, seed=7))
    while h in sess.pending_prefills:
        sess.prefill_step()
    first = []
    for _ in range(2):
        first.extend(sess.step_chunk().get(h, []))
    snap = sess.export_row(h)
    kept = first + _drain(sess, h)
    sess.close()
    return {"snap": snap, "first": first, "kept": kept}


def import_case(group, host: dict, cfg, prompt: list, snap: dict) -> dict:
    """A fresh paged session's import of ``snap``: the row exported again
    at once ("again", its pages as this world holds them), then the tokens
    it decodes ("rest")."""
    sess = engine(group, host, cfg).batch_session(**PAGED)
    h = sess.admit_from_export(prompt, snap)
    again = sess.export_row(h)
    out = _drain(sess, h)
    sess.release(h)
    sess._alloc.check()
    sess.close()
    return {"again": again, "rest": out}


def rows_plane_case(group, host: dict, cfg, prompt: list, steps: int, snap: dict) -> dict:
    """Rank 0 over a ``TPEngine``: a row exported after two chunks of one
    paged session, and ``snap`` imported into it and decoded to its end;
    its stop report. Every other rank: its follow report."""
    from dllama_tpu_torch.parallel.control import TPEngine, follow

    eng = engine(group, host, cfg)
    if group.rank != 0:
        return {"report": follow(eng, group)}
    plane = TPEngine(eng, group)
    sess = plane.batch_session(**PAGED)
    h = sess.admit(prompt, steps)
    for _ in range(2):
        sess.step_chunk()
    out = {"snap": sess.export_row(h)}
    sess.release(h)
    h = sess.admit_from_export(prompt, snap)
    out["rest"] = _drain(sess, h)
    sess.close()
    return {"report": plane.stop(), **out}


def cli_case(group, argv: list, turns: str = "") -> str:
    """``cli.run_tp_rank`` on ``argv`` (a ``generate`` or ``chat`` command
    line) on every rank, rank 0 reading ``turns`` as its stdin; rank 0's
    stdout (the others print nothing)."""
    import contextlib
    import io
    import sys

    from dllama_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    out, saved = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(turns)
    try:
        with contextlib.redirect_stdout(out):
            cli.run_tp_rank(group, args, 0, group.size)
    finally:
        sys.stdin = saved
    return out.getvalue()


# -- the reduce direction and the microbatch overlap -------------------------
# (tests/test_torch_tp_reduce.py, tests/test_torch_tp_overlap.py)

def reduce_case(group, parts: np.ndarray, compress: bool, dtype: str) -> dict:
    """This rank's ``reduce_scatter_columns`` of its partials ``parts[rank]``
    (in ``dtype``), the bytes it sent, and every rank's chunk gathered
    (the full sum)."""
    x = torch.from_numpy(parts[group.rank]).to(getattr(torch, dtype))
    group.sent_bytes = 0
    chunk = reduce_scatter_columns(x, group, compress)
    sent = group.sent_bytes
    full = gather_axis(chunk, group)
    return {"chunk": chunk.numpy(), "dtype": str(chunk.dtype), "sent": sent,
            "full": full.numpy()}


def norm_case(group, x0: np.ndarray, eps: float) -> dict:
    """``scatter_features`` of a replicated row block gathered back, and
    ``rms_inv_scattered_steps`` of the chunks."""
    x = torch.from_numpy(x0)
    s = scatter_features(x, group)
    return {"back": gather_columns(s, group).numpy(),
            "inv": drive(rms_inv_scattered_steps(s, group, x0.shape[-1], eps)).numpy()}


def guard_case(group, f: int, compress: bool) -> str:
    """The error a reduce-scatter of [2, f] partials raises ("" if none)."""
    try:
        reduce_scatter_columns(torch.ones(2, f), group, compress)
    except ValueError as e:
        return str(e)
    return ""


def row_pack_case(group, host: dict, cfg) -> dict:
    """This rank's wo and w2 as ``from_jax_params(..., tp_reduce=True)``
    places them: their planes and ``k_logical``."""
    layers = from_jax_params(host, cfg, "cpu", tp=group, tp_reduce=True)["layers"]
    return {n: (layers[n].w.numpy(), layers[n].s.numpy(), layers[n].s2.numpy(),
                layers[n].k_logical) for n in ("wo", "w2")}


def row_reader_case(group, path: str, cfg, kind: str) -> dict:
    """This rank's wo and w2 planes read from the `.m` file at ``path`` with
    ``tp_reduce``."""
    with WeightFileReader(path) as reader:
        layers = llama.quant_params_from_reader(reader, cfg, "cpu", kind, tp=group,
                                                tp_reduce=True)["layers"]
    return {n: (layers[n].w.numpy(), layers[n].s.numpy(), layers[n].s2.numpy(),
                layers[n].k_logical) for n in ("wo", "w2")}


def _counts(reg) -> dict:
    out = {"dllama_tp_overlap_chunks_total": 0.0, "dllama_tp_reduce_chunks_total": 0.0}
    for line in reg.render().splitlines():
        name = line.split("{")[0].split(" ")[0]
        if name in out:
            out[name] = float(line.split()[-1])
    return out


def session_stream(eng, prompts: list, steps: int, **kw) -> list:
    """Greedy streams of ``prompts`` through a pooled ``BatchSession``
    (admitted in pieces, four-step chunks)."""
    sess = eng.batch_session(4, chunk=4, **kw)
    hs = [sess.admit_begin(p, steps=steps) for p in prompts]
    while sess.prefill_step() is not None:
        pass
    got = {h: [] for h in hs}
    while any(not sess.is_done(h) for h in hs):
        for h, toks in sess.step_chunk().items():
            got[h].extend(toks)
    sess.close()
    return [got[h] for h in hs]


def _batched_logits(eng, prompts: list, fwd) -> np.ndarray:
    """One batched decode step's logits after each prompt's prefill, through
    ``fwd`` (a batched forward of ``llama``) on the engine's shards."""
    cache, pend, poss = eng._prefill_batch_rows(prompts)
    pos = torch.tensor(poss, dtype=torch.int32)
    lg, _ = fwd(eng.cfg, eng.params, eng.rope, torch.tensor(pend), cache, pos,
                **eng._tp_kw)
    return lg.numpy()


def _verify_logits(eng, prompts: list, T: int, fwd) -> np.ndarray:
    """One batched verify step's logits ([B, T, vocab]) after each prompt's
    prefill: the pending token and T - 1 made-up drafts a row."""
    cache, pend, poss = eng._prefill_batch_rows(prompts)
    feeds = [[t] + [(t * 7 + j) % eng.cfg.vocab_size for j in range(1, T)] for t in pend]
    lg, _ = fwd(eng.cfg, eng.params, eng.rope, torch.tensor(feeds),
                cache, torch.tensor(poss, dtype=torch.int32), **eng._tp_kw)
    return lg.numpy()


def twin_case(group, host: dict, cfg, compress: bool, tp_reduce: str, batches: list,
              T: int) -> list:
    """For each prompt list of ``batches``, on one engine with the overlap
    on: the batch cache after the rows' prefill (this rank's kv heads, as
    the step found it), the pending tokens and positions, the verify feeds
    (the pending token and T - 1 made-up drafts a row), and the logits of
    one batched decode step and one verify step through the monolithic
    forwards ("step", "verify") and the overlap twins ("step_ov",
    "verify_ov"), each on its own copy of that cache."""
    eng = engine(group, host, cfg, compress, tp_reduce=tp_reduce, tp_overlap=True)
    out = []
    for prompts in batches:
        cache, pend, poss = eng._prefill_batch_rows(prompts)
        pos = torch.tensor(poss, dtype=torch.int32)
        feeds = torch.tensor([[t] + [(t * 7 + j) % cfg.vocab_size for j in range(1, T)]
                              for t in pend])
        res = {"k": cache["k"].numpy().copy(), "v": cache["v"].numpy().copy(), "pend": pend,
               "pos": poss, "feeds": feeds.numpy()}
        for name, fwd, toks in (("step", llama.forward_batched, torch.tensor(pend)),
                                ("step_ov", llama.forward_batched_overlap, torch.tensor(pend)),
                                ("verify", llama.forward_batched_verify, feeds),
                                ("verify_ov", llama.forward_batched_verify_overlap, feeds)):
            own = {n: c.clone() for n, c in cache.items()}
            res[name] = fwd(cfg, eng.params, eng.rope, toks, own, pos, **eng._tp_kw)[0].numpy()
        out.append(res)
    return out


def _step_logits(eng, prompts: list) -> dict:
    """One batched decode step's and one verify step's logits through the
    monolithic forwards and, with the overlap on, through its twins."""
    out = {"step": _batched_logits(eng, prompts, llama.forward_batched),
           "verify": _verify_logits(eng, prompts, 4, llama.forward_batched_verify)}
    if eng.tp_overlap_active:
        out["step_ov"] = _batched_logits(eng, prompts, llama.forward_batched_overlap)
        out["verify_ov"] = _verify_logits(eng, prompts, 4, llama.forward_batched_verify_overlap)
    return out


def modes_case(group, host: dict, cfg, compress: bool, tp_reduce: str, tp_overlap: bool,
               prompt: list, prompts: list, steps: int, paths: bool = True) -> dict:
    """One engine of the given modes through every TP path: the first
    logits and a prefill-then-decode chain, ``generate`` (tokens and sent
    kB a token) and ``generate_fused``, solo spec, ``generate_batch``, one
    batched decode step and one verify step through the monolithic and the
    overlap forwards, ``generate_batch_spec``, the slab and paged sessions;
    the resolution, the two counters after the batched calls, and the
    bytes sent a decode token. ``paths`` False: the resolution and the two
    steps' logits only."""
    from dllama_tpu_torch.observability import MetricsRegistry

    reg = MetricsRegistry()
    eng = engine(group, host, cfg, compress, tp_reduce=tp_reduce, tp_overlap=tp_overlap,
                 metrics=reg)
    kw = eng._tp_kw
    out = {"resolved": {a: getattr(eng, a) for a in (
        "tp_reduce", "tp_reduce_active", "tp_reduce_reason", "tp_overlap_active",
        "tp_overlap_reason", "tp_wire")}}
    if not paths:
        return {**out, **_step_logits(eng, prompts)}
    first, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor([5]), eng.new_cache(), 0,
                             **kw)
    out["first"] = first.numpy()
    cache = eng.new_cache()
    lg, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor(PROMPT), cache, 0, **kw)
    chain = [lg.numpy()]
    tok = int(lg[-1].argmax())
    lg, _ = llama.forward(cfg, eng.params, eng.rope, torch.tensor([tok]), cache, len(PROMPT),
                          **kw)
    out["chain"] = chain + [lg.numpy()]
    c0 = _counts(reg)
    stream = list(eng.generate(prompt, steps))
    out["solo"] = [t for t, _ in stream]
    out["sent_kb"] = [s.sent_kb for _, s in stream]
    out["solo_counts"] = {k: v - c0[k] for k, v in _counts(reg).items()}
    out["fused"] = eng.generate_fused(prompt, steps)[0]
    out["spec_solo"] = [t for t, _ in eng.generate_spec(prompt, steps, draft_len=3)]
    c1 = _counts(reg)
    out["batch"] = eng.generate_batch(prompts, steps)
    out["batch_counts"] = {k: v - c1[k] for k, v in _counts(reg).items()}
    out["batch_again"] = eng.generate_batch(prompts, steps)
    c1 = {k: v - out["batch_counts"][k] for k, v in _counts(reg).items()}
    out["single"] = eng.generate_batch(prompts[:1], 4)
    out["single_counts"] = {k: v - c1[k] - out["batch_counts"][k]
                            for k, v in _counts(reg).items()}
    out.update(_step_logits(eng, prompts))
    rows, stats = eng.generate_batch_spec(prompts, steps, draft_len=3)
    out["spec"], out["spec_emitted"] = rows, stats["emitted"]
    out["slab"] = session_stream(eng, prompts, steps)
    out["paged"] = session_stream(eng, prompts, steps, kv_pages=16)
    out["counts"] = _counts(reg)
    return out


def seam_case(group, host: dict, cfg, site: str, prompts: list) -> dict:
    """With ``site:raise:times=1`` installed on every rank: whether the
    first ``generate_batch`` raised FaultInjected at that site, and the
    second call's streams (the engine goes on)."""
    from dllama_tpu_torch import faults

    eng = engine(group, host, cfg, tp_reduce="plain" if site == "tp_reduce" else "off",
                 tp_overlap=site == "overlap_split")
    faults.install(f"{site}:raise:times=1")
    try:
        try:
            eng.generate_batch(prompts, 4)
            raised = None
        except faults.FaultInjected as e:
            raised = e.site
        return {"raised": raised, "after": eng.generate_batch(prompts, 4)}
    finally:
        faults.clear()


def resolve_case(group, host: dict, cfg, tp_reduce: str, tp_overlap: bool,
                 prompts: list = ()) -> dict:
    """An engine's resolution of the two flags, and its ``generate_batch``
    of ``prompts`` (4 steps) when there are any."""
    eng = engine(group, host, cfg, tp_reduce=tp_reduce, tp_overlap=tp_overlap)
    out = {a: getattr(eng, a) for a in ("tp_reduce", "tp_reduce_active", "tp_reduce_reason",
                                        "tp_overlap_active", "tp_overlap_reason")}
    if prompts:
        out["batch"] = eng.generate_batch(list(prompts), 4)
    return out
