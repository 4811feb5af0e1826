"""Rank-side cases of the control-plane tests (``parallel.control``).

``parallel.group.LocalWorld`` runs each function here on every rank of a
gloo world of CPU processes (``fn(group, *args)``), so they live in a module
that imports only torch and the port (never JAX). Rank 0 drives a
``TPEngine``; every other rank follows.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from dllama_tpu_torch import faults
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.quants import blocks
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel.control import Channel, TPEngine, follow
from dllama_tpu_torch.runtime.generate import Engine
from dllama_tpu_torch.runtime.sampler import SamplerConfig
from dllama_tpu_torch.serving.lifecycle import KVBudget

P1 = [1, 5, 9, 13, 2, 7, 3, 4, 11, 12, 40, 41]
P2 = [1, 5, 9, 13, 2, 7, 3, 4, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]
#: :func:`crowd`'s prompts: two cached 33-token prompts, one that fills the
#: arena, a short one that forces an eviction, and a waiter on A's prefix
A = [3 + i for i in range(33)]
B = [100 + i for i in range(33)]
C = [200 + i % 60 for i in range(200)]
D = [150 + i for i in range(10)]
W = A[:32] + [60 + i for i in range(20)]
#: the fault plan :func:`drive` runs under
FAULTS = "prefix_match:raise:times=1"


def write_files(d: Path) -> tuple:
    """(m.m, t.t) in ``d``: the server tests' byte tokenizer and a Q40 model
    of the smallest widths that shard two ways (dim 128, hidden 256, 4
    heads, 2 kv heads, 2 layers)."""
    vocab = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % b for b in range(256)]
    vocab += [b" ", b"e", b"t", b"he", b" the", b"hello", b" world"]
    scores = [0.0] * 259 + [-1.0, -2.0, -2.0, -1.5, -1.2, -1.1, -1.1]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=len(vocab), seq_len=256,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    write_model(str(d / "m.m"), spec, {
        e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                 else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
        for e in tensor_plan(spec)})
    return d / "m.m", d / "t.t"


def file_engine(group, path: str, tp_reduce: str = "off", tp_overlap: bool = False) -> Engine:
    """The q40 f32 engine of the `.m` file at ``path`` (this rank's shard
    under ``group``, wo/w2 as row shards with ``tp_reduce``; the whole
    model with None)."""
    with WeightFileReader(path) as reader:
        cfg = ModelConfig.from_spec(reader.spec, dtype="float32")
        params = llama.quant_params_from_reader(
            reader, cfg, "cpu", "q40", tp=group,
            tp_reduce=group is not None and tp_reduce != "off")
    return Engine(cfg, params, SamplerConfig(temperature=0.0, seed=0), device="cpu",
                  cuda_graphs=False, tp=group, metrics=None, tp_reduce=tp_reduce,
                  tp_overlap=tp_overlap)


def drive(eng) -> list:
    """The server's engine calls on ``eng`` (an Engine or rank 0's
    TPEngine), with what the host sees of each: a bucketed pool with a
    monolithic and a chunked admission (a row migrating to a longer
    bucket), a cancel, a paged pool with an
    external KV budget whose first admission the ``prefix_match`` seam
    fails (armed with :data:`FAULTS` on every rank), two rows with a shared
    prefix, a stream abandoned after 3 tokens, then a batch."""
    out = []
    sess = eng.batch_session(2, chunk=4, prefill_chunk=8, bucket_kv=True, min_bucket=16)
    a = sess.admit(P1, 12)
    b = sess.admit_begin(P2, 20)
    while sess.prefill_step() != (b, True):
        pass
    out.append(sess.step_chunk())
    sess.cancel(a)
    sess.release(a)
    while not sess.is_done(b):
        out.append(sess.step_chunk())
    sess.release(b)
    out.append(sess.migrations)
    sess.close()

    budget = KVBudget(2 * eng.cfg.seq_len)
    paged = eng.batch_session(2, chunk=4, kv_pages=4, kv_budget=budget)
    try:
        paged.admit(P1, 6)
    except faults.FaultInjected as e:
        out.append(type(e).__name__)
    rows = [paged.admit(P1, 6), paged.admit(P1[:8] + [50, 51, 52], 6)]
    out.append(paged.page_stats())
    while not all(paged.is_done(r) for r in rows):
        out.append(paged.step_chunk())
    for r in rows:
        paged.release(r)
    out.append(budget.reserved)
    paged.close()

    stream = eng.generate(P2, 8)
    out.append([next(stream)[0] for _ in range(3)])
    del stream  # abandoned: the followers drop theirs with the next op
    out.append(eng.generate_batch([P1, P2], 4))
    return out


def crowd(eng, probes: int = 3) -> list:
    """A paged arena of 16 pages of 16 tokens on ``eng`` (an Engine or rank
    0's TPEngine): A and B run and leave their prefixes cached, C fills the
    arena (evicting A's last block), the server's scheduler asks
    ``can_admit`` for the waiter W ``probes`` times (a host read, which rank
    0 alone makes), D evicts one more cached page, and W, admitted once C
    and D are gone (after a prompt on B's prefix, which aliases it), takes
    what the cache still holds of A. Returns what the host sees of each
    step: {"chunks", "probes", "after_d", "end"} (the last two page
    stats)."""
    sess = eng.batch_session(1, chunk=4, kv_pages=16)
    out = {"chunks": []}

    def finish(h):
        while not sess.is_done(h):
            out["chunks"].append(sess.step_chunk())
        sess.release(h)

    for p in (A, B):
        finish(sess.admit(p, 2))
    c = sess.admit(C, 1)
    out["probes"] = [sess.can_admit(len(W), 28, W) for _ in range(probes)]
    d = sess.admit(D, 2)
    out["after_d"] = sess.page_stats()
    finish(d)
    finish(c)
    finish(sess.admit(B[:32] + [61, 62, 63], 4))
    finish(sess.admit(W, 4))
    out["end"] = sess.page_stats()
    sess.close()
    return out


def crowd_case(group, path: str) -> dict:
    """:func:`crowd` on rank 0 over a TPEngine, and its stop report; every
    other rank: its follow report."""
    eng = file_engine(group, path)
    if group.rank != 0:
        return {"report": follow(eng, group)}
    plane = TPEngine(eng, group)
    got = crowd(plane)
    return {"report": plane.stop(), "drive": got}


def control_case(group, path: str, tp_reduce: str = "off", tp_overlap: bool = False) -> dict:
    """Rank 0: :func:`drive` over a TPEngine, and its stop report; every
    other rank: its follow report (each with the ops' host results in
    ``tail``). ``tp_reduce``, ``tp_overlap``: the engines' modes."""
    eng = file_engine(group, path, tp_reduce, tp_overlap)
    faults.install(FAULTS)
    try:
        if group.rank != 0:
            return {"report": follow(eng, group)}
        plane = TPEngine(eng, group)
        got = drive(plane)
        return {"report": plane.stop(), "drive": got}
    finally:
        faults.clear()


class Echo:
    """An engine stand-in whose one call launches nothing."""

    def generate_batch(self, prompts: list, steps: int) -> list:
        return [p[:steps] for p in prompts]


def idle_case(group, idle_s: float, limit_s: float) -> dict:
    """Rank 0 idles ``idle_s`` over a channel whose timeout is ``limit_s``
    (keepalives every quarter of it), then sends one op and stops. Then a
    second channel of the same timeout with no keepalive: rank 0 sends
    nothing and every other rank's wait for an op times out."""
    eng = Echo()
    if group.rank == 0:
        plane = TPEngine(eng, group, timeout_s=limit_s)
        time.sleep(idle_s)
        out = plane.generate_batch([[1, 2, 3]], 2)
        report = plane.stop()
        Channel(group, limit_s)
        time.sleep(2 * limit_s)
        return {"out": out, "in_step": report["in_step"]}
    report = follow(eng, group, timeout_s=limit_s)
    bare = Channel(group, limit_s)
    t0 = time.monotonic()
    try:
        bare.recv()
        err = None
    except RuntimeError as e:
        err = str(e)[:200]
    return {"report": report, "err": err, "waited_s": time.monotonic() - t0}

