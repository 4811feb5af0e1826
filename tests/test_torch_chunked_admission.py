"""Chunked admission in the port's uniform ``BatchSession`` (``admit_begin``
+ ``prefill_step``, ``prefill_chunk``, the ``kv_budget`` accountant) against
the JAX package's ``BatchSession(bucket_kv=False, prefill_chunk=...)``,
mirroring ``tests/test_chunked_prefill.py``'s slab-mode tests (CPU, float32,
the same random params).

A prompt consumed in pieces runs other kernel shapes than one monolithic
prefill, so the port holds chunked logits to 1e-5 of their magnitude
(against its own monolithic prefill and against JAX's chunked prefill), and
greedy streams to JAX's tokens exactly: a long prompt admitted piece by
piece while a resident row keeps decoding, the FIFO order of pending
prefills, ``can_admit`` against a ``KVBudget`` shared by two sessions,
cancel mid-prefill, and the ``prefill_chunk`` fault seam.
"""

import jax
import numpy as np
import pytest

from dllama_tpu import faults as jfaults
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu.serving import lifecycle as jlc
from dllama_tpu_torch import faults as tfaults
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.serving import lifecycle as tlc

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
LONG = [(i * 7 + 3) % 96 for i in range(23)]
TOL = 1e-5  # of max |logit|


@pytest.fixture(scope="module")
def params():
    jp = jl.random_params(JConfig(**SHAPE), seed=1, dtype=np.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TConfig(**SHAPE), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _engines(params):
    jp, tp = params
    return (jgen.Engine(JConfig(**SHAPE), jp, jsampler.SamplerConfig(temperature=0.0),
                        metrics=None),
            tgen.Engine(TConfig(**SHAPE), tp, tsampler.SamplerConfig(temperature=0.0),
                        device="cpu", metrics=None))


SIDES = ((0, jfaults, jsampler.SamplerConfig, jlc), (1, tfaults, tsampler.SamplerConfig, tlc))


def _drain(sess, out):
    """One prefill_step per step_chunk — the scheduler's tick — until every
    tracked slot is done; extends ``out`` in place."""
    while any(not sess.is_done(b) for b in out):
        sess.prefill_step()
        for b, burst in sess.step_chunk().items():
            if b in out:
                out[b].extend(burst)
    return out


def test_chunked_prefill_logits_within_tolerance(params):
    je, te = _engines(params)
    mono = te.prefill(te.new_cache(), LONG)[0].numpy()
    scale = float(np.abs(mono).max())
    n = len(LONG)
    for chunk in (1, 4, 7, 16, n, n + 5):
        got = te.prefill(te.new_cache(), LONG, chunk=chunk)[0].numpy()
        want = np.asarray(je.prefill(je.new_cache(), LONG, chunk=chunk)[0])
        assert np.abs(got - mono).max() <= TOL * scale, f"chunk={chunk}"
        assert np.abs(got - want).max() <= TOL * scale, f"chunk={chunk}"
        assert int(got.argmax()) == int(want.argmax())


def test_chunked_admission_with_a_resident_row_equals_jax(params):
    """A 22-token prefix admitted 5 tokens a tick while a resident row keeps
    decoding: the resident row is never starved, the newcomer stays
    mid-prefill for several ticks, and both greedy streams are JAX's."""
    out = []
    for eng, (_, _, scfg, _) in zip(_engines(params), SIDES):
        sess = eng.batch_session(max_batch=3, chunk=4, prefill_chunk=5)
        res = sess.admit([5, 9, 3], steps=16, sampler=scfg(temperature=0.0, seed=7))
        got = {res: list(sess.step_chunk()[res])}
        new = sess.admit_begin(LONG, steps=10, sampler=scfg(temperature=0.0, seed=23))
        got[new] = []
        assert sess.pending_prefills == [new] and sess.num_live == 1
        mid = 0
        while new in sess.pending_prefills:
            _, finished = sess.prefill_step()
            fresh = sess.step_chunk()
            if not finished:
                assert new not in fresh
                mid += 1
            assert fresh.get(res) != []  # the resident row nets tokens every tick
            for b, burst in fresh.items():
                got[b].extend(burst)
        assert mid >= 3 and sess.prefill_ms > 0.0 and sess.prefill_ms_of(new) > 0.0
        _drain(sess, got)
        sess.close()
        out.append([got[res], got[new]])
    assert out[1] == out[0] and [len(r) for r in out[1]] == [16, 10]


def test_chunked_rows_do_not_depend_on_when_their_pieces_ran(params):
    """At one prefill_chunk, sampled rows emit the same tokens whether their
    pieces ran back to back or interleaved with decode chunks."""
    _, te = _engines(params)
    reqs = [(LONG, tsampler.SamplerConfig(temperature=0.9, topp=0.9, seed=4)),
            (LONG[:13], tsampler.SamplerConfig(temperature=1.2, topp=0.8, seed=5))]
    runs = []
    for interleave in (False, True):
        sess = te.batch_session(max_batch=2, chunk=4, prefill_chunk=4)
        got = {sess.admit_begin(p, steps=9, sampler=s): [] for p, s in reqs}
        if not interleave:
            while sess.prefill_step() is not None:
                pass
        runs.append(list(_drain(sess, got).values()))
        sess.close()
    assert runs[0] == runs[1] and all(len(r) == 9 for r in runs[0])


def test_pending_prefills_are_served_oldest_first(params):
    out = []
    for eng, (_, _, scfg, _) in zip(_engines(params), SIDES):
        sess = eng.batch_session(max_batch=3, chunk=4, prefill_chunk=8)
        hs = [sess.admit_begin(LONG[:n], steps=4, sampler=scfg(temperature=0.0, seed=n))
              for n in (20, 9, 17)]
        order = [list(sess.pending_prefills)]
        while sess.pending_prefills:
            order.append(sess.prefill_step())
            order.append(list(sess.pending_prefills))
        assert sess.prefill_step() is None
        out.append((hs, order, list(_drain(sess, {h: [] for h in hs}).values())))
        sess.close()
    assert out[1] == out[0]


def test_can_admit_against_a_shared_kv_budget(params):
    """Two sessions share one accountant of 3 full-context rows: every
    admission decision, reservation and gauge equals the JAX sessions'."""
    S = SHAPE["seq_len"]
    out = []
    for eng, (_, _, scfg, lc) in zip(_engines(params), SIDES):
        budget = lc.KVBudget(3 * S)
        a = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=6, kv_budget=budget)
        b = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=6, kv_budget=budget)
        log = []
        for sess, prompt in ((a, [1, 2, 3]), (a, LONG), (b, [4]), (b, [5, 6])):
            ok = sess.can_admit(len(prompt), 5, prompt)
            h = sess.admit_begin(prompt, 5, sampler=scfg(temperature=0.0)) if ok else None
            log.append((ok, h, budget.reserved, budget.rows_by_bucket(),
                        a.reserved_tokens, b.reserved_tokens, a.pending_prefills))
        a.cancel(1)
        a.release(1)
        log.append((b.can_admit(2, 5), budget.reserved, a.reserved_tokens))
        b.close()
        log.append((budget.reserved, a.can_admit(2, 5)))
        a.close()
        log.append(budget.reserved)
        out.append(log)
    assert out[1] == out[0]
    assert [entry[0] for entry in out[1][:4]] == [True, True, True, False]


def test_cancel_mid_prefill_frees_the_slot_and_the_budget(params):
    out = []
    for eng, (_, _, scfg, lc) in zip(_engines(params), SIDES):
        budget = lc.KVBudget(SHAPE["seq_len"])
        sess = eng.batch_session(max_batch=1, chunk=4, prefill_chunk=4, kv_budget=budget)
        h = sess.admit_begin(LONG, steps=40)
        assert sess.prefill_step() == (h, False)
        assert not sess.can_admit(3, 4) and budget.reserved == SHAPE["seq_len"]
        sess.cancel(h)
        assert sess.pending_prefills == [] and sess.is_done(h)
        assert sess.finish_reason(h) is None and sess.step_chunk() == {}
        sess.release(h)
        assert sess.reserved_tokens == 0 and budget.reserved == 0 and sess.can_admit(3, 4)
        h2 = sess.admit([7], steps=10, sampler=scfg(temperature=0.0, seed=11))
        out.append(_drain(sess, {h2: []})[h2])
        sess.close()
    assert out[1] == out[0] and len(out[1]) == 10


def test_prefill_chunk_fault_seam(params):
    """A fault at prefill_chunk surfaces in prefill_step as FaultInjected;
    the cursor has not moved, so a retry consumes the same piece and the
    stream is JAX's."""
    out = []
    for eng, (_, faults, scfg, _) in zip(_engines(params), SIDES):
        sess = eng.batch_session(max_batch=1, chunk=4, prefill_chunk=6)
        h = sess.admit_begin(LONG, steps=6, sampler=scfg(temperature=0.0, seed=1))
        faults.install("prefill_chunk:raise:times=1")
        with pytest.raises(faults.FaultInjected):
            sess.prefill_step()
        assert sess.pending_prefills == [h]
        out.append(_drain(sess, {h: []})[h])
        sess.close()
    assert out[1] == out[0] and len(out[1]) == 6
