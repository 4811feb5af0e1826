"""Continuous batching in the port (``Engine.batch_session``, the uniform
``BatchSession``) on the CPU, mirroring ``tests/test_continuous_batching.py``.

Membership in the pool is invisible in a row's tokens: at a fixed pool size
a row admitted mid-flight, or into a slot a previous request just vacated,
emits bit for bit the tokens it emits admitted at the start into an empty
pool; greedy rows equal the JAX package's BatchSession rows. A live row nets
at least one token per chunk, budgets and stop tokens truncate as the
reference does, and the bucketed and paged layouts admit and equal JAX.
"""

import jax
import numpy as np
import pytest

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime.sampler import SamplerConfig

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 11]]  # mixed lengths incl. 1
SAMPLERS = [SamplerConfig(temperature=0.9, topp=0.95, seed=7),
            SamplerConfig(temperature=0.0, seed=1),  # a greedy row in the mix
            SamplerConfig(temperature=1.3, topp=0.8, seed=42)]


def _model(seed, quant=None):
    jc, tc = JConfig(**SHAPE), TConfig(**SHAPE)
    jp = jl.random_params(jc, seed=seed, dtype=np.float32)
    if quant:
        jp = jl.quantize_params(jp, quant)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu"), jc, tc


def _engine(tp, tc):
    return tgen.Engine(tc, tp, SamplerConfig(temperature=0.0), device="cpu")


def _drain(sess, slots):
    """Step until every slot in ``slots`` is done; return {slot: tokens}."""
    out = {b: [] for b in slots}
    while any(not sess.is_done(b) for b in slots):
        for b, burst in sess.step_chunk().items():
            if b in out:
                out[b].extend(burst)
    return out


def _alone(tp, tc, prompt, steps, sampler, max_batch=3, chunk=4):
    """The row's tokens admitted first into an empty pool of ``max_batch``."""
    sess = _engine(tp, tc).batch_session(max_batch=max_batch, chunk=chunk)
    h = sess.admit(prompt, steps=steps, sampler=sampler)
    got = _drain(sess, [h])[h]
    sess.close()
    return got


def test_mid_flight_admit_bit_identical_to_admitted_at_start():
    _, tp, _, tc = _model(0)
    want = [_alone(tp, tc, p, 12, s) for p, s in zip(PROMPTS, SAMPLERS)]
    sess = _engine(tp, tc).batch_session(max_batch=3, chunk=4)
    got = {}
    s0 = sess.admit(PROMPTS[0], steps=12, sampler=SAMPLERS[0])
    got[s0] = []
    for b, burst in sess.step_chunk().items():  # row 0 is already 4 deep...
        got[b].extend(burst)
    s1 = sess.admit(PROMPTS[1], steps=12, sampler=SAMPLERS[1])  # ...join now
    got[s1] = []
    for b, burst in sess.step_chunk().items():
        got[b].extend(burst)
    s2 = sess.admit(PROMPTS[2], steps=12, sampler=SAMPLERS[2])  # 8 deep
    got[s2] = []
    for b, tokens in _drain(sess, [s0, s1, s2]).items():
        got[b].extend(tokens)
    sess.close()
    assert [got[s0], got[s1], got[s2]] == want
    assert all(len(r) == 12 for r in want)


@pytest.mark.parametrize("quant", ["q40", "q80"])
def test_greedy_session_rows_equal_jax(quant):
    jp, tp, jc, tc = _model(1, quant)

    def run(sess):
        a = sess.admit(PROMPTS[0], steps=10)
        first = dict(sess.step_chunk())
        b = sess.admit(PROMPTS[2], steps=10)
        rest = _drain(sess, [a, b])
        sess.close()
        return [first[a] + rest[a], rest[b]]

    want = run(jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0),
                           metrics=None).batch_session(max_batch=2, chunk=4))
    got = run(_engine(tp, tc).batch_session(max_batch=2, chunk=4))
    assert got == want and all(len(r) == 10 for r in got)


def test_released_slot_reuse_no_contamination():
    """A slot vacated by release() is reused without clearing: the 1-token
    successor's pos-0 write leaves every other position holding the first
    request's KV, all of which must stay masked."""
    _, tp, _, tc = _model(3)
    sess = _engine(tp, tc).batch_session(max_batch=2, chunk=4)
    first = sess.admit([9, 2, 4, 8, 1, 3], steps=8, sampler=SamplerConfig(1.1, 0.9, 5))
    _drain(sess, [first])
    sess.release(first)
    assert sess.free_slots == [0, 1]
    scfg = SamplerConfig(temperature=0.8, seed=11)
    reuse = sess.admit([7], steps=10, sampler=scfg)
    assert reuse == first  # the lowest free slot: the same slab
    got = _drain(sess, [reuse])[reuse]
    sess.close()
    assert got == _alone(tp, tc, [7], 10, scfg, max_batch=2)


def test_stop_token_truncates_inclusively_and_frees_early():
    _, tp, _, tc = _model(5)
    full = _alone(tp, tc, PROMPTS[0], 16, None, max_batch=2)
    # the first token that does not appear earlier: stopping on it ends the
    # row exactly where the full stream first emits it
    k = next(i for i, t in enumerate(full) if t not in full[:i])
    sess = _engine(tp, tc).batch_session(max_batch=2, chunk=4)
    s0 = sess.admit(PROMPTS[0], steps=16, stop_tokens=(full[k],))
    got = _drain(sess, [s0])[s0]
    assert got == full[: k + 1] and sess.finish_reason(s0) == "stop"
    sess.release(s0)
    sess.close()


def test_budget_and_accounting():
    _, tp, _, tc = _model(6)
    sess = _engine(tp, tc).batch_session(max_batch=2, chunk=4)
    short = sess.admit(PROMPTS[0], steps=6)  # done after chunk 2
    long = sess.admit(PROMPTS[2], steps=11)
    assert sess.occupied == [short, long] and sess.num_live == 2 and not sess.can_admit(3, 4)
    bursts = {short: [], long: []}
    while not (sess.is_done(short) and sess.is_done(long)):
        fresh = sess.step_chunk()
        assert all(burst for burst in fresh.values())  # live rows always net
        for b, burst in fresh.items():
            bursts[b].append(len(burst))
    assert sum(bursts[short]) == 6 and sum(bursts[long]) == 11
    assert len(bursts[short]) == 2  # 4 + 2, absent from later chunks
    assert sess.num_live == 0 and sess.finish_reason(short) == "length"
    assert sess.step_chunk() == {}  # nothing live: no device work
    assert sess.decode_ms > 0 and sess.prefill_ms_of(long) > 0
    sess.release(short)
    assert sess.free_slots == [0] and sess.can_admit(3, 4)
    with pytest.raises(ValueError):
        sess.is_done(short)  # a released slot is no longer queryable
    sess.close()


def test_admit_validation_cancel_and_close():
    _, tp, _, tc = _model(0)
    sess = _engine(tp, tc).batch_session(max_batch=1, chunk=2)
    with pytest.raises(ValueError):
        sess.admit([], steps=4)  # an empty prompt
    with pytest.raises(ValueError):
        sess.admit([1] * (tc.seq_len + 1), steps=4)  # longer than the context
    h = sess.admit([5], steps=4)
    with pytest.raises(RuntimeError):
        sess.admit([7], steps=4)  # the pool is full
    sess.cancel(h)
    assert sess.is_done(h) and sess.finish_reason(h) is None and sess.step_chunk() == {}
    sess.close()
    assert sess.cache is None and sess.free_slots == []
    with pytest.raises(RuntimeError):
        sess.admit([5], steps=4)  # a closed session
    with pytest.raises(RuntimeError):
        sess.step_chunk()


def test_staggered_arrivals_drain():
    """More requests than slots, admitted into freed slots between chunks:
    every request completes with the tokens it gets admitted alone."""
    _, tp, _, tc = _model(13)
    queue = [([3 + i, 7, 11 + i][: 1 + i % 3], 4 + 3 * (i % 3)) for i in range(6)]
    want = [_alone(tp, tc, p, n, None, max_batch=2, chunk=3) for p, n in queue]
    sess = _engine(tp, tc).batch_session(max_batch=2, chunk=3)
    pending, live, got = list(enumerate(queue)), {}, {}
    for _ in range(50):
        while pending and sess.free_slots:
            i, (p, n) = pending.pop(0)
            live[sess.admit(p, steps=n)] = i
            got[i] = []
        for h, burst in sess.step_chunk().items():
            got[live[h]].extend(burst)
        for h in [h for h in live if sess.is_done(h)]:
            sess.release(h)
            del live[h]
        if not pending and not live:
            break
    sess.close()
    assert [got[i] for i in range(len(queue))] == want


@pytest.mark.parametrize("mode", [dict(bucket_kv=True), dict(bucket_kv=True, prefill_chunk=16),
                                  dict(kv_pages=16)])
def test_unported_modes_raise(mode):
    """The layouts that were refused before they were ported (the name is
    kept): each session now admits mid-flight and its greedy rows equal the
    JAX package's session in the same layout."""
    jp, tp, jc, tc = _model(0)

    def run(sess):
        a = sess.admit(PROMPTS[0], steps=10)
        first = dict(sess.step_chunk())
        b = sess.admit(PROMPTS[2], steps=10)
        rest = _drain(sess, [a, b])
        sess.close()
        return [a, b], [first[a] + rest[a], rest[b]]

    want = run(jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0),
                           metrics=None).batch_session(max_batch=2, chunk=4, **mode))
    got = run(_engine(tp, tc).batch_session(max_batch=2, chunk=4, **mode))
    assert got == want and all(len(r) == 10 for r in got[1])
