"""Bucketed KV slot pools in the port's ``BatchSession(bucket_kv=True)``
against the JAX package's, mirroring the bucket cases of
``tests/test_chunked_prefill.py`` and ``tests/test_continuous_batching.py``
run bucketed (CPU, float32, the same random params through
``from_jax_params``).

Each test runs the same admissions through both packages' sessions. The
host bookkeeping must match exactly: handles, migrations, the bucket and
row of every handle, ``reserved_tokens`` and a ``KVBudget``'s reservation
and rows per bucket. Greedy tokens must be equal, and the slabs' KV within
1e-5 of its magnitude (the JAX session exposes no logits; the KV is what
the next step's logits are computed from). Sampled rows use each package's
own generator: a sampled stream is held to the port's own runs, at one
pool capacity (the dequant-matmuls' split plans depend on the row count).

Beyond the reference: a bucket slab at the uniform pool's capacity gives
the uniform slab's bits, tokens and KV, sampled rows included; and a closed
session's slabs serve the next one, so an identical second wave captures no
graph.
"""

import jax
import numpy as np
import pytest
import torch

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
PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 11]]
TOL = 1e-5  # of the KV's max magnitude


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


SIDES = ((jsampler.SamplerConfig, jlc), (tsampler.SamplerConfig, tlc))


def _drain(sess, out):
    """One prefill_step per step_chunk, until every tracked row is done."""
    while any(not sess.is_done(b) for b in out):
        sess.prefill_step()
        for b, burst in sess.step_chunk().items():
            if b in out:
                out[b].extend(burst)
    return out


def _book(sess) -> dict:
    """The host bookkeeping both packages must agree on exactly."""
    return {"where": {h: (pool.ctx, row) for h, (pool, row) in sess._where.items()},
            "pools": {ctx: pool.cap for ctx, pool in sess._pools.items()},
            "migrations": sess.migrations, "reserved": sess.reserved_tokens,
            "occupied": sess.occupied, "free": len(sess.free_slots)}


def _kv(sess, handles) -> np.ndarray:
    """Each row's slab prefix up to its position, [rows, 2, L, P, kv, hd]
    stacked over the common length."""
    out = []
    for h in handles:
        pool, row = sess._where[h]
        p = int(pool.pos[row])
        out.append(np.stack([np.asarray(pool.cache[n])[:, row, :p] for n in ("k", "v")]))
    n = min(o.shape[2] for o in out)
    return np.stack([o[:, :, :n] for o in out])


def _both(params, script):
    """Run ``script(eng, SamplerConfig, lifecycle) -> (record, kv)`` on both
    packages: records equal, KV within TOL."""
    out = [script(eng, *side) for eng, side in zip(_engines(params), SIDES)]
    (jrec, jkv), (trec, tkv) = out
    assert trec == jrec
    if jkv is not None:
        assert np.abs(tkv - jkv).max() <= TOL * max(float(np.abs(jkv).max()), 1e-30)
    return trec


# -- tests/test_chunked_prefill.py's bucket cases --------------------------

@pytest.mark.parametrize("bucket_kv", [False, True])
def test_chunked_admission_with_resident_row(params, bucket_kv):
    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=3, chunk=4, bucket_kv=bucket_kv, min_bucket=8,
                                 prefill_chunk=5)
        got = {}
        res = sess.admit([5, 9, 3], steps=16, sampler=scfg(temperature=0.0, seed=7))
        got[res] = list(sess.step_chunk()[res])
        new = sess.admit_begin(LONG, steps=10, sampler=scfg(temperature=0.0, seed=23))
        got[new] = []
        mid = 0
        while new in sess.pending_prefills:
            _, finished = sess.prefill_step()
            fresh = sess.step_chunk()
            mid += not finished
            assert fresh.get(res) != []
            for b, burst in fresh.items():
                got[b].extend(burst)
        book = _book(sess)
        _drain(sess, got)
        kv = _kv(sess, [res, new])
        book2 = _book(sess)
        sess.close()
        return (got, mid, book, book2), kv

    rec = _both(params, script)
    assert rec[1] >= 3 and [len(v) for v in rec[0].values()] == [16, 10]


def test_migration_preserves_stream_and_counts(params):
    """Rows cross several buckets mid-stream (min_bucket 4): greedy rows
    and the migration count equal JAX's, and a sampled row alone in its
    pool emits the stream of the same row in a session whose only bucket
    is the full context (no migration, the same capacity)."""
    def script(eng, scfg, lc):
        budget = lc.KVBudget(4 * SHAPE["seq_len"])
        sess = eng.batch_session(max_batch=4, chunk=3, bucket_kv=True, min_bucket=4,
                                 prefill_chunk=2, kv_budget=budget)
        out = {}
        for p, seed in (([9, 2, 4], 5), ([7], 1)):
            out[sess.admit_begin(p, steps=30, sampler=scfg(temperature=0.0, seed=seed))] = []
        rows = []
        while any(not sess.is_done(b) for b in out):
            sess.prefill_step()
            for b, burst in sess.step_chunk().items():
                out[b].extend(burst)
            rows.append(dict(budget.rows_by_bucket()))
        book = _book(sess)
        kv = _kv(sess, sorted(out))
        sess.close()
        return (out, book, rows, budget.reserved), kv

    rec = _both(params, script)
    assert rec[1]["migrations"] >= 4 and rec[3] == 0
    te = _engines(params)[1]
    scfg = tsampler.SamplerConfig(temperature=1.1, topp=0.9, seed=5)
    streams = []
    for mb in (4, SHAPE["seq_len"]):
        sess = te.batch_session(max_batch=4, chunk=3, bucket_kv=True, min_bucket=mb,
                                prefill_chunk=2)
        h = sess.admit_begin([9, 2, 4], steps=30, sampler=scfg)
        streams.append((_drain(sess, {h: []})[h], sess.migrations))
        sess.close()
    assert streams[0][0] == streams[1][0] and streams[0][1] >= 3 and streams[1][1] == 0


def test_bucketed_pools_admit_strictly_more_rows(params):
    def script(eng, scfg, _lc):
        def admit_until_full(sess):
            n = 0
            while sess.can_admit(3, 4):
                sess.admit([5, 9, 3], steps=4)
                n += 1
            return n

        uni = eng.batch_session(max_batch=2, chunk=4)
        bkt = eng.batch_session(max_batch=2, chunk=4, bucket_kv=True, min_bucket=8)
        counts = [admit_until_full(uni), admit_until_full(bkt)]
        full = eng.batch_session(max_batch=2, chunk=4, bucket_kv=True, min_bucket=8)
        m = 0
        while full.can_admit(3, SHAPE["seq_len"]):
            full.admit_begin([5, 9, 3], steps=SHAPE["seq_len"])
            m += 1
        books = [_book(s) for s in (bkt, full)]
        for s in (uni, bkt, full):
            s.close()
        return (counts, m, books), None

    counts, m, _ = _both(params, script)
    assert counts[0] == 2 and counts[1] > counts[0] and m == 2


def test_cancel_mid_prefill_frees_slot_and_budget(params):
    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=1, chunk=4, bucket_kv=True, min_bucket=8,
                                 prefill_chunk=4)
        h = sess.admit_begin(LONG, steps=40)
        adv = sess.prefill_step()
        full = sess.can_admit(3, 4)
        sess.cancel(h)
        state = (sess.pending_prefills, sess.is_done(h), sess.finish_reason(h),
                 sess.step_chunk())
        sess.release(h)
        book = _book(sess)
        h2 = sess.admit([7], steps=10, sampler=scfg(temperature=0.0, seed=11))
        out = _drain(sess, {h2: []})[h2]
        sess.close()
        return (adv, full, state, book, h2, out), None

    rec = _both(params, script)
    assert rec[0] == (0, False) and rec[1] is False and rec[2] == ([], True, None, {})
    assert rec[3]["reserved"] == 0 and len(rec[5]) == 10


# -- tests/test_continuous_batching.py, bucketed ---------------------------

def test_mid_flight_admit_equals_jax(params):
    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=3, chunk=4, bucket_kv=True)
        got = {}
        for i, p in enumerate(PROMPTS):
            got[sess.admit(p, steps=12, sampler=scfg(temperature=0.0, seed=i))] = []
            for b, burst in sess.step_chunk().items():
                got[b].extend(burst)
        _drain(sess, got)
        book = _book(sess)
        sess.close()
        return (got, book), None

    got, _ = _both(params, script)
    assert all(len(r) == 12 for r in got.values())


def test_released_row_reuse_and_stop_tokens(params):
    """A released row is reused without clearing; a stop token truncates
    inclusively and frees the row early."""
    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=2, chunk=4, bucket_kv=True)
        first = sess.admit([9, 2, 4, 8, 1, 3], steps=8)
        a = _drain(sess, {first: []})[first]
        sess.release(first)
        reuse = sess.admit([7], steps=10)
        b = _drain(sess, {reuse: []})[reuse]
        stop = next(t for i, t in enumerate(b) if t not in b[:i] and i > 2)
        s2 = sess.admit([7], steps=10, stop_tokens=(stop,))
        c = _drain(sess, {s2: []})[s2]
        reason = sess.finish_reason(s2)
        book = _book(sess)
        sess.close()
        return (first, reuse, s2, a, b, c, reason, book), None

    rec = _both(params, script)
    assert rec[5] == rec[4][:len(rec[5])] and rec[6] == "stop"


def test_budget_accounting_and_validation(params):
    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=2, chunk=4, bucket_kv=True)
        short = sess.admit(PROMPTS[0], steps=6)
        long = sess.admit(PROMPTS[2], steps=11)
        bursts = {short: [], long: []}
        while not (sess.is_done(short) and sess.is_done(long)):
            for b, burst in sess.step_chunk().items():
                bursts[b].append(len(burst))
        book = _book(sess)
        errors = []
        for bad in ([], [1] * (SHAPE["seq_len"] + 1)):
            with pytest.raises(ValueError):
                sess.admit(bad, steps=4)
        sess.release(short)
        book2 = _book(sess)
        sess.close()
        for call in (lambda: sess.admit([5], steps=4), sess.step_chunk):
            with pytest.raises(RuntimeError):
                call()
            errors.append(True)
        return (bursts, book, book2, errors, sess.cache), sess

    out = [script(eng, *side) for eng, side in zip(_engines(params), SIDES)]
    assert out[1][0] == out[0][0] and [sum(v) for v in out[1][0][0].values()] == [6, 11]
    # a closed session admits nothing (the reference still counts its budget)
    assert out[1][1].free_slots == []


def test_staggered_arrivals_drain(params):
    queue = [([3 + i, 7, 11 + i][: 1 + i % 3], 4 + 3 * (i % 3)) for i in range(6)]

    def script(eng, scfg, _lc):
        sess = eng.batch_session(max_batch=1, chunk=3, bucket_kv=True, min_bucket=8)
        pending, live, got, peak = list(enumerate(queue)), {}, {}, 0
        for _ in range(50):
            while pending and sess.can_admit(len(pending[0][1][0]), pending[0][1][1]):
                i, (p, n) = pending.pop(0)
                live[sess.admit(p, steps=n)] = i
                got[i] = []
            peak = max(peak, len(live))
            for h, burst in sess.step_chunk().items():
                got[live[h]].extend(burst)
            for h in [h for h in live if sess.is_done(h)]:
                sess.release(h)
                del live[h]
            if not pending and not live:
                break
        book = _book(sess)
        sess.close()
        return ([got[i] for i in range(len(queue))], peak, book), None

    got, peak, _ = _both(params, script)
    assert peak > 1  # more rows than the uniform pool's one, under its budget
    assert [len(r) for r in got] == [n for _, n in queue]


# -- beyond the reference --------------------------------------------------

def test_bucket_slab_at_uniform_capacity_gives_uniform_bits(params):
    """Two equal-length prompts land in one bucket and grow it to
    capacity 2, the uniform pool's; they migrate together, so every
    pool they decode in has capacity 2. Their tokens, sampled included,
    and their KV equal the uniform pool's bit for bit, and the migrated
    slab prefix equals the source slab's."""
    te = _engines(params)[1]
    scfgs = [tsampler.SamplerConfig(temperature=0.9, topp=0.9, seed=3),
             tsampler.SamplerConfig(temperature=0.0, seed=4)]
    prompts = [LONG[:9], LONG[5:14]]
    runs = []
    for bucket_kv in (False, True):
        sess = te.batch_session(max_batch=2, chunk=4, bucket_kv=bucket_kv, min_bucket=16)
        hs = [sess.admit(p, steps=30, sampler=s) for p, s in zip(prompts, scfgs)]
        got = {h: [] for h in hs}
        copies = []
        orig = te._bucket_cache_migrate

        def spy(dst, src, sb, db):
            orig(dst, src, sb, db)
            copies.append(all(torch.equal(dst[n][:, db, :src[n].shape[2]], src[n][:, sb])
                              for n in ("k", "v")))

        te._bucket_cache_migrate = spy
        while any(not sess.is_done(h) for h in hs):
            for h, burst in sess.step_chunk().items():
                got[h].extend(burst)
            if bucket_kv:
                assert {pool.cap for pool in sess._pools.values()} == {2}
        del te._bucket_cache_migrate
        kv = [np.stack([sess._where[h][0].cache[n][:, sess._where[h][1], :38].numpy()
                        for n in ("k", "v")]) for h in hs]
        runs.append(([got[h] for h in hs], kv, sess.migrations, copies))
        sess.close()
    (uni, ukv, _, _), (bkt, bkv, migrations, copies) = runs
    assert bkt == uni and all(np.array_equal(a, b) for a, b in zip(ukv, bkv))
    assert migrations == 4 and copies == [True] * 4


def test_second_identical_wave_captures_no_graph(params):
    """A closed bucketed session leaves its slabs on the engine; an
    identical second session takes them and replays the graphs made on
    them, so it makes none, and its rows equal the first wave's."""
    te = _engines(params)[1]
    waves = []
    for _ in range(2):
        made = te.graphs.made
        sess = te.batch_session(max_batch=2, chunk=4, bucket_kv=True, min_bucket=8)
        hs = [sess.admit(p, steps=14) for p in PROMPTS[:2]]
        got = _drain(sess, {h: [] for h in hs})
        sess.close()
        waves.append(([got[h] for h in hs], te.graphs.made - made))
    assert waves[1][0] == waves[0][0] and waves[0][1] > 0 and waves[1][1] == 0
    kept = sum(c["k"].shape[1] * c["k"].shape[2] for c in te._slabs)
    assert 0 < kept <= 2 * SHAPE["seq_len"]
