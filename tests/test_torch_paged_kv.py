"""Paged KV with the copy-on-write radix prefix cache in the port's
``BatchSession(kv_pages=...)``, against the JAX package's, mirroring the 13
tests of ``tests/test_paged_kv.py`` (CPU, float32, the same random params
through ``from_jax_params``).

Each test runs the same admissions through both packages' sessions. The
host bookkeeping must match exactly: handles, page tables, ``page_stats()``,
``prefix_hit_rate``, reservations and the prefix, COW and eviction
counters. Greedy tokens must be equal, and the KV pages each row wrote
within 1e-5 of their magnitude (the JAX session exposes no logits; the
pages are what the next step's logits are computed from). Sampled rows use
each package's own generator, so a sampled stream is held to the port's
own cold run: a warm (aliased) admission emits the cold stream.

Beyond the reference: the paged step's warm-up (what a CUDA graph capture
runs once) writes no page but the scratch page.
"""

import random

import jax
import numpy as np
import pytest
import torch

from dllama_tpu import faults as jfaults
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import paged_kv as jpaged
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import faults as tfaults
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import paged_kv as tpaged
from dllama_tpu_torch.runtime import sampler as tsampler

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
LONG = [(i * 7 + 3) % 96 for i in range(23)]
TOL = 1e-5  # of the pages' max magnitude


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


class Side:
    """One package's engine maker, sampler config, fault module."""

    def __init__(self, name, make, scfg, faults):
        self.name, self.make, self.scfg, self.faults = name, make, scfg, faults

    def greedy(self, seed=0):
        return self.scfg(temperature=0.0, seed=seed)


def _sides(params):
    jp, tp = params
    return (Side("jax", lambda: jgen.Engine(JConfig(**SHAPE), jp,
                                            jsampler.SamplerConfig(temperature=0.0),
                                            metrics=None),
                 jsampler.SamplerConfig, jfaults),
            Side("torch", lambda: tgen.Engine(TConfig(**SHAPE), tp,
                                              tsampler.SamplerConfig(temperature=0.0),
                                              device="cpu", metrics=None),
                 tsampler.SamplerConfig, tfaults))


def _drain(sess, out):
    """One prefill_step per step_chunk, until every tracked row is done."""
    while any(not sess.is_done(b) for b in out):
        sess.prefill_step()
        for b, burst in sess.step_chunk().items():
            if b in out:
                out[b].extend(burst)
    return out


def _pages(sess, handles) -> np.ndarray:
    """The KV pages the rows hold, [2, L, n, page, kv, hd] f32."""
    idx = sorted({p for h in handles for p in sess._rowpages[h].blocks})
    return np.stack([np.asarray(sess._arena[n])[:, idx] for n in ("k", "v")])


def _book(sess) -> dict:
    """The host bookkeeping both packages must agree on exactly."""
    stats = sess.page_stats()
    return {"stats": stats, "hit_rate": sess.prefix_hit_rate,
            "reserved": sess.reserved_tokens, "occupied": sess.occupied,
            "tables": {h: list(rp.blocks) for h, rp in sess._rowpages.items()},
            "counters": (sess.prefix_hits, sess.prefix_misses, sess.prefix_tokens_matched,
                         sess.cow_copies, sess.prefix_evictions, sess.regroups,
                         sess.migrations)}


def _both(params, script):
    """Run ``script(side) -> (record, pages)`` on both packages: records
    equal, pages within TOL."""
    out = [script(side) for side in _sides(params)]
    (jrec, jpg), (trec, tpg) = out
    assert trec == jrec
    if jpg is not None:
        scale = max(float(np.abs(jpg).max()), 1e-30)
        assert np.abs(tpg - jpg).max() <= TOL * scale
    return trec


def _cold_stream(params, prompt, steps, scfg):
    """The port's stream of a cold paged admission (the sampled baseline)."""
    eng = _sides(params)[1].make()
    sess = eng.batch_session(max_batch=3, chunk=4, prefill_chunk=5, kv_pages=8)
    h = sess.admit_begin(prompt, steps=steps, sampler=scfg)
    got = _drain(sess, {h: []})[h]
    sess.close()
    return got


# -- allocator and radix tree ----------------------------------------------

def test_page_allocator_radix_fuzz():
    """The reference's op storm on both packages' allocators and radix
    trees in lockstep: every page handed out, every eviction and every
    invariant check agree; nothing leaks."""
    trails = []
    for mod in (jpaged, tpaged):
        rng = random.Random(0)
        alloc, radix = mod.PageAllocator(33, 4), mod.RadixPrefixCache(4)
        rows, nexth, trail = {}, 0, []
        for _ in range(1200):
            op = rng.random()
            if op < 0.45:
                tokens = [rng.randrange(4) for _ in range(rng.randrange(1, 20))]
                path = radix.match(tokens)[:(len(tokens) - 1) // 4]
                priv = max(0, mod.pages_for(len(tokens) + rng.randrange(0, 8), 4) - len(path))
                pinned = sum(1 for n in path if alloc.refcount(n.page) == 0)
                if not alloc.can_reserve(priv + pinned):
                    continue
                for n in path:
                    alloc.ref(n.page)
                alloc.reserve(priv)
                pages = [n.page for n in path]
                for _k in range(priv):
                    p = alloc.alloc()
                    if p is None:
                        trail.append(("evict", radix.evict(1, alloc)))
                        p = alloc.alloc()
                    pages.append(p)
                nins = min(len(pages), (len(tokens) - 1) // 4)
                for p in radix.insert(tokens, pages[:nins]):
                    alloc.hold(p)
                rows[nexth] = pages
                nexth += 1
                trail.append(("admit", tuple(pages)))
            elif op < 0.80 and rows:
                for p in rows.pop(rng.choice(sorted(rows))):
                    alloc.unref(p)
            elif op < 0.90:
                trail.append(("evict", radix.evict(rng.randrange(1, 4), alloc)))
            alloc.check()
            trail.append(alloc.stats()["pages_free"])
        for pages in rows.values():
            for p in pages:
                alloc.unref(p)
        radix.evict(33, alloc)
        alloc.check()
        assert alloc.free_count == 32 and len(radix) == 0
        trails.append(trail)
    assert trails[1] == trails[0] and sum(t[0] == "evict" for t in trails[1]
                                          if isinstance(t, tuple)) > 0


def test_allocator_rejects_misuse():
    for mod in (jpaged, tpaged):
        alloc = mod.PageAllocator(5, 8)
        with pytest.raises(ValueError):
            alloc.ref(mod.SCRATCH_PAGE)
        p = alloc.alloc(reserved=False)
        with pytest.raises(ValueError):
            alloc.drop(p)
        alloc.unref(p)
        with pytest.raises(ValueError):
            alloc.unref(p)
        with pytest.raises(ValueError):
            alloc.hold(p)
        alloc.check()


# -- warm admissions equal cold ones ---------------------------------------

def test_warm_prefix_decode_equals_cold_and_jax(params):
    def script(side):
        sess = side.make().batch_session(max_batch=3, chunk=4, prefill_chunk=5, kv_pages=8)
        assert sess.paged and sess.page == 8
        h1 = sess.admit_begin(LONG, steps=12, sampler=side.greedy(7))
        cold = _drain(sess, {h1: []})[h1]
        book1 = _book(sess)
        sess.release(h1)
        h2 = sess.admit_begin(LONG, steps=12, sampler=side.greedy(7))
        warm = _drain(sess, {h2: []})[h2]
        pages = _pages(sess, [h2])
        book2 = _book(sess)
        sess.close()
        assert warm == cold
        return (h1, h2, cold, book1, book2), pages

    rec = _both(params, script)
    counters = rec[4]["counters"]
    assert counters[:3] == (1, 1, 16) and rec[4]["hit_rate"] == 0.5
    # sampled: the warm stream is the cold one (port's own generator)
    scfg = tsampler.SamplerConfig(temperature=0.9, topp=0.95, seed=7)
    eng = _sides(params)[1].make()
    sess = eng.batch_session(max_batch=3, chunk=4, prefill_chunk=5, kv_pages=8)
    streams = []
    for _ in range(2):
        h = sess.admit_begin(LONG, steps=12, sampler=scfg)
        streams.append(_drain(sess, {h: []})[h])
        sess.release(h)
    sess.close()
    assert streams[1] == streams[0] and sess.prefix_hits == 1


def test_warm_admit_with_resident_row(params):
    def script(side):
        sess = side.make().batch_session(max_batch=3, chunk=4, prefill_chunk=5, kv_pages=8)
        warm = sess.admit_begin(LONG, steps=2)
        _drain(sess, {warm: []})
        sess.release(warm)
        got = {}
        res = sess.admit([5, 9, 3], steps=20, sampler=side.greedy(5))
        got[res] = []
        for b, burst in sess.step_chunk().items():
            got[b].extend(burst)
        new = sess.admit_begin(LONG, steps=10, sampler=side.greedy(23))
        got[new] = []
        assert sess.prefix_hits >= 1
        _drain(sess, got)
        pages = _pages(sess, [res, new])
        book = _book(sess)
        sess.close()
        return (got, book), pages

    rec = _both(params, script)
    assert [len(v) for v in rec[0].values()] == [20, 10]


def test_cow_boundary_block(params):
    prefix = [(i * 5 + 11) % 96 for i in range(16)]
    longer = prefix + [(i * 3 + 2) % 96 for i in range(8)]

    def script(side):
        sess = side.make().batch_session(max_batch=2, chunk=4, prefill_chunk=6, kv_pages=8)
        h1 = sess.admit_begin(longer, steps=6, sampler=side.greedy(1))
        _drain(sess, {h1: []})
        sess.release(h1)
        h2 = sess.admit_begin(prefix, steps=10, sampler=side.greedy(13))
        assert h2 not in sess.pending_prefills
        got = _drain(sess, {h2: []})[h2]
        pages = _pages(sess, [h2])
        book = _book(sess)
        sess.release(h2)
        sess._alloc.check()
        sess.close()
        return (got, book), pages

    rec = _both(params, script)
    assert rec[1]["counters"][3] == 1  # one COW copy
    scfg = tsampler.SamplerConfig(temperature=0.9, topp=0.9, seed=13)
    eng = _sides(params)[1].make()
    sess = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=6, kv_pages=8)
    h1 = sess.admit_begin(longer, steps=6)
    _drain(sess, {h1: []})
    sess.release(h1)
    h2 = sess.admit_begin(prefix, steps=10, sampler=scfg)
    warm = _drain(sess, {h2: []})[h2]
    sess.close()
    assert sess.cow_copies == 1
    assert warm == _cold_stream(params, prefix, 10, scfg)


def test_cancel_mid_prefill_returns_pages(params):
    def script(side):
        sess = side.make().batch_session(max_batch=1, chunk=4, prefill_chunk=4, kv_pages=8)
        h = sess.admit_begin(LONG, steps=40)
        sess.prefill_step()
        full = sess.can_admit(3, 4)
        sess.cancel(h)
        sess.release(h)
        book = _book(sess)
        sess._alloc.check()
        assert len(sess._radix) == 0
        h2 = sess.admit([7], steps=10, sampler=side.greedy(11))
        out = _drain(sess, {h2: []})[h2]
        sess.close()
        return (full, book, h2, out), None

    rec = _both(params, script)
    assert rec[0] is False and rec[1]["reserved"] == 0


def test_eviction_under_pressure(params):
    other = [(i * 11 + 2) % 96 for i in range(23)]

    def script(side):
        sess = side.make().batch_session(max_batch=1, chunk=4, prefill_chunk=8, kv_pages=8)
        outs = []
        for prompt, steps in ((LONG, 8), (other, 30), (LONG, 8)):
            h = sess.admit_begin(prompt, steps=steps, sampler=side.greedy(3))
            outs.append(_drain(sess, {h: []})[h])
            outs.append(_book(sess))
            sess.release(h)
            sess._alloc.check()
        sess.close()
        return outs, None

    rec = _both(params, script)
    assert rec[0] == rec[4] and rec[3]["counters"][4] > 0  # evicted, then re-served


def test_admit_copy_call_counts(params):
    """One gather per warm admission, one scatter per prefill piece (+ the
    partial tail), as the reference dispatches them."""
    prompt = [(i * 13 + 5) % 96 for i in range(60)]

    def script(side):
        eng = side.make()
        calls = {"gather": 0, "scatter": 0}
        g0, s0 = eng._pages_to_single, eng._single_to_pages

        def gather(*a, **k):
            calls["gather"] += 1
            return g0(*a, **k)

        def scatter(*a, **k):
            calls["scatter"] += 1
            return s0(*a, **k)

        eng._pages_to_single, eng._single_to_pages = gather, scatter
        sess = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=16, kv_pages=8)
        h1 = sess.admit_begin(prompt, steps=4, sampler=side.greedy(4))
        cold = _drain(sess, {h1: []})[h1]
        first = dict(calls)
        sess.release(h1)
        calls["gather"] = calls["scatter"] = 0
        h2 = sess.admit_begin(prompt, steps=4, sampler=side.greedy(4))
        warm = _drain(sess, {h2: []})[h2]
        pages = _pages(sess, [h2])
        book = _book(sess)
        sess.close()
        assert warm == cold
        return (first, dict(calls), cold, book), pages

    rec = _both(params, script)
    assert rec[0] == {"gather": 0, "scatter": 5} and rec[1] == {"gather": 1, "scatter": 1}
    assert rec[3]["counters"][2] == 56


def test_publish_at_admit_shares_pages_between_live_rows(params):
    prompt = [(i * 13 + 5) % 96 for i in range(33)]

    def script(side):
        sess = side.make().batch_session(max_batch=2, chunk=4, prefill_chunk=8, kv_pages=8)
        ha = sess.admit_begin(prompt, steps=6, sampler=side.greedy(5))
        published = (len(sess._radix), len(sess._radix.match(prompt)))
        sess.prefill_step(ha)
        ready = len(sess._radix.match(prompt))
        hb = sess.admit_begin(prompt, steps=6, sampler=side.greedy(9))
        assert sess._slots[ha].prefilling
        shared = sess._rowpages[hb].blocks[:ready]
        assert shared == sess._rowpages[ha].blocks[:ready]
        refs = [sess._alloc.refcount(p) for p in shared]
        out = _drain(sess, {ha: [], hb: []})
        pages = _pages(sess, [ha, hb])
        book = _book(sess)
        sess.release(ha)
        sess.release(hb)
        sess._alloc.check()
        cached = [(sess._alloc.refcount(p), sess._alloc.is_cached(p)) for p in shared]
        sess.close()
        return (published, ready, refs, out, book, cached), pages

    rec = _both(params, script)
    assert rec[0] == (4, 0) and rec[1] >= 1 and set(rec[2]) == {2}
    assert rec[3][0] == rec[3][1] and set(rec[5]) == {(0, True)}


# -- capacity and introspection --------------------------------------------

def test_paged_pool_admits_at_least_bucketed_rows(params):
    def script(side):
        eng = side.make()

        def admit_until_full(sess):
            n = 0
            while sess.can_admit(3, 4, [5, 9, 3]):
                sess.admit([5, 9, 3], steps=4)
                n += 1
            return n

        sessions = (eng.batch_session(max_batch=2, chunk=4),
                    eng.batch_session(max_batch=2, chunk=4, bucket_kv=True, min_bucket=8),
                    eng.batch_session(max_batch=2, chunk=4, kv_pages=8))
        counts = [admit_until_full(s) for s in sessions]
        book = _book(sessions[2])
        free = [len(s.free_slots) for s in sessions]
        for s in sessions:
            s.close()
        return (counts, book, free), None

    rec = _both(params, script)
    n_uni, n_bkt, n_pgd = rec[0]
    assert n_pgd >= n_bkt > n_uni and rec[1]["counters"][6] == 0
    st = rec[1]["stats"]
    assert st["pages_free"] + st["pages_held"] == st["pages_total"]


def test_page_stats_and_hit_rate_surface(params):
    def script(side):
        sess = side.make().batch_session(max_batch=2, chunk=4, prefill_chunk=8, kv_pages=8)
        h = sess.admit_begin(LONG, steps=4)
        _drain(sess, {h: []})
        sess.release(h)
        book = _book(sess)
        sess.close()
        return (book, sess.page_stats()), None

    book, closed = _both(params, script)
    s = book["stats"]
    assert s["page_tokens"] == 8 and s["radix_nodes"] == 2 and s["pages_cached"] == 2
    assert s["pages_held"] == 0 and s["prefix_misses"] == 1 and book["hit_rate"] == 0.0
    # nothing leaked at close
    assert closed["pages_free"] == closed["pages_total"] and closed["pages_cached"] == 0


# -- fault seams -----------------------------------------------------------

def test_prefix_match_fault_leaves_pool_clean(params):
    def script(side):
        sess = side.make().batch_session(max_batch=1, chunk=4, prefill_chunk=8, kv_pages=8)
        side.faults.install("prefix_match:raise:times=1")
        with pytest.raises(side.faults.FaultInjected):
            sess.admit_begin(LONG, steps=4)
        side.faults.clear()
        book = _book(sess)
        sess._alloc.check()
        h = sess.admit_begin(LONG, steps=4, sampler=side.greedy(1))
        out = _drain(sess, {h: []})[h]
        sess.close()
        return (book, h, out), None

    rec = _both(params, script)
    assert rec[0]["reserved"] == 0 and len(rec[2]) == 4


def test_page_alloc_fault_is_resumable(params):
    def script(side):
        sess = side.make().batch_session(max_batch=1, chunk=4, prefill_chunk=8, kv_pages=8)
        h = sess.admit_begin(LONG, steps=6, sampler=side.greedy(2))
        side.faults.install("page_alloc:raise:times=1")
        with pytest.raises(side.faults.FaultInjected):
            _drain(sess, {h: []})
        side.faults.clear()
        sess._alloc.check()
        out = _drain(sess, {h: []})[h]
        book = _book(sess)
        sess.close()
        return (out, book), None

    rec = _both(params, script)
    assert len(rec[0]) == 6


# -- the paged step's warm-up ----------------------------------------------

def test_paged_warmup_touches_only_the_scratch_page(params):
    """A paged graph is warmed up and captured with an all-scratch table
    and every row at its window's last slot: that step (the graph's body,
    which the CPU runs eagerly) writes page 0 and no other page, and a
    later load's table is what the next run reads."""
    eng = _sides(params)[1].make()
    sess = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=8, kv_pages=8)
    h = sess.admit(LONG, steps=12, sampler=tsampler.SamplerConfig(temperature=0.0))
    sess.step_chunk()
    before = {n: sess._arena[n].clone() for n in ("k", "v")}
    g = tgen.StepGraph(eng._paged_step, sess._arena, 4 * 8, True, 4, batch=2,
                       table_blocks=4)
    assert int(g.table.abs().sum()) == 0 and set(g.pos.tolist()) == {31}
    g._body(sess._arena)  # what the capture's warm-up runs
    for n in ("k", "v"):
        assert torch.equal(sess._arena[n][:, 1:], before[n][:, 1:])
        assert not torch.equal(sess._arena[n][:, 0], before[n][:, 0])
    grp, r = sess._where[h]
    g.load(torch.zeros(2, dtype=torch.long), torch.tensor([20, 31], dtype=torch.int32),
           table=grp.tables[[r, r]])
    assert g.table[0].tolist() == grp.tables[r].tolist()
    sess.close()
