"""Row migration in the port's paged ``BatchSession`` (``export_row`` and
``admit_from_export``) through ``serving.kv_transfer``'s wire, against the
JAX package's, mirroring ``tests/test_kv_transfer.py``'s migration and
fault-seam tests (CPU, float32, the same random params through
``from_jax_params``).

A sampled row carries its generator's state in the snapshot's ``keys``
(the words of ``torch.Generator.get_state()``; ``[]`` for a greedy row), so
the migrated stream continues from the exact draw the row would have made:
over the f32 wire the chunk before the export plus the importer's stream
equal, bit for bit, the row kept in the exporting session, greedy and
sampled. Greedy streams and the snapshot's scalars equal the JAX
package's, and a greedy snapshot the JAX package exported continues in the
port as in JAX. A sampled snapshot whose ``keys`` are not a state of the
importing device's generator (the JAX package's two-word keys) is refused
with a ValueError that says why.
"""

import jax
import numpy as np
import pytest

from dllama_tpu import faults as jfaults
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu.serving import kv_transfer as jkv
from dllama_tpu_torch import faults as tfaults
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.serving import kv_transfer as tkv

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
LONG = [(i * 7 + 3) % 96 for i in range(23)]
SCALARS = ("page_tokens", "n_blocks", "plen", "pos", "token", "room", "budget", "offered",
           "emitted", "stop_tokens", "temp", "topp")


@pytest.fixture(scope="module")
def params():
    jp = jl.random_params(JConfig(**SHAPE), seed=31, dtype=np.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TConfig(**SHAPE), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _jeng(params):
    return jgen.Engine(JConfig(**SHAPE), params[0], jsampler.SamplerConfig(temperature=0.0),
                       metrics=None)


def _teng(params):
    return tgen.Engine(TConfig(**SHAPE), params[1], tsampler.SamplerConfig(temperature=0.0),
                       device="cpu", metrics=None)


def _drain(sess, out):
    while any(not sess.is_done(b) for b in out):
        sess.prefill_step()
        for b, burst in sess.step_chunk().items():
            if b in out:
                out[b].extend(burst)
    return out


def _first_chunks(sess, h, n=1):
    """Run the row's admission and ``n`` decode chunks; its tokens."""
    got = []
    while h in sess.pending_prefills:
        sess.prefill_step()
    for _ in range(n):
        got.extend(sess.step_chunk().get(h, []))
    return got


def _migrate(make, prompt, steps, scfg, mode="f32", kw=None):
    """(exported snapshot, tokens before the export, the importer's tokens,
    the stream of the row kept in the exporting session)."""
    kw = kw or dict(max_batch=3, chunk=4, prefill_chunk=5, kv_pages=8)
    sess_a = make().batch_session(**kw)
    h = sess_a.admit_begin(prompt, steps=steps, sampler=scfg)
    first = _first_chunks(sess_a, h, 2)
    snap = sess_a.export_row(h)
    kept = first + _drain(sess_a, {h: []})[h]
    sess_a.close()
    mod = tkv if isinstance(scfg, tsampler.SamplerConfig) else jkv
    got = mod.decode_snapshot(mod.encode_snapshot(snap, prompt, mode=mode))
    sess_b = make().batch_session(**kw)
    h2 = sess_b.admit_from_export(got["prompt"], got)
    rest = _drain(sess_b, {h2: []})[h2]
    sess_b.release(h2)
    sess_b._alloc.check()
    sess_b.close()
    return snap, got, first, rest, kept


@pytest.mark.parametrize("sampled", [False, True])
def test_migration_bit_identical_over_f32_wire(params, sampled):
    # top-p 0.5: a float both packages store exactly (JAX keeps float32)
    scfg = tsampler.SamplerConfig(temperature=0.9 if sampled else 0.0, topp=0.5, seed=7)
    snap, got, first, rest, kept = _migrate(lambda: _teng(params), LONG, 14, scfg)
    assert first + rest == kept and len(kept) == 14
    assert (len(snap["keys"]) > 0) == sampled and got["keys"] == snap["keys"]
    for a, b in zip(snap["leaves"], got["leaves"]):  # the f32 wire is exact
        ntok = snap["pos"]
        flat_a = a.reshape(a.shape[0], -1, *a.shape[3:])[:, :ntok]
        flat_b = b.reshape(b.shape[0], -1, *b.shape[3:])[:, :ntok]
        assert np.array_equal(flat_a, flat_b)
    if not sampled:  # the JAX package migrates the same row to the same tokens
        jsnap, _, jfirst, jrest, _ = _migrate(
            lambda: _jeng(params), LONG, 14,
            jsampler.SamplerConfig(temperature=0.0, topp=0.5, seed=7))
        assert jfirst + jrest == first + rest
        assert {k: snap[k] for k in SCALARS} == {k: jsnap[k] for k in SCALARS}
        for a, b in zip(snap["leaves"], jsnap["leaves"]):
            n = snap["pos"]
            a = a.reshape(a.shape[0], -1, *a.shape[3:])[:, :n]
            b = np.asarray(b).reshape(b.shape[0], -1, *b.shape[3:])[:, :n]
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_migration_over_q80_wire_error_bounded(params):
    """The lossy wire carries a servable row: the sampler state and
    accounting are exact, every page is within ``q80_error_bound`` of the
    exporter's off the wire and as imported, and the row finishes with
    exactly its remaining budget."""
    scfg = tsampler.SamplerConfig(temperature=0.9, topp=0.95, seed=7)
    kw = dict(max_batch=2, chunk=4, kv_pages=8)
    eng = _teng(params)
    sess_a = eng.batch_session(**kw)
    h = sess_a.admit_begin(LONG, steps=12, sampler=scfg)
    first = _first_chunks(sess_a, h)
    snap = sess_a.export_row(h)
    sess_a.close()
    got = tkv.decode_snapshot(tkv.encode_snapshot(snap, LONG, mode="q80"))
    assert got["keys"] == snap["keys"] and got["temp"] == snap["temp"]
    page = snap["page_tokens"]

    def hold(leaves, where):
        for want_l, have_l in zip(snap["leaves"], leaves):
            for b in range(snap["n_blocks"]):
                ntok = max(0, min(snap["pos"] - b * page, page))
                if ntok:
                    w = want_l[:, b, :ntok]
                    err = float(np.abs(np.asarray(have_l)[:, b, :ntok] - w).max())
                    assert err <= tkv.q80_error_bound(w), (where, b)

    hold(got["leaves"], "wire")
    sess_b = _teng(params).batch_session(**kw)
    h2 = sess_b.admit_from_export(got["prompt"], got)
    hold(sess_b.export_row(h2, fire_fault=False)["leaves"], "imported")
    rest = _drain(sess_b, {h2: []})[h2]
    sess_b.close()
    assert len(first) + len(rest) == 12


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_kv_export_and_kv_import_fault_sites_raise(params, side):
    eng, faults = ((_jeng(params), jfaults) if side == "jax" else (_teng(params), tfaults))
    sess = eng.batch_session(max_batch=2, chunk=4, kv_pages=8)
    prompt = LONG[:9]
    h = sess.admit(prompt, steps=8)
    sess.step_chunk()
    faults.install("kv_export:raise:times=1")
    with pytest.raises(faults.FaultInjected):
        sess.export_row(h)
    faults.clear()
    snap = sess.export_row(h)
    faults.install("kv_import:raise:times=1")
    with pytest.raises(faults.FaultInjected):
        sess.admit_from_export(list(prompt), snap)
    faults.clear()
    stats = sess.page_stats()
    sess.release(h)
    sess._alloc.check()
    sess.close()
    assert stats["pages_held"] > 0


def test_jax_snapshot_imports_greedy_and_refuses_sampled(params):
    """A greedy row the JAX package exported continues in the port as it
    does in JAX (the two-word key is not read for a greedy row). A sampled
    one is refused: the port cannot draw what a JAX key chain would, and
    never reseeds silently; nothing is reserved by the refusal."""
    kw = dict(max_batch=2, chunk=4, kv_pages=8)
    out = {}
    for temp in (0.0, 0.9):
        sess = _jeng(params).batch_session(**kw)
        h = sess.admit(LONG, steps=12,
                       sampler=jsampler.SamplerConfig(temperature=temp, topp=0.9, seed=3))
        _first_chunks(sess, h)
        snap = jkv.decode_snapshot(jkv.encode_snapshot(sess.export_row(h), LONG))
        out[temp] = (snap, _drain(sess, {h: []})[h])
        sess.close()
    snap, jrest = out[0.0]
    sess = _teng(params).batch_session(**kw)
    h = sess.admit_from_export(snap["prompt"], snap)
    assert _drain(sess, {h: []})[h] == jrest
    sess.release(h)
    snap = out[0.9][0]
    assert len(snap["keys"]) == 2
    with pytest.raises(ValueError, match="sampler state"):
        sess.admit_from_export(snap["prompt"], snap)
    assert sess.reserved_tokens == 0 and sess.occupied == []
    sess._alloc.check()
    sess.close()


def test_export_needs_a_live_paged_row(params):
    eng = _teng(params)
    slab = eng.batch_session(max_batch=2, chunk=4, bucket_kv=True)
    h = slab.admit(LONG[:5], steps=4)
    with pytest.raises(RuntimeError, match="paged"):
        slab.export_row(h)
    slab.close()
    sess = eng.batch_session(max_batch=2, chunk=4, prefill_chunk=4, kv_pages=8)
    h = sess.admit_begin(LONG, steps=4)
    with pytest.raises(RuntimeError, match="prefilling"):
        sess.export_row(h)
    _drain(sess, {h: []})
    with pytest.raises(RuntimeError, match="finished"):
        sess.export_row(h)
    sess.close()
