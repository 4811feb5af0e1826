"""The port's fault seams and engine telemetry against the JAX package's
(CPU, float32, the same random params through ``from_jax_params``).

* One call sequence over every engine path (solo ``generate``,
  ``generate_fused``, chunked ``prefill``, ``generate_batch``, the
  speculative paths and a ``BatchSession`` with monolithic and chunked
  admission) fires every Engine seam (``prefill``, ``prefill_chunk``,
  ``admit``, ``step_chunk``, ``logits``) as often as the JAX Engine does,
  and leaves the same counts in every engine metric.
* ``weights_open`` and ``weights_read`` raise what the reference's raise.
* ``logits:nan`` fails a solo decode, flags the same ``generate_batch`` row
  and quarantines the same ``BatchSession`` row, whose neighbours go on to
  emit the JAX session's tokens.
"""

import jax
import numpy as np
import pytest

from dllama_tpu import faults as jfaults
from dllama_tpu import observability as jobs
from dllama_tpu.formats.spec import ArchType, FormatError as JFormatError, ModelSpec
from dllama_tpu.formats.weights import ChecksumError as JChecksumError
from dllama_tpu.formats.weights import WeightFileReader as JReader
from dllama_tpu.formats.weights import tensor_plan, write_model
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.quants import blocks
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import faults as tfaults
from dllama_tpu_torch import observability as tobs
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.formats.spec import FormatError as TFormatError
from dllama_tpu_torch.formats.weights import ChecksumError as TChecksumError
from dllama_tpu_torch.formats.weights import WeightFileReader as TReader
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=16, kv_dim=32, dtype="float32")
SEAMS = ("prefill", "prefill_chunk", "admit", "step_chunk", "logits")
#: the engine's metrics: histograms, then counters
HISTOGRAMS = ("dllama_prefill_ms", "dllama_decode_step_ms", "dllama_decode_chunk_ms",
              "dllama_prefill_chunk_ms")
COUNTERS = ("dllama_kv_migrations_total", "dllama_numeric_quarantines_total",
            "dllama_spec_verify_steps_total", "dllama_spec_drafts_accepted_total",
            "dllama_spec_tokens_emitted_total", "dllama_prefix_cache_hits_total",
            "dllama_prefix_cache_misses_total", "dllama_prefix_tokens_matched_total",
            "dllama_kv_cow_copies_total", "dllama_prefix_evictions_total",
            "dllama_tp_overlap_chunks_total", "dllama_tp_reduce_chunks_total")
LONG = [(i * 7 + 3) % 96 for i in range(23)]
REPEAT = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7]


@pytest.fixture(scope="module")
def params():
    jp = jl.random_params(JConfig(**SHAPE), seed=5, dtype=np.float32)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TConfig(**SHAPE), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _engines(params, registries=(None, None), chunk=4):
    jp, tp = params
    je = jgen.Engine(JConfig(**SHAPE), jp, jsampler.SamplerConfig(temperature=0.0),
                     decode_chunk=chunk, metrics=registries[0])
    te = tgen.Engine(TConfig(**SHAPE), tp, tsampler.SamplerConfig(temperature=0.0),
                     device="cpu", decode_chunk=chunk, metrics=registries[1])
    return je, te


def _drive(eng, scfg):
    """The same calls on either package's engine; returns what they emit."""
    out = [[t for t, _ in eng.generate([3, 9, 4], 5)]]
    out.append(eng.generate_fused([7, 1, 2, 8], 6)[0])
    eng.prefill(eng.new_cache(), LONG, chunk=5)
    out.append(eng.generate_batch([[5, 9, 3], [7], [1, 2, 3, 4, 5, 6]], 5))
    out.append([t for t, _ in eng.generate_spec(REPEAT, 6, draft_len=4)])
    out.append(eng.generate_batch_spec([REPEAT, [9, 8, 7]], 5, draft_len=3)[0])
    sess = eng.batch_session(max_batch=3, chunk=4, prefill_chunk=6)
    a = sess.admit([5, 9, 3], steps=7, sampler=scfg(temperature=0.0, seed=1))
    b = sess.admit_begin(LONG, steps=6, sampler=scfg(temperature=0.0, seed=2))
    c = sess.admit([4], steps=3, sampler=scfg(temperature=0.0, seed=3))
    got = {a: [], b: [], c: []}
    while any(not sess.is_done(h) for h in got):
        sess.prefill_step()
        for h, burst in sess.step_chunk().items():
            got[h].extend(burst)
    sess.close()
    out.append([got[a], got[b], got[c]])
    return out


def _metric_counts(reg):
    return ({n: reg.histogram(n).total_count() for n in HISTOGRAMS},
            {n: reg.counter(n).total() for n in COUNTERS})


def test_every_seam_fires_and_every_metric_counts_as_in_jax(params):
    spec = ";".join(f"{s}:slow:delay_ms=0" for s in SEAMS)
    regs = (jobs.MetricsRegistry(), tobs.MetricsRegistry())
    je, te = _engines(params, regs)
    jplan = jfaults.install(spec)
    want = _drive(je, jsampler.SamplerConfig)
    tplan = tfaults.install(spec)
    got = _drive(te, tsampler.SamplerConfig)
    assert got == want
    assert tplan.counters() == jplan.counters()
    assert all(calls > 0 for calls, _ in tplan.counters().values())
    assert _metric_counts(regs[1]) == _metric_counts(regs[0])
    # every engine metric the reference registers is registered
    names = {line.split()[2] for line in regs[1].render().splitlines()
             if line.startswith("# TYPE")}
    assert set(HISTOGRAMS + COUNTERS) <= names


def test_metrics_none_disables_engine_telemetry(params):
    _, te = _engines(params)
    assert te.metrics is None and te._m_prefill is None
    assert [t for t, _ in te.generate([3, 9, 4], 3)]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("seams") / "m.m"
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=1, n_heads=4,
                     n_kv_heads=2, vocab_size=64, seq_len=32, weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    write_model(str(path), spec, {e.name: 0.05 * rng.standard_normal(e.d * e.n).astype(
        np.float32) for e in tensor_plan(spec)})
    return str(path)


@pytest.mark.parametrize("spec,errors", [
    ("weights_open:raise", (jfaults.FaultInjected, tfaults.FaultInjected)),
    ("weights_open:truncate:drop=100", (JFormatError, TFormatError)),
    ("weights_read:bitflip:byte=3", (JChecksumError, TChecksumError)),
])
def test_weight_seams_raise_as_the_reference(model_file, spec, errors):
    messages = []
    for reader, faults, err in zip((JReader, TReader), (jfaults, tfaults), errors):
        faults.install(spec)
        with pytest.raises(err) as info:
            with reader(model_file) as r:
                r.read_tensor(r.entries[0].name)
        faults.clear()
        messages.append(str(info.value))
        with reader(model_file) as r:  # the same file reads clean without the plan
            r.read_tensor(r.entries[0].name)
    assert messages[1] == messages[0]


def test_logits_nan_fails_solo_and_poisons_the_same_batch_row(params):
    je, te = _engines(params)
    for eng, faults, err in ((je, jfaults, jgen.NumericHealthError),
                             (te, tfaults, tgen.NumericHealthError)):
        faults.install("logits:nan:times=1")
        with pytest.raises(err):
            list(eng.generate([3, 9, 4], 4))
        faults.install("logits:nan:row=1,times=1")
        eng.generate_batch([[5, 9, 3], [7, 2], [1, 2, 3]], 4)
        faults.clear()
    assert te.row_health == je.row_health == [True, False, True]


def test_logits_nan_quarantines_the_same_session_row(params):
    out = []
    for eng, faults, scfg in zip(_engines(params), (jfaults, tfaults),
                                 (jsampler.SamplerConfig, tsampler.SamplerConfig)):
        sess = eng.batch_session(max_batch=3, chunk=4)
        rows = [sess.admit(p, steps=10, sampler=scfg(temperature=0.0, seed=i))
                for i, p in enumerate([[5, 9, 3], [7], [1, 2, 3, 4]])]
        faults.install("logits:nan:row=2,after=1,times=1")  # the second chunk
        got = {r: [] for r in rows}
        while any(not sess.is_done(r) for r in rows):
            for r, burst in sess.step_chunk().items():
                got[r] += burst
        faults.clear()
        out.append(([got[r] for r in rows], [sess.finish_reason(r) for r in rows]))
        sess.close()
    assert out[1] == out[0]
    assert out[1][1] == ["length", "length", "error"] and len(out[1][0][2]) == 4
