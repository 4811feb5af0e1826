"""Prompt-lookup speculative decoding in the port (``Engine.generate_spec``,
``_NgramIndex``, ``Engine.generate(sampler=...)``, ``cli --spec-draft``)
against the JAX package's and the port's own plain decode (CPU), mirroring
``tests/test_spec_decode.py`` without its MoE cases.

* ``_NgramIndex`` drafts what the JAX package's drafts, the repeated-token
  fallback included.
* Greedy spec streams equal the port's plain ``generate`` and JAX's
  ``generate_spec``, dense f32, Q40 and Q80, 1-token and multi-token
  prompts. A verify step sums its T rows in another order than T plain
  steps do, so its logits are held to plain decode's within 1e-5 of their
  magnitude, and the tokens to equality.
* Sampled spec streams equal the port's plain sampled stream with the same
  SamplerConfig, and leave the generator where plain decode leaves it, a
  stop token in the middle of a verify step included; greedy spec draws
  nothing, as greedy plain decode draws nothing.
* A verify step feeds the pending token and its draft, no padding; the
  accept rule; ``verify_sampled`` picks what ``sample_dynamic`` picks with
  the same seed, and its noted states replay the draws.
* Session resume, ``history``, first-token stats, garbage past the prefix
  never attended, and the CLI's ``--spec-draft`` printing the plain run's
  token ids.
"""

import builtins

import jax
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import cli
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime.sampler import SamplerConfig

SHAPE = dict(arch="llama", dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
             vocab_size=64, seq_len=128, head_size=16, kv_dim=64, dtype="float32")
TC = TConfig(**SHAPE)
GREEDY = SamplerConfig(temperature=0.0, seed=1)


def _params(quant=None, seed=0):
    """(JAX params, the port's copy of them)."""
    jp = jl.random_params(JConfig(**SHAPE), seed=seed, dtype=np.float32)
    if quant:
        jp = jl.quantize_params(jp, quant)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), TC, "cpu")


@pytest.fixture(scope="module")
def dense():
    return _params()[1]


def _engine(tp, scfg=GREEDY):
    return tgen.Engine(TC, tp, scfg, device="cpu")


def _toks(stream) -> list:
    return [t for t, _ in stream]


def test_ngram_index_draft_lookup():
    idx = tgen._NgramIndex(3)
    idx.extend([1, 2, 3, 9, 9, 1, 2])
    assert idx.draft(3, 2) == [9, 9]  # [1, 2] + pending 3 matched at position 0
    assert idx.draft(7, 2) == []  # no earlier [2, 7]
    assert idx.draft(3, 0) == []
    fresh = tgen._NgramIndex(3)
    fresh.extend([1, 2])
    assert fresh.draft(3, 2) == []  # no earlier occurrence yet
    idx.extend([3, 5, 1, 2])
    assert idx.draft(3, 2) == [5, 1]  # the latest [1, 2, 3] now


def test_ngram_index_repeated_token_runs_still_draft():
    """The latest [5, 5, 5] ends flush at the context's end (an empty
    continuation): the index falls back to the occurrence before it."""
    idx = tgen._NgramIndex(3)
    idx.extend([5, 5, 5, 5])
    assert idx.draft(5, 4) == [5]
    idx.extend([5, 5])
    assert idx.draft(5, 3) == [5]


def test_ngram_index_drafts_what_jax_drafts():
    rng = np.random.default_rng(3)
    for n in (2, 3, 4):
        ours, theirs = tgen._NgramIndex(n), jgen._NgramIndex(n)
        for _ in range(40):
            chunk = rng.integers(0, 6, int(rng.integers(1, 4))).tolist()
            ours.extend(chunk)
            theirs.extend(chunk)
            pending, k = int(rng.integers(0, 6)), int(rng.integers(0, 6))
            assert ours.draft(pending, k) == theirs.draft(pending, k)


@pytest.mark.parametrize("quant,steps", [(None, 40), ("q40", 24), ("q80", 24)])
def test_greedy_spec_equals_plain_and_jax(quant, steps):
    jp, tp = _params(quant)
    jeng = jgen.Engine(JConfig(**SHAPE), jp, jsampler.SamplerConfig(temperature=0.0, seed=1),
                       metrics=None)
    eng = _engine(tp)
    for prompt in ([1, 5, 9], [7]):
        plain = _toks(eng.generate(prompt, steps))
        spec = _toks(eng.generate_spec(prompt, steps))
        want = _toks(jeng.generate_spec(prompt, steps))
        assert len(want) == steps and spec == plain == want, (quant, prompt)


def test_verify_logits_agree_with_plain_steps(dense):
    """One verify step of 9 rows against 9 plain one-token steps on the same
    cache: the same function summed in another order, within 1e-5 of the
    logits' magnitude (f32)."""
    rope = tl.rope_tables(TC, "cpu")
    eng = _engine(dense)
    _, cache = eng.prefill(eng.new_cache(), [1, 5, 9, 2, 4])
    feed = torch.tensor([3, 8, 13, 21, 34, 55, 2, 7, 1])
    plain = {n: c.clone() for n, c in cache.items()}
    got, _ = tl.forward(TC, eng.params, rope, feed, cache, 5)
    want = torch.cat([tl.forward(TC, eng.params, rope, feed[i:i + 1], plain, 5 + i)[0]
                      for i in range(9)])
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("temp,topp", [(0.7, 1.0), (1.0, 0.9)])
def test_sampled_spec_equals_plain_sampled(dense, temp, topp):
    scfg = SamplerConfig(temperature=temp, topp=topp, seed=123)
    for prompt in ([1, 5, 9], [7]):
        want = _toks(_engine(dense).generate(prompt, 32, sampler=scfg))
        got = _toks(_engine(dense).generate_spec(prompt, 32, sampler=scfg))
        assert len(want) == 32 and got == want, prompt


def test_spec_accepts_multi_token_steps(dense):
    """Random tiny models fall into repeating tokens under greedy decode:
    the drafts then accept, so there are fewer verify steps than tokens."""
    toks, steps = [], 0
    for t, s in _engine(dense).generate_spec([1, 5, 9], 40):
        toks.append(t)
        steps += s.generation_ms > 0.0  # the first token of each step
    assert len(toks) == 40 and len(set(toks[-16:])) < 8
    assert steps < len(toks)


def test_spec_session_resume_matches_uninterrupted(dense):
    eng = _engine(dense)
    part1 = _toks(eng.generate_spec([1, 5, 9], 10))
    part2 = _toks(eng.generate_spec([], 10, session=eng.final_session))
    assert part1 + part2 == _toks(_engine(dense).generate_spec([1, 5, 9], 20))


def test_spec_resume_with_history_stays_exact(dense):
    eng = _engine(dense)
    part1 = _toks(eng.generate_spec([1, 5, 9], 10))
    consumed = [1, 5, 9] + part1[:-1]  # the pending part1[-1] is not in the cache yet
    part2 = _toks(eng.generate_spec([], 10, session=eng.final_session, history=consumed))
    assert part1 + part2 == _toks(_engine(dense).generate_spec([1, 5, 9], 20))


def _steps(stream) -> list:
    """The tokens of a spec stream grouped by the step that emitted them
    (a step's time goes to its first token)."""
    groups = []
    for t, s in stream:
        if s.generation_ms > 0.0 or not groups:
            groups.append([])
        groups[-1].append(t)
    return groups


def _stop_mid_step(groups) -> tuple:
    """(stop token, its index) of the first token that is new to the stream
    and not the last of its step: a stop there truncates an accepted step."""
    seen = []
    for g in groups:
        for j, t in enumerate(g):
            if j < len(g) - 1 and t not in seen:
                return t, len(seen)
            seen.append(t)
    raise AssertionError(f"no multi-token step with a new token: {groups}")


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_stop_mid_step_then_plain_decode_continues_as_plain(dense, temp):
    """Drafting from an earlier copy of the stream (``history``) makes whole
    steps accept; a stop token inside one ends the stream there, and the
    session and the generator are left where plain decode leaves them: a
    plain generate afterwards continues as on an engine that never
    speculated."""
    scfg = SamplerConfig(temperature=temp, seed=9)
    want = _toks(_engine(dense, scfg).generate([1, 5, 9], 24))
    hist = [1, 5, 9] + want
    groups = _steps(_engine(dense, scfg).generate_spec([1, 5, 9], 24, history=hist))
    assert [t for g in groups for t in g] == want and len(groups) < 12
    stop, at = _stop_mid_step(groups)
    e_plain, e_spec = _engine(dense, scfg), _engine(dense, scfg)
    a1 = _toks(e_plain.generate([1, 5, 9], 24, stop_tokens=(stop,)))
    b1 = _toks(e_spec.generate_spec([1, 5, 9], 24, stop_tokens=(stop,), history=hist))
    assert a1 == b1 == want[:at + 1]
    assert e_spec.final_session.pos == e_plain.final_session.pos
    assert torch.equal(e_plain.generator.get_state(), e_spec.generator.get_state())
    a2 = _toks(e_plain.generate([], 6, session=e_plain.final_session))
    b2 = _toks(e_spec.generate([], 6, session=e_spec.final_session))
    assert a2 == b2 == want[at + 1:at + 7]


def test_greedy_spec_draws_nothing(dense):
    eng = _engine(dense)
    before = eng.generator.get_state()
    n = len(_toks(eng.generate_spec([1, 5, 9], 10)))
    m = len(_toks(eng.generate([1, 5, 9], 10)))
    assert n == m == 10 and torch.equal(eng.generator.get_state(), before)


def test_spec_first_token_stats_report_prefill(dense):
    eng = _engine(dense)
    stats = [s for _, s in eng.generate_spec([1, 5, 9], 4)]
    assert stats[0].generation_ms == eng.prefill_ms > 0.0
    assert stats[0].inference_ms == eng.prefill_ms


def test_generate_sampler_override(dense):
    """``sampler=`` runs this call with its settings and a fresh generator
    from its seed, as an engine made with that config would; the engine's
    own generator does not move."""
    scfg = SamplerConfig(temperature=0.9, topp=0.8, seed=5)
    eng = _engine(dense)
    before = eng.generator.get_state()
    got = _toks(eng.generate([1, 5, 9], 16, sampler=scfg))
    assert got == _toks(_engine(dense, scfg).generate([1, 5, 9], 16))
    assert torch.equal(eng.generator.get_state(), before)
    assert _toks(eng.generate([1, 5, 9], 16)) == _toks(_engine(dense).generate([1, 5, 9], 16))


def test_spec_never_attends_garbage_past_the_prefix(dense):
    """Rejected draft rows leave K/V past the accepted prefix;
    a verify step writes its rows before it attends them. With NaN in every
    slot past the session's position, the stream is unchanged."""
    eng = _engine(dense)
    want = _toks(eng.generate_spec([1, 5, 9], 12))
    part = _toks(eng.generate_spec([1, 5, 9], 3))
    sess = eng.final_session
    for c in sess.cache.values():
        c[:, sess.pos:] = float("nan")
    assert part + _toks(eng.generate_spec([], 9, session=sess)) == want


def test_verify_feeds_one_row_past_the_draft(dense, monkeypatch):
    """A verify step feeds the pending token and its draft, T = len(draft) +
    1, not draft_len + 1: a step with no draft is plain decode's T = 1
    step."""
    drafted, steps = [], []
    draft, fwd = tgen._NgramIndex.draft, tl.forward

    def rec_draft(self, pending, k):
        drafted.append(draft(self, pending, k))
        return drafted[-1]

    def rec_fwd(cfg, params, rope, tokens, cache, pos, *a, **kw):
        steps.append((tokens.shape[0], [len(d) for d in drafted]))
        drafted.clear()
        return fwd(cfg, params, rope, tokens, cache, pos, *a, **kw)

    monkeypatch.setattr(tgen._NgramIndex, "draft", rec_draft)
    monkeypatch.setattr(tl, "forward", rec_fwd)
    toks = _toks(_engine(dense).generate_spec([1, 5, 9], 40, draft_len=8))
    verify = steps[1:]  # after the prefill's bucketed forward
    assert len(toks) == 40 and all(len(lens) == 1 for _, lens in verify)
    assert [T for T, _ in verify] == [1 + lens[0] for _, lens in verify]
    assert {T for T, _ in verify} > {1}


@pytest.mark.parametrize("draft,picks,room,stop,want", [
    ([4, 5, 6], [4, 5, 7, 8], 9, (), (2, [4, 5, 7])),  # two matched, then the model's pick
    ([4, 5, 6], [4, 5, 6, 8], 9, (), (3, [4, 5, 6, 8])),  # all matched: one bonus token
    ([4, 5, 6], [3, 5, 6, 8], 9, (), (0, [3])),  # the first draft rejected
    ([4, 5, 6], [4, 5, 6, 8], 2, (), (3, [4, 5])),  # capped at the room left
    ([4, 5, 6], [4, 5, 6, 8], 9, (5,), (3, [4, 5])),  # cut after a stop token
    ([], [7], 9, (7,), (0, [7])),
])
def test_accept_rule(draft, picks, room, stop, want):
    assert tgen.accept(draft, picks, room, stop) == want


@pytest.mark.parametrize("temp,topp", [(0.8, 0.9), (1.0, 1.0)])
def test_verify_sampled_replays_plain_draws(temp, topp):
    """Row i of a sampled verify is what ``sample_dynamic`` draws for the
    i-th token from a generator with the same seed, and restoring the state
    noted after draw k puts the generator where draw k + 1 starts."""
    from dllama_tpu_torch.runtime.sampler import gumbel_noise, sample_dynamic

    L, V = 9, 64
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((L, V))
                              .astype(np.float32))
    scfg = SamplerConfig(temperature=temp, topp=topp)
    gen = torch.Generator().manual_seed(21)
    picks, states = tgen.verify_sampled(logits, scfg, gen)
    ref = torch.Generator().manual_seed(21)
    want = [int(sample_dynamic(logits[i], temp, topp, ref)) for i in range(L)]
    assert picks.tolist() == want and len(states) == L
    fresh = torch.Generator().manual_seed(21)
    draws = [gumbel_noise(V, fresh, "cpu") for _ in range(L)]
    for k in range(L - 1):
        gen.set_state(states[k])
        assert torch.equal(gumbel_noise(V, gen, "cpu"), draws[k + 1])


def test_spec_needs_a_token_to_feed(dense):
    with pytest.raises(ValueError, match="token to feed"):
        list(_engine(dense).generate_spec([], 4))


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
    from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
    from dllama_tpu_torch.formats.weights import tensor_plan, write_model
    from dllama_tpu_torch.quants import blocks

    d = tmp_path_factory.mktemp("torch_spec_cli")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [b" ", b"He", b"ll", b"o", b" w", b"or", b"ld", b"Hello", b" world"]
    vocab += [f"tok{i}".encode() for i in range(320 - len(vocab))]
    scores = [0.0] * 259 + [float(i) for i in range(len(vocab) - 259)]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=scores, bos_id=1,
                                                  eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=128, hidden_dim=192, n_layers=2, n_heads=4,
                     n_kv_heads=2, vocab_size=len(vocab), seq_len=64,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    tensors = {e.name: (np.ones(e.d * e.n, np.float32) if "rms" in e.name
                        else 0.08 * rng.standard_normal(e.d * e.n).astype(np.float32))
               for e in tensor_plan(spec)}
    write_model(str(d / "m.m"), spec, tensors)
    return str(d / "m.m"), str(d / "t.t")


def _cli(capsys, mode, model_files, extra) -> str:
    model, tok = model_files
    cli.main([mode, "--device", "cpu", "--model", model, "--tokenizer", tok, "--steps", "16",
              "--temperature", "0", "--seed", "0", "--dtype", "float32",
              "--weights-float-type", "q40", "--system-prompt", "", *extra])
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["generate", "inference"])
def test_cli_spec_draft_prints_the_plain_tokens(capsys, model_files, mode):
    def ids(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("Token ids:"))
        return [int(t) for t in line.split(":", 1)[1].split()]

    plain = ids(_cli(capsys, mode, model_files, ["--prompt", "Hello world"]))
    spec = ids(_cli(capsys, mode, model_files, ["--prompt", "Hello world", "--spec-draft", "4"]))
    assert len(plain) > 1 and spec == plain


def test_cli_chat_spec_draft_prints_the_plain_replies(capsys, monkeypatch, model_files):
    def chat(extra):
        turns = iter(["Hello", "world"])

        def fake_input(prompt=""):
            try:
                return next(turns)
            except StopIteration:
                raise EOFError from None

        monkeypatch.setattr(builtins, "input", fake_input)
        out = _cli(capsys, "chat", model_files, extra)
        return [ln for ln in out.splitlines() if "Assistant:" in ln]

    plain = chat([])
    assert len(plain) == 2 and chat(["--spec-draft", "4"]) == plain
