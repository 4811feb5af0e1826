"""The port's Engine and CLI on tiny Mixtral and Grok-1 models (CPU).

* Greedy ``generate``, ``generate_fused``, ``generate_batch`` (B = 2 and
  4), ``generate_spec`` and ``generate_batch_spec`` give the JAX package's
  tokens, on the same f32 params (``from_jax_params``; the dense combine on
  both sides), and on Q40 params for ``generate`` (the selected path: the
  expert-indexed launchers' plain versions against JAX's stacked kernels
  in interpret mode).
* On Q40 params, a ``BatchSession`` gives ``generate_batch``'s rows, and
  ``generate_batch`` rows at B = 2 (the selected path) equal their solo
  ``generate`` streams.
* ``python -m dllama_tpu_torch.cli generate`` and ``inference`` on a
  Mixtral ``.m`` file the port's writer wrote print the Engine's greedy
  token ids.
"""

import pytest
import torch

from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu_torch import cli, kernels
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import WeightFileReader
from dllama_tpu_torch.models import llama as tl
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.tokenizer.bpe import Tokenizer
from tests.test_torch_moe import GREEDY, _params
from tests.test_torch_moe_model import write_moe_model

PROMPTS = [[5, 9, 3], [7], [1, 2, 3, 4, 5, 6, 11], [8, 8]]
SPEC_PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread (several test processes share the
    CPU, and spinning thread pools would oversubscribe it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(arch, quant):
    jp, tp, jc, tc = _params(arch, quant, seed=5, seq_len=64)
    jeng = jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0), metrics=None)
    return jeng, tgen.Engine(tc, tp, GREEDY, device="cpu")


@pytest.mark.parametrize("arch", ["mixtral", "grok1"])
def test_greedy_engine_tokens_match_jax(arch):
    jeng, teng = _engines(arch, None)
    want = [t for t, _ in jeng.generate([1, 5, 9], 8)]
    kernels.reset_launches()
    assert [t for t, _ in teng.generate([1, 5, 9], 8)] == want
    assert teng.generate_fused([1, 5, 9], 8)[0] == want
    for rows in (PROMPTS[:2], PROMPTS):
        assert teng.generate_batch(rows, steps=6) == jeng.generate_batch(rows, steps=6)
    want = [t for t, _ in jeng.generate_spec(SPEC_PROMPT, 10, draft_len=4)]
    assert [t for t, _ in teng.generate_spec(SPEC_PROMPT, 10, draft_len=4)] == want
    want_rows, _ = jeng.generate_batch_spec([SPEC_PROMPT, [4, 5]], 6, draft_len=4)
    rows, _ = teng.generate_batch_spec([SPEC_PROMPT, [4, 5]], 6, draft_len=4)
    assert rows == want_rows
    assert set(kernels.launches.values()) == {0}  # CPU tensors: plain versions only


def test_q40_generate_matches_jax_on_the_selected_path():
    jeng, teng = _engines("mixtral", "q40")
    want = [t for t, _ in jeng.generate([1, 5, 9], 4)]
    assert [t for t, _ in teng.generate([1, 5, 9], 4)] == want
    assert teng.generate_fused([1, 5, 9], 4)[0] == want


def test_q40_batch_rows_session_and_solo_agree():
    _, tp, _, tc = _params("mixtral", "q40", seed=5, seq_len=64)
    eng = tgen.Engine(tc, tp, GREEDY, device="cpu")
    rows = eng.generate_batch(PROMPTS[:2], steps=8)
    assert rows == [[t for t, _ in eng.generate(p, 8)] for p in PROMPTS[:2]]
    sess = eng.batch_session(max_batch=2, chunk=4)
    hs = [sess.admit(p, steps=8) for p in PROMPTS[:2]]
    got = {h: [] for h in hs}
    while not all(sess.is_done(h) for h in hs):
        for h, toks in sess.step_chunk().items():
            got[h] += toks
    sess.close()
    assert [got[h] for h in hs] == rows


def test_cli_generate_on_a_mixtral_file(tmp_path, capsys):
    model, tok = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [f"tok{i}".encode() for i in range(320 - len(vocab))]
    write_tokenizer(tok, TokenizerData(vocab=vocab, scores=[0.0] * len(vocab), bos_id=1,
                                       eos_id=2))
    write_moe_model(model, "mixtral", "q40", seq_len=64, vocab_size=len(vocab))
    with WeightFileReader(model) as r:
        cfg = ModelConfig.from_spec(r.spec)
        params = tl.quant_params_from_reader(r, cfg, "cpu", "q40")
    eng = tgen.Engine(cfg, params, GREEDY, device="cpu")
    prompt = Tokenizer.from_file(tok).encode("ab", add_bos=True)
    want = eng.generate_fused(prompt, 6, stop_tokens=(2,))[0]
    for mode in ("generate", "inference"):  # fused chunks; per token with stats
        cli.main([mode, "--model", model, "--tokenizer", tok, "--device", "cpu",
                  "--prompt", "ab", "--steps", "6", "--temperature", "0", "--seed", "0",
                  "--decode-chunk", "4"])
        out = capsys.readouterr().out
        assert "arch: mixtral" in out
        ids = [int(t) for t in next(ln for ln in out.splitlines()
                                    if ln.startswith("Token ids:")).split(":", 1)[1].split()]
        assert ids and ids == want, mode
