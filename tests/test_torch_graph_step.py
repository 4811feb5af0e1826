"""The captured decode step's pieces on the CPU, where ``StepGraph`` runs its
body eagerly (the card tests, ``tests/test_torch_cuda_kernels.py``, replay
it).

* ``llama.forward_decode`` (the solo step through the batched launch forms
  at B = 1, the position on the device) is bit-equal to ``forward`` at
  T = 1 in logits and cache: f32 and bf16, float, Q40 and Q80 weights, pos
  0, mid-context and seq_len - 1, over a cache of stale values.
* n runs of the ``StepGraph`` body advance the token and the position as n
  eager steps do (argmax of each step's logits, pos + n), solo and batched,
  a row at the context's end pinned at seq_len - 1 as the eager batched
  chunk pins it.
* ``sampler.sample_prepared`` on a prepared ``RowSampling`` makes no
  tensor from a host value (``torch.tensor`` and ``torch.as_tensor``
  raise inside it) and picks what ``sample_rows`` picks, for any mix of
  sampled and greedy rows that ``RowSampling.set`` loads.
* ``GraphCache`` makes one graph per cache and key and drops it with its
  cache; calls without a session reuse the engine's resident solo cache
  (one graph per engine) unless a live Session holds it; a
  ``BatchSession`` serves sampled and greedy admissions and releases with
  one greedy and one sampled graph, its tokens the eager session's.
* The same for a tiny Mixtral: the MoE step's body (the selected path
  solo and at B = 2, the dense combine at B = 4) advances as eager steps.
* ``cli --decode-chunk N`` reaches ``Engine``; an explicit 0 raises there;
  ``cli generate`` decodes in chunks of N.
"""

import gc

import numpy as np
import pytest
import torch

from dllama_tpu_torch import cli
from dllama_tpu_torch.formats.spec import ArchType, ModelSpec
from dllama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu_torch.formats.weights import tensor_plan, write_model
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.quants import blocks
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.runtime.graphs import GraphCache, StepGraph

SHAPE = dict(arch="llama", dim=128, hidden_dim=192, n_layers=2, n_heads=4, n_kv_heads=2,
             vocab_size=96, seq_len=64, head_size=32, kv_dim=64)
GREEDY = tsampler.SamplerConfig(temperature=0.0)


def _model(dtype: str, quant):
    cfg = ModelConfig(**SHAPE, dtype=dtype)
    p = llama.random_params(cfg, seed=3, device="cpu")
    if quant:
        p = llama.fuse_qkv_ffn(llama.quantize_params(p, quant))
    return cfg, p


def _stale_cache(cfg, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_layers, cfg.seq_len, cfg.n_kv_heads, cfg.head_size)
    return {n: torch.randn(shape, generator=g).to(dtype) for n in ("k", "v")}


@pytest.mark.parametrize("pos", [0, 37, 63])
@pytest.mark.parametrize("quant", [None, "q40", "q80"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_decode_bit_equal_to_forward(dtype, quant, pos):
    cfg, p = _model(dtype, quant)
    rope = llama.rope_tables(cfg, "cpu")
    a = _stale_cache(cfg, cfg.torch_dtype)
    b = {n: c.clone() for n, c in a.items()}
    tok = torch.tensor([17])
    want, _ = llama.forward(cfg, p, rope, tok, a, pos)
    got, cache = llama.forward_decode(cfg, p, rope, tok, b, torch.tensor([pos], dtype=torch.int32))
    assert cache is b
    assert torch.equal(got, want)
    for n in ("k", "v"):
        assert torch.equal(a[n], b[n])


def _eager_steps(cfg, p, rope, cache, token, pos, n):
    """n plain greedy T = 1 steps: (tokens, final pos)."""
    out = []
    for i in range(n):
        logits, _ = llama.forward(cfg, p, rope, torch.tensor([token]), cache, pos + i)
        token = int(torch.argmax(logits[0]))
        out.append(token)
    return out, pos + n


@pytest.mark.parametrize("quant", [None, "q40"])
def test_step_graph_body_advances_like_eager_steps(quant):
    cfg, p = _model("float32", quant)
    rope = llama.rope_tables(cfg, "cpu")
    a = _stale_cache(cfg, torch.float32)
    b = {n: c.clone() for n, c in a.items()}
    want, end = _eager_steps(cfg, p, rope, a, 11, 20, 6)

    def step(cache, tok, pos):
        return llama.forward_decode(cfg, p, rope, tok, cache, pos)[0]

    g = StepGraph(step, b, cfg.seq_len, False, ring_len=8)
    assert g.graph is None  # the CPU runs the body eagerly
    g.load(11, 20)
    toks, ok = g.run(4)
    first = toks[:, 0].tolist()
    toks, ok = g.run(2)  # the next run feeds on from the statics
    assert first + toks[:, 0].tolist() == want
    assert bool(ok.all()) and int(g.pos) == end and int(g.tokens) == want[-1]
    for n in ("k", "v"):
        assert torch.equal(a[n][:, :end], b[n][:, :end])
    with pytest.raises(ValueError, match="ring holds 8"):
        g.run(9)
    del a, b
    gc.collect()
    with pytest.raises(RuntimeError, match="cache was freed"):
        g.run(1)


MIXTRAL = dict(SHAPE, arch="mixtral", n_experts=8, n_active_experts=2)


@pytest.fixture
def one_torch_thread():
    """Tiny tensors: one intra-op thread (several test processes share the
    CPU, and spinning thread pools would oversubscribe it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quant", [None, "q40", "q80"])
def test_moe_step_graph_body_advances_like_eager_steps(quant, one_torch_thread):
    """A tiny Mixtral (E 8, k 2): ``forward_decode`` is ``forward`` at T = 1
    bit for bit, and the graph's body advances as eager steps do — solo on
    the selected path (quantized experts, one row), and batched at B = 2
    (selected) and 4 (the dense combine)."""
    cfg = ModelConfig(**MIXTRAL, dtype="float32")
    p = llama.random_params(cfg, seed=3, device="cpu")
    if quant:
        p = llama.fuse_qkv_ffn(llama.quantize_params(p, quant))
    rope = llama.rope_tables(cfg, "cpu")
    a = _stale_cache(cfg, torch.float32)
    b = {n: c.clone() for n, c in a.items()}
    want_logits, _ = llama.forward(cfg, p, rope, torch.tensor([11]),
                                   {n: c.clone() for n, c in a.items()}, 20)
    got_logits, _ = llama.forward_decode(cfg, p, rope, torch.tensor([11]),
                                         {n: c.clone() for n, c in a.items()},
                                         torch.tensor([20], dtype=torch.int32))
    assert torch.equal(got_logits, want_logits)
    want, end = _eager_steps(cfg, p, rope, a, 11, 20, 5)

    def step(cache, tok, pos):
        return llama.forward_decode(cfg, p, rope, tok, cache, pos)[0]

    g = StepGraph(step, b, cfg.seq_len, False, ring_len=8)
    g.load(11, 20)
    toks, ok = g.run(5)
    assert toks[:, 0].tolist() == want and bool(ok.all()) and int(g.pos) == end
    for n in ("k", "v"):
        assert torch.equal(a[n][:, :end], b[n][:, :end])
    eng = tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=4)
    eager = tgen.Engine(cfg, eng.params, GREEDY, device="cpu", cuda_graphs=False)
    for prompts in ([[5, 9, 3], [7]], [[5, 9, 3], [7], [1, 2, 3, 4], [8, 8]]):
        assert eng.generate_batch(prompts, 6) == eager.generate_batch(prompts, 6)


def test_batched_step_graph_matches_eager_chunk():
    """Rows at mixed positions, one at the context's end: the graphed
    batched chunk gives the eager chunk's tokens, flags, positions and
    cache, and pins the full row at seq_len - 1."""
    cfg, p = _model("float32", "q40")
    S = cfg.seq_len
    graphed = tgen.Engine(cfg, p, GREEDY, device="cpu")
    eager = tgen.Engine(cfg, p, GREEDY, device="cpu", cuda_graphs=False)
    g = torch.Generator().manual_seed(1)
    shape = (cfg.n_layers, 3, S, cfg.n_kv_heads, cfg.head_size)
    a = {n: torch.randn(shape, generator=g) for n in ("k", "v")}
    b = {n: c.clone() for n, c in a.items()}
    host = [5, 30, S - 2]
    tokens = torch.tensor([3, 4, 5])
    pos = torch.tensor(host, dtype=torch.int32)
    temps, topps, gens = [0.0] * 3, [1.0] * 3, [None] * 3
    te, oe, pe = eager._decode_chunk_batch(a, tokens, pos, 5, temps, topps, gens, host)
    tg, og, pg = graphed._decode_chunk_batch(b, tokens, pos, 5, temps, topps, gens, host)
    assert torch.equal(te, tg) and torch.equal(oe, og) and torch.equal(pe, pg)
    assert pg.tolist() == [10, 35, S - 1]
    for n in ("k", "v"):
        assert torch.equal(a[n], b[n])
    assert len(graphed.graphs) == 1


def test_sampled_batched_graph_keeps_generator_streams():
    """Sampled rows draw from the graph's own generators with the caller's
    state, which comes back advanced: two chunks equal one eager chunk of
    twice the steps, and the callers' generators end where eager ones do."""
    cfg, p = _model("float32", None)
    graphed = tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=4)
    eager = tgen.Engine(cfg, p, GREEDY, device="cpu", cuda_graphs=False)
    cache = llama.init_batch_cache(cfg, 3, device="cpu")
    twin = llama.init_batch_cache(cfg, 3, device="cpu")
    temps, topps = [0.8, 0.0, 1.1], [0.9, 1.0, 0.5]

    def gens():
        return [torch.Generator().manual_seed(10 + b) if t > 0 else None
                for b, t in enumerate(temps)]

    tokens, pos = torch.tensor([1, 2, 3]), torch.tensor([0, 4, 9], dtype=torch.int32)
    ge = gens()
    te, _, _ = eager._decode_chunk_batch(cache, tokens, pos, 8, temps, topps, ge, [0, 4, 9])
    gg = gens()
    t1, _, p1 = graphed._decode_chunk_batch(twin, tokens, pos, 4, temps, topps, gg, [0, 4, 9])
    t2, _, _ = graphed._decode_chunk_batch(twin, t1[-1], p1, 4, temps, topps, gg, [4, 8, 13])
    assert torch.equal(torch.cat([t1, t2]), te)
    for b in (0, 2):
        assert torch.equal(gg[b].get_state(), ge[b].get_state())


def test_sample_prepared_makes_no_tensor_from_host_values(monkeypatch):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    temps, topps = [0.8, 0.0, 1.3, 0.5], [0.9, 1.0, 0.0, 0.6]
    prep = tsampler.RowSampling.prepare(temps, topps, "cpu")
    noise = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    want = tsampler.sample_rows(logits, temps, topps, gumbel=noise)
    want_g = tsampler.sample_rows(logits, temps, topps,
                                  [torch.Generator().manual_seed(b) for b in range(4)])

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host values")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    got = tsampler.sample_prepared(logits, prep, gumbel=noise)
    got_g = tsampler.sample_prepared(logits, prep,
                                     [torch.Generator().manual_seed(b) for b in range(4)])
    monkeypatch.undo()
    assert torch.equal(got, want) and torch.equal(got_g, want_g)
    assert prep.mask.tolist() == [True, False, True, True]
    # another mix of rows, loaded into the same tensors
    temps2 = [0.0, 0.6, 0.7, 0.0]
    prep.set(temps2, topps)
    assert prep.mask.tolist() == [False, True, True, False]
    assert prep.temp[:, 0].tolist() == pytest.approx([1.0, 0.6, 0.7, 1.0])
    assert torch.equal(tsampler.sample_prepared(logits, prep, gumbel=noise),
                       tsampler.sample_rows(logits, temps2, topps, gumbel=noise))


def test_graph_cache_drops_graphs_with_their_caches():
    class Graph:
        pass

    made = []

    def make():
        made.append(Graph())
        return made[-1]

    cache = GraphCache()
    owners = [torch.zeros(4) for _ in range(3)]
    assert cache.get(owners[0], ("a",), make) is cache.get(owners[0], ("a",), make)
    cache.get(owners[0], ("b",), make)
    assert len(cache) == 2 and len(made) == 2 == cache.made
    cache.get(owners[1], ("a",), make)
    assert len(cache) == 3
    del owners[1]
    gc.collect()
    assert len(cache) == 2 and cache.made == 3


def test_engine_keeps_no_graph_of_a_freed_cache():
    cfg, p = _model("float32", None)
    eng = tgen.Engine(cfg, p, GREEDY, device="cpu")
    held = []
    for _ in range(3):  # each held Session keeps its cache: a new one each call
        for _ in eng.generate([1, 2, 3], 4):
            pass
        held.append(eng.final_session)
    gc.collect()
    assert len(eng.graphs) == 3 and eng.graphs.made == 3
    held = eng.final_session = None
    gc.collect()
    assert len(eng.graphs) == 1  # the resident cache's, kept with the engine


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_chunk")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    vocab += [f"tok{i}".encode() for i in range(320 - len(vocab))]
    write_tokenizer(str(d / "t.t"), TokenizerData(vocab=vocab, scores=[0.0] * len(vocab),
                                                  bos_id=1, eos_id=2))
    spec = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=1, n_heads=4,
                     n_kv_heads=2, vocab_size=len(vocab), seq_len=32,
                     weights_float_type=blocks.Q40)
    rng = np.random.default_rng(0)
    write_model(str(d / "m.m"), spec, {e.name: 0.05 * rng.standard_normal(e.d * e.n)
                                       .astype(np.float32) for e in tensor_plan(spec)})
    return str(d / "m.m"), str(d / "t.t")


@pytest.mark.parametrize("flag,want", [([], tgen.DECODE_CHUNK), (["--decode-chunk", "4"], 4)])
def test_cli_decode_chunk_reaches_engine(small_model, flag, want):
    model, tok = small_model
    for mode in ("inference", "generate", "chat"):
        args = cli.build_parser().parse_args(
            [mode, "--model", model, "--tokenizer", tok, "--device", "cpu", *flag])
        engine, _, _ = cli.load_engine(args)
        assert engine.decode_chunk == want


def test_cli_decode_chunk_zero_raises(small_model):
    model, tok = small_model
    args = cli.build_parser().parse_args(
        ["generate", "--model", model, "--tokenizer", tok, "--device", "cpu",
         "--decode-chunk", "0"])
    with pytest.raises(ValueError, match="decode_chunk must be >= 1"):
        cli.load_engine(args)


def _stream(eng, prompt, steps, **kw):
    return [t for t, _ in eng.generate(prompt, steps, **kw)]


def test_calls_without_a_session_reuse_one_graph():
    """Consecutive calls without a session decode in the engine's resident
    cache, zeroed for each call, so one graph serves them all and their
    tokens equal those of an engine made for each call; a Session that is
    still held keeps its cache, and continuing it gives the continuation."""
    cfg, p = _model("float32", "q40")
    eng = tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=4)
    s = tsampler.SamplerConfig(temperature=0.9, topp=0.8, seed=4)
    want = [_stream(tgen.Engine(cfg, p, GREEDY, device="cpu"), [5, 6, 7], 9),
            _stream(tgen.Engine(cfg, p, GREEDY, device="cpu"), [9], 7, sampler=s),
            tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=4).generate_fused(
                [1, 2, 3, 4], 11)[0]]
    for _ in range(2):
        got = [_stream(eng, [5, 6, 7], 9), _stream(eng, [9], 7, sampler=s),
               eng.generate_fused([1, 2, 3, 4], 11)[0]]
        assert got == want
    assert eng.graphs.made == 2 and len(eng.graphs) == 2  # greedy and sampled
    resident = eng.final_session.cache
    held = eng.final_session
    both = _stream(eng, [5, 6, 7], 9)  # the resident cache is held: a new cache
    assert both == want[0] and eng.final_session.cache is not resident
    assert _stream(eng, [], 3, session=held) == _stream(
        tgen.Engine(cfg, p, GREEDY, device="cpu"), [1, 2, 3, 4], 15)[11:14]


def test_batch_session_mixed_admissions_use_two_graphs():
    """Sampled and greedy rows admitted and released between chunks: the
    graphed session's tokens equal the eager session's, and one greedy and
    one sampled graph serve every mix (no capture per admission)."""
    cfg, p = _model("float32", "q40")
    graphed = tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=4)
    eager = tgen.Engine(cfg, p, GREEDY, device="cpu", cuda_graphs=False)
    got = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        sess = eng.batch_session(max_batch=3, chunk=4)
        log = []
        for i, (prompt, temp) in enumerate([([3, 4, 5], 0.0), ([9, 8], 0.8), ([7] * 6, 0.0),
                                            ([1, 2], 1.1), ([6, 5, 4, 3], 0.0)]):
            sess.admit(prompt, 10, tsampler.SamplerConfig(temperature=temp, topp=0.9, seed=i))
            log.append(sorted(sess.step_chunk().items()))
            if i % 2:
                sess.release(sess.occupied[0])
        while sess.num_live:
            log.append(sorted(sess.step_chunk().items()))
        sess.close()
        got[name] = log
    assert got["graphed"] == got["eager"]
    assert graphed.graphs.made == 2


def test_generate_fused_stop_tokens_cut_like_generate():
    """A stop token cuts ``generate_fused`` where it cuts ``generate``: the
    same tokens and the same ``final_session``, whatever the chunk."""
    cfg, p = _model("float32", None)
    free = _stream(tgen.Engine(cfg, p, GREEDY, device="cpu"), [1, 2, 3], 20)
    stop = (free[9],)
    first = free.index(stop[0])
    ref = tgen.Engine(cfg, p, GREEDY, device="cpu")
    want = _stream(ref, [1, 2, 3], 20, stop_tokens=stop)
    assert want == free[:first + 1]
    for chunk in (1, 4, 64):
        eng = tgen.Engine(cfg, p, GREEDY, device="cpu", decode_chunk=chunk)
        seen = []
        toks, _, _ = eng.generate_fused([1, 2, 3], 20, stop_tokens=stop, on_chunk=seen.append)
        assert toks == want and sum(seen, []) == want
        assert (eng.final_session.pos, eng.final_session.pending_token) == \
            (ref.final_session.pos, ref.final_session.pending_token)


def test_cli_generate_decodes_in_chunks_of_decode_chunk(small_model, monkeypatch, capsys):
    model, tok = small_model
    runs = []
    real = tgen.Engine._decode_chunk_solo

    def spy(self, cache, token, pos, n, *a):
        runs.append(n)
        return real(self, cache, token, pos, n, *a)

    monkeypatch.setattr(tgen.Engine, "_decode_chunk_solo", spy)
    ids = {}
    for chunk in ("4", "64"):
        runs.clear()
        cli.main(["generate", "--model", model, "--tokenizer", tok, "--device", "cpu",
                  "--steps", "12", "--temperature", "0", "--seed", "0",
                  "--decode-chunk", chunk])
        out = capsys.readouterr().out
        line = next(ln for ln in out.splitlines() if ln.startswith("Token ids:"))
        ids[chunk] = line.split(":", 1)[1].split()
        want = [4, 4, 3] if chunk == "4" else [11]
        assert runs == want
    assert ids["4"] == ids["64"] and len(ids["4"]) == 12
