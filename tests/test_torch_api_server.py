"""The port's OpenAI-compatible server beside the JAX package's, mirroring
``tests/test_api_server.py`` (CPU, float32, the same random params through
``from_jax_params`` and the same tokenizer file): the same requests get the
same greedy texts, finish reasons and statuses from both servers.

Covered: basic, streamed, stop-sequence, ``max_tokens`` and ``n``-choice
completions; malformed requests (400), unknown paths (404), a full
admission gate (429), a draining server (503) and an expired deadline
(504); multi-turn prefix reuse; LRU eviction freeing the evicted cache's
tensors and graphs at once; a ``--spec-draft`` server; concurrent greedy
requests batched into one pool with ``--kv-buckets 0``; and the bucketed,
paged and role configurations answering as the JAX server's.
"""

import gc
import http.client
import json
import threading
import weakref

import jax
import numpy as np
import pytest

from dllama_tpu.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu.serving import api_server as japi
from dllama_tpu.tokenizer.bpe import Tokenizer as JTokenizer
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime import sampler as tsampler
from dllama_tpu_torch.serving import api_server as tapi
from dllama_tpu_torch.tokenizer.bpe import Tokenizer as TTokenizer


@pytest.fixture(scope="module")
def bits(tmp_path_factory):
    """(JAX (engine maker, tokenizer, cfg), port (engine maker, tokenizer, cfg))."""
    path = str(tmp_path_factory.mktemp("api") / "t.t")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % b for b in range(256)]
    vocab += [b" ", b"e", b"t", b"he", b" the", b"hello", b" world"]
    scores = [0.0] * 259 + [-1.0, -2.0, -2.0, -1.5, -1.2, -1.1, -1.1]
    write_tokenizer(path, TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2))
    shape = dict(arch="llama", dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 vocab_size=len(vocab), seq_len=256, head_size=8, kv_dim=16,
                 dtype="float32")
    jc, tc = JConfig(**shape), TConfig(**shape)
    jp = jl.random_params(jc, seed=13, dtype=np.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")

    def jeng(**kw):
        return jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0, seed=1), **kw)

    def teng(**kw):
        return tgen.Engine(tc, tp, tsampler.SamplerConfig(temperature=0.0, seed=1),
                           device="cpu", **kw)

    return ((jeng, JTokenizer.from_file(path), jc, japi),
            (teng, TTokenizer.from_file(path), tc, tapi))


def _serve(side, engine=None, **kw):
    make, tok, cfg, api = side
    state = api.ServerState(engine if engine is not None else make(), tok, cfg,
                            model_name="tiny-test", template="llama3", **kw)
    srv = api.create_server(state, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return state, srv, srv.server_address[1]


def _stop(state, srv):
    state.sampler.stop()
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def servers(bits):
    """One solo server per package (``--batch-window 0``)."""
    started = [_serve(side) for side in bits]
    yield [port for _, _, port in started]
    for state, srv, _ in started:
        _stop(state, srv)


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def chat_body(**kw):
    body = {"model": "tiny-test", "messages": [{"role": "user", "content": "hello world"}],
            "max_tokens": 8, "temperature": 0.0}
    body.update(kw)
    return body


def _answer(status, data, stream=False):
    """What must agree between the servers: the status and, for 200s, each
    choice's text and finish reason (streamed: the joined deltas)."""
    if status != 200:
        return status, sorted(json.loads(data))
    if stream:
        events = [ln[len(b"data: "):] for ln in data.split(b"\n\n") if ln.startswith(b"data: ")]
        assert events[-1] == b"[DONE]"
        deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
        return status, "".join(d["delta"].get("content", "") for d in deltas), \
            deltas[-1]["finish_reason"]
    obj = json.loads(data)
    return status, [(c["message"]["content"], c["finish_reason"]) for c in obj["choices"]], \
        obj["usage"]


CASES = {
    "basic": chat_body(),
    "stream": chat_body(stream=True),
    "max_tokens": chat_body(max_tokens=3),
    "n_greedy": chat_body(n=2, max_tokens=5),
    "long_greedy": chat_body(max_tokens=24, messages=[
        {"role": "system", "content": "the"}, {"role": "user", "content": "hello the world"}]),
    "empty_messages": {"messages": []},
    "no_content": {"messages": [{"role": "user"}]},
    "bad_seed": chat_body(seed="abc"),
    "bad_stop": chat_body(stop=[1, 2]),
    "n_stream": chat_body(n=3, stream=True),
    "n_too_many": chat_body(n=99),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_answer_as_the_jax_server(servers, case):
    body = CASES[case]
    jport, tport = servers
    stream = bool(body.get("stream")) and body.get("n", 1) == 1
    want = _answer(*request(jport, "POST", "/v1/chat/completions", body), stream)
    got = _answer(*request(tport, "POST", "/v1/chat/completions", body), stream)
    assert got == want
    if case in ("basic", "stream", "long_greedy", "n_greedy"):
        assert got[0] == 200 and got[1]


@pytest.mark.parametrize("method,path", [("GET", "/v1/nope"), ("POST", "/v1/nope"),
                                         ("GET", "/v1/models"), ("GET", "/health")])
def test_same_status_for_other_paths(servers, method, path):
    statuses = [request(port, method, path, {} if method == "POST" else None)[0]
                for port in servers]
    assert statuses[1] == statuses[0]


def test_metrics_and_readiness_answer(servers):
    _, tport = servers
    request(tport, "POST", "/v1/chat/completions", chat_body(max_tokens=2))
    status, data = request(tport, "GET", "/metrics")
    text = data.decode()
    assert status == 200
    for name in ("dllama_prefill_ms_count", "dllama_decode_step_ms_count",
                 "dllama_numeric_quarantines_total", "dllama_http_requests_total"):
        assert name in text, name
    assert request(tport, "GET", "/ready")[0] == 200
    assert json.loads(request(tport, "GET", "/stats")[1])["model"] == "tiny-test"


@pytest.mark.parametrize("stream", [False, True])
def test_stop_sequence_truncates_as_jax(servers, stream):
    jport, tport = servers
    _, data = request(jport, "POST", "/v1/chat/completions", chat_body(max_tokens=16))
    full = json.loads(data)["choices"][0]["message"]["content"]
    stop = full[2:4]
    body = chat_body(max_tokens=16, stop=[stop], stream=stream)
    want = _answer(*request(jport, "POST", "/v1/chat/completions", body), stream)
    got = _answer(*request(tport, "POST", "/v1/chat/completions", body), stream)
    assert got == want
    text, finish = (got[1], got[2]) if stream else got[1][0]
    assert finish == "stop" and text == full[:full.find(stop)]


def test_multi_turn_over_http_matches_jax(bits):
    """A follow-up turn answers the same whether or not a cached session
    serves its prefix, and as the JAX server answers it."""
    first = [{"role": "user", "content": "hello world"}]
    out = []
    for side in bits:
        state, srv, port = _serve(side)
        _, data = request(port, "POST", "/v1/chat/completions",
                          chat_body(messages=first, max_tokens=4))
        reply = json.loads(data)["choices"][0]["message"]["content"]
        follow = first + [{"role": "assistant", "content": reply},
                          {"role": "user", "content": "hello the world"}]
        warm = request(port, "POST", "/v1/chat/completions",
                       chat_body(messages=follow, max_tokens=6))
        state._sessions.clear()
        cold = request(port, "POST", "/v1/chat/completions",
                       chat_body(messages=follow, max_tokens=6))
        _stop(state, srv)
        out.append((reply, _answer(*warm), _answer(*cold)))
    assert out[1] == out[0]
    assert out[1][1] == out[1][2]


def test_prefix_session_continues_the_conversation(bits):
    """The solo path's prefix reuse (claim, stream, store — what the
    handler does under the lock) on token ids: the second turn claims the
    first turn's session, feeds only its new tokens, and emits the tokens
    of a fresh run over the whole history, as the JAX server's state does."""
    out = []
    for make, tok, cfg, api in bits:
        state = api.ServerState(make(), tok, cfg, model_name="tiny-test")
        greedy = state.default_sampler.__class__(temperature=0.0, seed=1)

        def turn(prompt):
            session, feed = state.take_prefix_session(prompt)
            toks = [t for t, _ in state.open_stream(prompt, feed, session, 6, greedy)]
            state.store_prefix_session(prompt + toks, state.engine.final_session)
            return session is not None, len(feed), toks

        p1 = [1, 264, 265, 261]
        hit1, _, t1 = turn(p1)
        p2 = p1 + t1 + [263, 259, 264]
        second = turn(p2)
        fresh = [t for t, _ in make().generate(p2, 6, sampler=greedy)]
        out.append((hit1, t1, second, fresh))
    assert out[1] == out[0]
    hit1, _, (hit2, fed, t2), fresh = out[1]
    assert not hit1 and hit2 and fed == 3 and t2 == fresh


def test_lru_eviction_frees_the_cache_and_its_graphs(bits):
    """An evicted session's cache tensors die at once (no collection
    needed) and the engine forgets the graphs captured on them."""
    make, tok, cfg, _ = bits[1]
    eng = make()
    state = tapi.ServerState(eng, tok, cfg, model_name="tiny-test", session_cache=1)
    for _ in eng.generate([1, 5, 9], 4):
        pass
    sess = eng.final_session
    refs = [weakref.ref(t) for t in sess.cache.values()]
    assert len(eng.graphs) == 1
    gc.disable()
    try:
        state.store_prefix_session([1, 5, 9, 7, 7, 7, 7], sess)
        del sess
        for _ in eng.generate([2, 3], 3):  # the resident cache is held: a new one
            pass
        state.store_prefix_session([2, 3, 4, 4, 4], eng.final_session)  # evicts
        assert all(r() is None for r in refs)
        assert len(eng.graphs) == 1 and eng.graphs.made == 2
    finally:
        gc.enable()
    got, feed = state.take_prefix_session([9, 9])  # a miss at capacity evicts first
    assert got is None and state._sessions == [] and eng.final_session is None


def test_spec_draft_server_matches_jax(bits):
    bodies = [chat_body(max_tokens=12), chat_body(max_tokens=10, stream=True),
              chat_body(max_tokens=20, messages=[
                  {"role": "user", "content": "the the the the the the the"}])]
    out = []
    for side in bits:
        state, srv, port = _serve(side, spec_draft=4)
        out.append([_answer(*request(port, "POST", "/v1/chat/completions", b),
                            bool(b.get("stream"))) for b in bodies])
        _stop(state, srv)
    assert out[1] == out[0]


def test_concurrent_greedy_requests_batch_into_one_pool(bits, servers):
    """Three greedy requests inside the batch window share one slot-pool
    session (at least two rows co-resident) and get the JAX server's
    replies."""
    prompts = ["hello world", "the the cat", "world hello the"]

    def ask_all(port):
        replies = [None] * len(prompts)

        def one(i):
            _, d = request(port, "POST", "/v1/chat/completions", chat_body(
                messages=[{"role": "user", "content": prompts[i]}], max_tokens=6))
            replies[i] = json.loads(d)["choices"][0]["message"]["content"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return replies

    make, *_ = bits[1]
    eng, sizes = make(), []
    orig = eng.batch_session

    def spy(max_batch, chunk=None, **kw):
        sess = orig(max_batch, chunk, **kw)
        begin = sess.admit_begin  # admit() goes through it too

        def admit_begin(*a, **k):
            slot = begin(*a, **k)
            sizes.append(len(sess.occupied))
            return slot

        sess.admit_begin = admit_begin
        return sess

    eng.batch_session = spy
    state, srv, port = _serve(bits[1], engine=eng, batch_window_ms=400.0, kv_buckets=0)
    try:
        want = ask_all(servers[0])
        got = ask_all(port)
    finally:
        _stop(state, srv)
    assert got == want
    assert sizes and max(sizes) >= 2, sizes


@pytest.mark.parametrize("scenario", ["queue_full", "draining", "deadline"])
def test_lifecycle_statuses_match_jax(bits, scenario):
    kw = {"queue_full": dict(queue_depth=1), "draining": {},
          "deadline": dict(request_timeout=1e-9)}[scenario]
    out = []
    for side in bits:
        state, srv, port = _serve(side, **kw)
        if scenario == "queue_full":
            state.gate.acquire()
        elif scenario == "draining":
            state.begin_drain()
        status, data = request(port, "POST", "/v1/chat/completions", chat_body())
        ready = request(port, "GET", "/ready")[0]
        _stop(state, srv)
        out.append((status, json.loads(data)["error"]["message"], ready))
    assert out[1] == out[0]
    assert out[1][0] == {"queue_full": 429, "draining": 503, "deadline": 504}[scenario]


@pytest.mark.parametrize("kw", [dict(kv_pages=16), dict(role="prefill"), dict(role="decode"),
                                dict(batch_window_ms=30.0),
                                dict(batch_window_ms=30.0, kv_buckets=1)])
def test_unported_configurations_are_refused(bits, kw):
    """The configurations that were refused before they were ported (the
    name is kept): each now serves, batched (the paged pool for pages and
    roles), and answers a request as the JAX server in the same
    configuration does; a paged server's /ready reports its pages."""
    kw = dict(kw)
    kw.setdefault("batch_window_ms", 30.0)
    if "role" in kw:
        kw["kv_pages"] = 16
    out = []
    for side in bits:
        state, srv, port = _serve(side, **kw)
        try:
            answer = _answer(*request(port, "POST", "/v1/chat/completions", chat_body()))
            ready = json.loads(request(port, "GET", "/ready")[1])
        finally:
            _stop(state, srv)
        out.append((answer, ready.get("role"), "kv_pages" in ready))
    assert out[1] == out[0] and out[1][0][0] == 200
    assert out[1][2] == ("kv_pages" in kw)
