"""The server modes that run on the port's paged KV export (CPU, float32),
mirroring the direct-replica tests of ``tests/test_failover.py`` (no
router), the preemption cases of ``tests/test_slo.py`` and the paged
occupancy test of ``tests/test_api_server.py``:

* checkpoint frames (``X-Dllama-Ckpt``) are opt-in, decode to resumable
  snapshots and leave the visible stream as it is, whose text equals the
  JAX server's for the same request and weights;
* ``/v1/kv/resume`` on a sibling replica continues a checkpointed stream
  byte for byte from its splice offset, cold or warm, stop strings
  included, and refuses a payload that is not a checkpoint;
* ``/v1/prefill`` on a ``--role prefill`` replica and ``/v1/kv/import`` on
  a ``--role decode`` one give the colocated stream;
* a batch-class row preempted by an interactive request resumes with the
  tokens of an unpreempted run; a fault at the ``preempt`` seam leaves it
  decoding; a client that gives up while parked is reaped;
* a paged server's ``/ready`` and ``/stats`` carry its pages.
"""

import base64
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from dllama_tpu import faults as jfaults
from dllama_tpu.formats.tokenizer_file import TokenizerData, write_tokenizer
from dllama_tpu.models import llama as jl
from dllama_tpu.models.config import ModelConfig as JConfig
from dllama_tpu.runtime import generate as jgen
from dllama_tpu.runtime import sampler as jsampler
from dllama_tpu.serving import api_server as japi
from dllama_tpu.tokenizer.bpe import Tokenizer as JTokenizer
from dllama_tpu_torch import faults
from dllama_tpu_torch.convert_params import from_jax_params
from dllama_tpu_torch.models.config import ModelConfig as TConfig
from dllama_tpu_torch.runtime import generate as tgen
from dllama_tpu_torch.runtime.sampler import SamplerConfig
from dllama_tpu_torch.serving import api_server as tapi
from dllama_tpu_torch.serving import kv_transfer
from dllama_tpu_torch.serving.lifecycle import CancelToken
from dllama_tpu_torch.tokenizer.bpe import Tokenizer as TTokenizer

SHAPE = dict(arch="llama", dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             seq_len=512, head_size=8, kv_dim=16, dtype="float32")
BATCH_STEPS = 440


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(port engine maker, port tokenizer, port cfg, JAX engine maker, JAX
    tokenizer, JAX cfg) over one set of random weights."""
    path = str(tmp_path_factory.mktemp("failover") / "t.t")
    vocab = [b"<unk>", b"<s>", b"</s>"] + [b"<0x%02X>" % b for b in range(256)]
    vocab += [b" ", b"e", b"t", b"he", b" the", b"hello", b" world"]
    scores = [0.0] * 259 + [-1.0, -2.0, -2.0, -1.5, -1.2, -1.1, -1.1]
    write_tokenizer(path, TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2))
    jc, tc = JConfig(vocab_size=len(vocab), **SHAPE), TConfig(vocab_size=len(vocab), **SHAPE)
    jp = jl.random_params(jc, seed=13, dtype=np.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    return (lambda: tgen.Engine(tc, tp, SamplerConfig(temperature=0.0, seed=1), device="cpu"),
            TTokenizer.from_file(path), tc,
            lambda: jgen.Engine(jc, jp, jsampler.SamplerConfig(temperature=0.0, seed=1)),
            JTokenizer.from_file(path), jc)


def _serve(api, make, tok, cfg, **kw):
    state = api.ServerState(make(), tok, cfg, model_name="tiny-test", template="llama3", **kw)
    srv = api.create_server(state, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return state, srv, srv.server_address[1]


def _stop(state, srv):
    state.sampler.stop()
    srv.shutdown()
    srv.server_close()


PAIR = dict(batch_window_ms=5.0, batch_chunk=2, kv_pages=16, ckpt_interval=2)


@pytest.fixture(scope="module")
def pair(model):
    """Two port replicas over the same weights (a resumed row regenerates
    the first one's tokens exactly)."""
    started = [_serve(tapi, *model[:3], **PAIR) for _ in range(2)]
    yield [port for _, _, port in started]
    for state, srv, _ in started:
        _stop(state, srv)


def _post(port, path, body, headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body if isinstance(body, bytes) else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _chat(max_tokens=12, content="hello world", **kw):
    body = {"model": "m", "max_tokens": max_tokens, "temperature": 0.0, "stream": True,
            "messages": [{"role": "user", "content": content}]}
    body.update(kw)
    return body


def _split_stream(data: bytes):
    """(visible bytes, [(offset, payload bytes)]): the client's view with
    the checkpoint control frames taken out, and the frames."""
    visible, frames = [], []
    for ev in data.split(b"\n\n"):
        if not ev:
            continue
        if ev.startswith(b"event: dllama-ckpt"):
            line = next(ln for ln in ev.split(b"\n") if ln.startswith(b"data: "))
            off, _, b64 = line[6:].partition(b" ")
            frames.append((int(off), base64.b64decode(b64)))
        else:
            visible.append(ev + b"\n\n")
    return b"".join(visible), frames


def _parts(data: bytes):
    """(content text, finish reason, saw [DONE], error)."""
    text, finish, done, err = [], None, False, None
    for line in data.split(b"\n"):
        if not line.startswith(b"data: "):
            continue
        if line == b"data: [DONE]":
            done = True
            continue
        try:
            obj = json.loads(line[6:])
        except ValueError:
            continue
        if "error" in obj:
            err = obj["error"]
        for ch in obj.get("choices", []):
            text.append((ch.get("delta") or {}).get("content") or "")
            finish = ch.get("finish_reason") or finish
    return "".join(text), finish, done, err


RESUME = {"Content-Type": kv_transfer.CONTENT_TYPE}


# -- checkpoint frames and direct resume ------------------------------------

def test_ckpt_frames_opt_in_and_resumable(model, pair):
    st, _, data = _post(pair[0], "/v1/chat/completions", _chat())
    assert st == 200 and b"dllama-ckpt" not in data
    st, _, data = _post(pair[0], "/v1/chat/completions", _chat(),
                        headers={"X-Dllama-Ckpt": "2"})
    assert st == 200
    visible, frames = _split_stream(data)
    assert len(frames) >= 3 and visible.endswith(b"data: [DONE]\n\n")
    offsets = [off for off, _ in frames]
    assert offsets == sorted(offsets) and offsets[0] > 0
    for off, payload in frames:
        resume = kv_transfer.decode_snapshot(payload)["extra"]["resume"]
        assert resume["bytes"] == off
        for key in ("base", "utf8", "prev", "n_generated", "request_id"):
            assert key in resume
    plain = _parts(_post(pair[0], "/v1/chat/completions", _chat())[2])[0]
    assert _parts(data)[0] == plain
    # the JAX server in the same configuration streams the same text
    state, srv, port = _serve(japi, *model[3:], **PAIR)
    try:
        jdata = _post(port, "/v1/chat/completions", _chat(), headers={"X-Dllama-Ckpt": "2"})[2]
    finally:
        _stop(state, srv)
    assert _parts(jdata)[0] == plain and len(_split_stream(jdata)[1]) == len(frames)


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_direct_resume_splices_byte_identically(pair, which):
    st, _, data = _post(pair[0], "/v1/chat/completions", _chat(),
                        headers={"X-Dllama-Ckpt": "2"})
    assert st == 200
    visible, frames = _split_stream(data)
    off, payload = frames[{"first": 0, "middle": len(frames) // 2,
                           "last": len(frames) - 1}[which]]
    st, headers, cont = _post(pair[1], "/v1/kv/resume", payload, headers=RESUME)
    assert st == 200, cont
    assert int(headers.get("X-Dllama-Resume-Offset", -1)) == off
    assert cont == visible[off:]


def test_resume_on_warm_sibling_bit_identical(pair):
    assert _post(pair[1], "/v1/chat/completions", _chat())[0] == 200
    st, _, data = _post(pair[0], "/v1/chat/completions", _chat(),
                        headers={"X-Dllama-Ckpt": "2"})
    visible, frames = _split_stream(data)
    off, payload = frames[len(frames) // 2]
    st, _, cont = _post(pair[1], "/v1/kv/resume", payload, headers=RESUME)
    assert st == 200 and cont == visible[off:]


def test_stop_string_session_resumes_with_scanback(pair):
    plain = _parts(_post(pair[0], "/v1/chat/completions", _chat(max_tokens=20))[2])[0]
    assert len(plain) >= 10
    stop = max((plain[i:i + 3] for i in range(len(plain) - 7)),
               key=lambda s: plain.find(s) if plain.find(s) <= len(plain) - 8 else -1)
    assert 4 <= plain.find(stop) <= len(plain) - 8, (plain, stop)
    st, _, data = _post(pair[0], "/v1/chat/completions", _chat(max_tokens=20, stop=[stop]),
                        headers={"X-Dllama-Ckpt": "2"})
    visible, frames = _split_stream(data)
    assert _parts(data)[1] == "stop" and frames
    snap = kv_transfer.decode_snapshot(frames[0][1])
    assert snap["stop_state"]["stops"] == [stop]
    off, payload = frames[0]
    st, _, cont = _post(pair[1], "/v1/kv/resume", payload, headers=RESUME)
    assert st == 200 and cont == visible[off:] and _parts(cont)[1] == "stop"


def test_resume_rejects_non_resumable_payload_with_reason(pair):
    _, _, data = _post(pair[0], "/v1/chat/completions", _chat(),
                       headers={"X-Dllama-Ckpt": "2"})
    snap = kv_transfer.decode_snapshot(_split_stream(data)[1][0][1])
    bare = kv_transfer.encode_snapshot(snap, snap["prompt"], mode="f32")
    st, _, body = _post(pair[1], "/v1/kv/resume", bare, headers=RESUME)
    assert st == 422 and b"resumable" in body
    assert _post(pair[1], "/v1/kv/resume", b"garbage", headers=RESUME)[0] == 422


def test_prefill_then_decode_roles_equal_the_colocated_stream(model, pair):
    """/v1/prefill on a --role prefill replica returns the row's page
    stream after its first chunk; /v1/kv/import on a --role decode replica
    streams the rest; the two together are the colocated stream."""
    body = _chat(max_tokens=12, stream=False)
    colocated = json.loads(_post(pair[0], "/v1/chat/completions", body)[2])
    want = colocated["choices"][0]["message"]["content"]
    roles = [_serve(tapi, *model[:3], role=r, **PAIR) for r in ("prefill", "decode")]
    try:
        for stream in (False, True):
            st, headers, wire = _post(roles[0][2], "/v1/prefill",
                                      _chat(max_tokens=12, stream=stream))
            assert st == 200 and headers.get("Content-Type") == kv_transfer.CONTENT_TYPE
            assert kv_transfer.decode_snapshot(wire)["extra"]["emitted_tokens"]
            st, _, cont = _post(roles[1][2], "/v1/kv/import", wire, headers=RESUME)
            assert st == 200, cont
            got = (_parts(cont)[0] if stream
                   else json.loads(cont)["choices"][0]["message"]["content"])
            assert got == want
        assert [json.loads(_get(p, "/ready")[1])["role"] for _, _, p in roles] == [
            "prefill", "decode"]
    finally:
        for state, srv, _ in roles:
            _stop(state, srv)


# -- preemption --------------------------------------------------------------

@pytest.fixture(scope="module")
def preempt_srv(model):
    """A 1-row paged pool: an interactive arrival during a batch-class
    decode has to preempt it to be admitted."""
    state, srv, port = _serve(tapi, *model[:3], batch_window_ms=5.0, batch_max=1,
                              batch_chunk=2, kv_pages=16,
                              slo_classes="interactive:depth=8;batch:depth=4")
    yield state, port
    _stop(state, srv)


def _counts(state):
    m = state.batcher._m_preemptions
    return {o: m.value(outcome=o) for o in ("ok", "resumed", "retry", "injected", "error")}


def _contend(state, port):
    """One batch-class stream and, once it decodes, one interactive
    request. (batch text, done, error, interactive status, counter deltas)."""
    before = _counts(state)
    out = {}

    def batch_client():
        out["batch"] = _post(port, "/v1/chat/completions", _chat(max_tokens=BATCH_STEPS),
                             headers={"X-Dllama-Class": "batch"})

    t = threading.Thread(target=batch_client, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if state.batcher.class_stats()["batch"]["resident"] >= 1:
            break
        time.sleep(0.002)
    ist = _post(port, "/v1/chat/completions", _chat(max_tokens=4, content="the cat", stream=False),
                headers={"X-Dllama-Class": "interactive"})[0]
    t.join(timeout=120)
    assert not t.is_alive()
    text, _, done, err = _parts(out["batch"][2])
    after = _counts(state)
    return text, done, err, ist, {k: after[k] - before[k] for k in after}


def test_preempted_batch_row_is_bit_identical(preempt_srv):
    state, port = preempt_srv
    st, _, body = _post(port, "/v1/chat/completions", _chat(max_tokens=BATCH_STEPS),
                        headers={"X-Dllama-Class": "batch"})
    want, _, done, err = _parts(body)
    assert st == 200 and done and err is None and want
    text, done, err, ist, deltas = _contend(state, port)
    assert ist == 200 and done and err is None
    assert text == want
    assert deltas["ok"] >= 1 and deltas["resumed"] >= 1 and deltas["error"] == 0
    assert state.batcher.class_stats()["batch"]["preempted"] == 0


def test_preempt_fault_leaves_batch_row_decoding(preempt_srv):
    state, port = preempt_srv
    want = _parts(_post(port, "/v1/chat/completions", _chat(max_tokens=BATCH_STEPS),
                        headers={"X-Dllama-Class": "batch"})[2])[0]
    faults.install("preempt:raise")
    try:
        text, done, err, ist, deltas = _contend(state, port)
    finally:
        faults.clear()
    assert ist == 200 and done and err is None and text == want
    assert deltas["injected"] >= 1 and deltas["ok"] == 0 and deltas["resumed"] == 0


def test_preempt_while_cancelling(model, preempt_srv):
    state, port = preempt_srv
    tok = model[1]
    cancel = CancelToken()
    got = {"error": None}

    def batch_client():
        try:
            for _ in state.batcher.submit_stream(
                    tok.encode("hello world", add_bos=True), 440,
                    SamplerConfig(temperature=0.0, seed=1), cancel=cancel, slo_class="batch"):
                pass
        except Exception as e:  # noqa: BLE001 — the typed cancel error
            got["error"] = e

    t = threading.Thread(target=batch_client, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and state.batcher.class_stats()["batch"]["resident"] < 1:
        time.sleep(0.002)
    before = _counts(state)
    out = {}
    ti = threading.Thread(target=lambda: out.setdefault("st", _post(
        port, "/v1/chat/completions", _chat(max_tokens=48, content="the cat", stream=False),
        headers={"X-Dllama-Class": "interactive"})[0]), daemon=True)
    ti.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and _counts(state)["ok"] <= before["ok"]:
        time.sleep(0.002)
    assert _counts(state)["ok"] > before["ok"], "the interactive arrival never preempted"
    cancel.cancel("client gone while parked")
    ti.join(timeout=120)
    t.join(timeout=30)
    assert not t.is_alive() and out["st"] == 200
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and state.batcher.class_stats()["batch"]["preempted"]:
        time.sleep(0.01)
    assert state.batcher.class_stats()["batch"]["preempted"] == 0
    assert _post(port, "/v1/chat/completions", _chat(max_tokens=2))[0] == 200


def test_preempt_at_last_chunk_resumes_exactly(model):
    engine = model[0]()
    prompt = model[1].encode("hello world", add_bos=True)
    sess = engine.batch_session(max_batch=2, chunk=2, kv_pages=16)
    ref = sess.admit(prompt, steps=5)
    want = []
    while not sess.is_done(ref):
        want.extend(sess.step_chunk()[ref])
    sess.release(ref)
    b = sess.admit(prompt, steps=5)
    got = []
    for _ in range(2):
        got.extend(sess.step_chunk()[b])
    assert len(got) == 4 and not sess.is_done(b)
    snap = sess.export_row(b)
    sess.release(b)
    b2 = sess.admit_from_export(prompt, snap)
    while not sess.is_done(b2):
        got.extend(sess.step_chunk()[b2])
    sess.close()
    assert got == want and len(want) == 5


def test_paged_kv_server_surfaces_occupancy(model):
    state, srv, port = _serve(tapi, *model[:3], batch_window_ms=5.0, kv_pages=16)
    try:
        assert _post(port, "/v1/chat/completions", _chat(stream=False))[0] == 200
        status, data = _get(port, "/ready")
        info = json.loads(data)
        assert status == 200 and "kv_pages" in info and "prefix_hit_rate" in info
        assert info["kv_tokens_reserved"] == 0
        status, data = _get(port, "/stats")
        assert status == 200 and "kv_pages" in json.loads(data)["load"]
    finally:
        _stop(state, srv)
