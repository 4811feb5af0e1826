"""The port's router in front of two real port replicas: mid-stream
failover over the port's paged KV checkpoints (CPU, float32, params from
the JAX package through ``from_jax_params``).

* The router-side cases of ``tests/test_failover.py`` run again, on the
  port's router over the two in-process port ``ServerState`` replicas of
  ``tests/test_torch_failover.py`` (``tests/torch_mirror.py`` rebinds the
  cases): resume after a death, death between checkpoints, the typed
  error of an exhausted resume, the fallback matrix (injected, no_ckpt,
  admit_failed), a stale checkpoint, no sibling in a fleet of one, and
  checkpoints off.
* A greedy stream through the port's router over the port pair has the
  text of the same request through the JAX router over a JAX pair on the
  same weights, uninterrupted and resumed after a death.
* A resumed stream, greedy or sampled, is byte for byte the uninterrupted
  stream of the same request (the per-request ``id`` and ``created``
  fields aside).
"""

import re
import threading

import pytest

import tests.test_failover as jt
from dllama_tpu import faults as jfaults
from dllama_tpu.serving import api_server as japi
from dllama_tpu.serving import router as jrt
from dllama_tpu_torch import faults
from dllama_tpu_torch.serving import kv_transfer
from dllama_tpu_torch.serving import router as trt
from tests.test_torch_failover import PAIR, _serve, _stop, model, pair  # noqa: F401 (fixtures)
from tests.torch_mirror import mirror

_DIRECT = ("test_ckpt_frames_opt_in_and_resumable", "test_direct_resume_splices_byte_identically",
           "test_resume_on_warm_sibling_bit_identical",
           "test_stop_string_session_resumes_with_scanback",
           "test_resume_rejects_non_resumable_payload_with_reason")  # in test_torch_failover.py

globals().update(mirror(jt, skip=_DIRECT))

DEATH = "stream:raise:after=4,times=1"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def jax_pair(model):
    """Two JAX replicas over the same weights as the port pair."""
    started = [_serve(japi, *model[3:], **PAIR) for _ in range(2)]
    yield [port for _, _, port in started]
    for state, srv, _ in started:
        _stop(state, srv)


def _router(rt, ports, ckpt_interval=2, **kw):
    state = rt.RouterState([rt.Replica("127.0.0.1", p) for p in ports],
                           probe_interval_s=60.0, ckpt_interval=ckpt_interval, **kw)
    state.probe_once()
    srv = rt.create_router_server(state, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return state, srv, srv.server_address[1]


def _routed(rt, fault_mod, ports, body, plan=None, **kw):
    """One request through a fresh router: (status, raw SSE bytes, resume
    outcomes counted)."""
    state, srv, port = _router(rt, ports, **kw)
    try:
        if plan:
            fault_mod.install(plan)
        st, _, data = jt._post(port, "/v1/chat/completions", body)
        fault_mod.clear()
        return st, data, {o: state._m_resumes.value(outcome=o) for o in jt.OUTCOMES
                          if state._m_resumes.value(outcome=o)}
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("plan", [None, DEATH], ids=["uninterrupted", "resumed"])
def test_greedy_routed_text_equals_the_jax_pairs(pair, jax_pair, plan):
    body = jt._chat(max_tokens=12)
    tst, tdata, tres = _routed(trt, faults, pair, body, plan)
    jst, jdata, jres = _routed(jrt, jfaults, jax_pair, body, plan)
    assert tst == jst == 200 and tres == jres == ({"ok": 1.0} if plan else {})
    text, finish, done, err = jt._parts(tdata)
    assert done and err is None and text
    assert (text, finish) == jt._parts(jdata)[:2]


_IDS = re.compile(rb'"id": "chatcmpl-[0-9a-f]+"|"created": [0-9]+')


@pytest.mark.parametrize("sampling", [dict(temperature=0.0), dict(temperature=0.9, seed=7)],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("ckpt_interval", [2, 4])
def test_resumed_stream_is_byte_identical_to_the_uninterrupted_one(pair, sampling, ckpt_interval):
    body = jt._chat(max_tokens=16, **sampling)
    st, ref, res = _routed(trt, faults, pair, body, ckpt_interval=ckpt_interval)
    assert st == 200 and res == {} and b"[DONE]" in ref
    st, got, res = _routed(trt, faults, pair, body, DEATH, ckpt_interval=ckpt_interval)
    assert st == 200 and res == {"ok": 1.0} and b"dllama-ckpt" not in got
    assert _IDS.sub(b"", got) == _IDS.sub(b"", ref)


def test_sampled_resume_refused_by_another_device_kind_ends_with_a_typed_error(pair):
    """A sampled row's checkpoint carries its generator's state words. A
    sibling whose generator has another state (a CUDA state offered to a
    CPU replica) refuses the snapshot; the router ends the stream with a
    typed error event and ``[DONE]``, never a cut."""
    state, srv, port = _router(trt, pair)
    put = state.ckpt_store.put

    def foreign(rid, payload, offset, replica):
        snap = kv_transfer.decode_snapshot(payload)
        snap["keys"] = [0, 0, 0, 0]  # the size of a CUDA generator's state
        put(rid, kv_transfer.encode_snapshot(snap, snap["prompt"], extra=snap["extra"],
                                             stop_state=snap.get("stop_state")),
            offset, replica)

    state.ckpt_store.put = foreign
    try:
        faults.install(DEATH)
        st, _, data = jt._post(port, "/v1/chat/completions",
                               jt._chat(max_tokens=16, temperature=0.9, seed=7))
        faults.clear()
        _, _, done, err = jt._parts(data)
        assert st == 200 and done and err is not None, data[-400:]
        assert data.rstrip().endswith(b"data: [DONE]")
        resumes = {o: state._m_resumes.value(outcome=o) for o in jt.OUTCOMES
                   if state._m_resumes.value(outcome=o)}
        assert resumes == {"admit_failed": 1.0}, resumes
    finally:
        srv.shutdown()
        srv.server_close()
