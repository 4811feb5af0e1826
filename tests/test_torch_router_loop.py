"""The port's event-loop front door (``dllama_tpu_torch.serving.evloop`` and
the router's data plane) against the JAX package's.

* Every case of ``tests/test_router_loop.py`` runs again on the port's
  router and loop (keep-alive, slow-loris, ``--max-conns`` shedding, the
  ``conn_accept``/``client_write``/``relay_stall`` seams, the mid-SSE stall
  resume, gray replicas, slow clients, the upstream pool), against the same
  fake replicas (``tests/torch_mirror.py`` rebinds the cases).
* Every-byte-boundary split sweeps: a client request parsed by
  ``read_request``, an upstream response parsed by ``Upstream.get_response``
  and read to its end, and an SSE stream cut by ``SSEScanner``, each fed in
  two pieces split at every byte, give the JAX originals' results: the
  same request, response, events and error, and the same bytes left over.
  The port's scanner searches each byte once (a full-width checkpoint
  frame is tens of MB); hypothesis-made streams cut anywhere give the JAX
  scanner's events.
"""

import base64
import socket

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_router_loop as jt
from dllama_tpu import faults as jfaults
from dllama_tpu import observability as jobs
from dllama_tpu.serving import evloop as jev
from dllama_tpu_torch import faults
from dllama_tpu_torch import observability as tobs
from dllama_tpu_torch.serving import evloop as tev
from tests.torch_mirror import mirror

globals().update(mirror(jt))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _drive(ev, pieces, coro):
    """Run ``coro(ev, sock)`` over one end of a socketpair, writing the next
    piece to the other end each time it parks (then EOF): its result or
    its error, as plain values."""
    a, b = socket.socketpair()
    a.setblocking(False)
    pieces, eof = list(pieces), False
    gen = coro(ev, a)
    try:
        while True:
            try:
                wait = gen.send(None)
            except StopIteration as stop:
                return stop.value
            except (ev.HttpError, ev.ProtocolError) as e:
                return type(e).__name__, getattr(e, "status", None), str(e)
            assert type(wait).__name__ == "_Wait"
            if pieces:
                b.sendall(pieces.pop(0))
            else:
                assert not eof, "parked again after EOF"
                b.shutdown(socket.SHUT_WR)
                eof = True
    finally:
        a.close(), b.close()


def _two_requests(ev, sock):
    """Two requests off one keep-alive connection, as the router reads
    them, and what stays buffered."""
    buf, out = bytearray(), []
    for _ in range(2):
        r = yield from ev.read_request(sock, buf, max_body=64)
        out.append(None if r is None else
                   (r.method, r.path, r.version, r.headers, r.body, r.keep_alive))
        if r is None:
            break
    return out, bytes(buf)


def _response(ev, sock):
    up = ev.Upstream(sock, "127.0.0.1", 1)
    resp = yield from up.get_response()
    body = yield from resp.read_all()
    return resp.version, resp.status, resp.headers, body, resp.reusable, bytes(up.buf)


POST = (b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Length: 11\r\n"
        b"X-Request-Id: r-1\r\n\r\nhello world")
REQUESTS = {
    "keepalive_pair": b"GET /ready HTTP/1.1\r\nHost: x\r\n\r\n" + POST,
    "http10_then_eof": b"GET /health HTTP/1.0\r\nConnection: keep-alive\r\n\r\n",
    "close": b"GET /stats HTTP/1.1\r\nConnection: close\r\n\r\n",
    "bad_request_line": b"BROKEN\r\n\r\n",
    "bad_header": b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
    "chunked": b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
    "bad_length": b"POST / HTTP/1.1\r\nContent-Length: ten\r\n\r\n",
    "too_large": b"POST / HTTP/1.1\r\nContent-Length: 65\r\n\r\n" + b"x" * 65,
    "eof_mid_body": b"POST / HTTP/1.1\r\nContent-Length: 20\r\n\r\nshort",
    "eof_mid_head": b"GET / HTTP/1.1\r\nHost:",
}

RESPONSES = {
    "content_length": (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                       b"Content-Length: 13\r\n\r\n{\"ok\": true}\nLEFT"),
    "chunked_trailer": (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                        b"4;ext=1\r\ndata\r\n6\r\n: more\r\n0\r\nX-Trailer: t\r\n\r\nLEFT"),
    "sse_to_eof": (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                   b"Connection: close\r\n\r\ndata: a\n\ndata: [DONE]\n\n"),
    "torn_chunked": b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n9\r\nabc",
    "torn_length": b"HTTP/1.1 503 Service Unavailable\r\nContent-Length: 9\r\n\r\nabc",
    "bad_status": b"HTTP/1.1 abc Nope\r\n\r\n",
    "not_http": b"SSH-2.0-OpenSSH\r\n\r\n",
    "bad_chunk_size": b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
}


def _splits(data: bytes):
    yield [data]
    for cut in range(1, len(data)):
        yield [data[:cut], data[cut:]]


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_read_request_every_split_matches_jax(name):
    for pieces in _splits(REQUESTS[name]):
        got = _drive(tev, pieces, _two_requests)
        assert got == _drive(jev, pieces, _two_requests), pieces


@pytest.mark.parametrize("name", sorted(RESPONSES))
def test_upstream_response_every_split_matches_jax(name):
    for pieces in _splits(RESPONSES[name]):
        got = _drive(tev, pieces, _response)
        assert got == _drive(jev, pieces, _response), pieces


def test_sse_scanner_every_split_matches_jax():
    snap = base64.b64encode(bytes(range(40)))
    stream = (b"data: alpha\n\n: keepalive\n\nevent: dllama-ckpt\ndata: 13 " + snap
              + b"\n\ndata: \xce\xb2eta\n\ndata: [DONE]\n\ntrailing")
    for pieces in _splits(stream):
        t, j = tobs.SSEScanner(), jobs.SSEScanner()
        evs = [x for p in pieces for x in t.feed(p)]
        assert evs == [x for p in pieces for x in j.feed(p)]
        assert t.tail() == j.tail() == b"trailing"
        assert ([tobs.sse_event_fields(e) for e in evs]
                == [jobs.sse_event_fields(e) for e in evs])


_SSE_PARTS = st.sampled_from([b"data: a\n\n", b"\n", b"\n\n", b"data: [DONE]\n\n", b"x" * 70,
                              b"event: dllama-ckpt\ndata: 12 QUJD\n\n", b": ping\n\n", b"\r\n"])


@settings(max_examples=150, deadline=None)
@given(st.lists(_SSE_PARTS, max_size=14), st.lists(st.integers(0, 60), max_size=12))
def test_sse_scanner_any_chunking_matches_jax(parts, cuts):
    stream, pieces, at = b"".join(parts), [], 0
    for n in cuts:
        pieces.append(stream[at:at + n])
        at += n
    pieces.append(stream[at:])
    t, j = tobs.SSEScanner(), jobs.SSEScanner()
    assert [x for p in pieces for x in t.feed(p)] == [x for p in pieces for x in j.feed(p)]
    assert t.tail() == j.tail()
