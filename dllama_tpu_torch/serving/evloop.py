"""A stdlib ``selectors`` event loop + HTTP plumbing for the fleet front
door.

The router's data plane (``serving/router.py``) runs on this loop: one
thread, non-blocking sockets, and one generator coroutine per connection.
Coroutines use ``yield from`` composition and suspend by yielding a
syscall object the loop interprets:

* ``_Wait(fd, events, deadline, edge)`` — park until the fd is ready or
  the deadline passes.  Expiry is delivered by **throwing**
  :class:`LoopTimeout` (an ``OSError`` subclass) into the coroutine, so
  every ported ``except OSError`` failure path treats a missed deadline
  exactly like a connect error — per-edge deadlines without new error
  plumbing.  ``edge`` names which budget expired (``header``,
  ``connect``, ``first_byte``, ``stall``, ``client_write``) for the
  error message.
* ``_Sleep(deadline)`` — a pure timer (the bench's drip writers).
* ``_Thread(fn)`` — run ``fn`` on a worker thread and resume with its
  result; the loop's blocking control-plane escapes (federation scrapes)
  ride this instead of stalling the data plane.

Deadline/readiness race: a task with BOTH pending bytes and an expired
deadline always gets the bytes — :func:`recv_some` tries the
non-blocking ``recv`` *before* parking, and the run loop delivers fd
readiness before timer expiry within one poll round.  That ordering is
what makes "``[DONE]`` arrived in the same read as the stall-timeout
expiry" a completed stream instead of a spurious failover (pinned by
tests/test_router_loop.py).

Backpressure is structural: a relay coroutine holds at most one chunk
(<= 64 KiB) in hand and cannot read more from its upstream until the
client write completes, so a slow client pauses its upstream read
instead of growing router RSS.  The client-write deadline is the hard
kill for clients stalled past the idle budget.

Only the handful of leaf primitives here (``recv_some`` / ``send_all`` /
``dial`` / ``_accept_nb`` / the pool's liveness peek) touch raw
socket calls; every socket is non-blocking, so they never block — they
yield to the loop on EAGAIN.  Everything above them is annotated
``@loop_callback`` and dllama-check's LOOP-001 forbids the blocking
shortlist inside those functions.

The port's copy of the JAX package's loop: stdlib-only, no torch, no jax.
"""

from __future__ import annotations

import errno
import heapq
import http.client
import itertools
import selectors
import socket
import sys
import threading
import time
from collections import deque

from dllama_tpu_torch.analysis.sanitize import guarded_by, loop_callback

#: per-recv read size — also the write-buffer bound per connection: a relay
#: never holds more than one chunk between upstream read and client write
CHUNK = 65536

#: largest request/response head the loop will buffer before giving up —
#: a slow-loris dribbling headers hits the header deadline first, but a
#: fast sender of endless headers must be bounded by size too
MAX_HEAD = 65536

#: grace window after a stall-budget expiry: one short extra read so bytes
#: already in flight at the expiry instant (the [DONE]-races-the-budget
#: edge) are delivered instead of discarded — a real stall just pays this
#: once before the failover
STALL_DRAIN_GRACE_S = 0.1


class LoopTimeout(OSError):
    """A per-edge deadline expired.  An ``OSError`` so the ported retry /
    failover paths (written for connect errors and torn reads) handle a
    missed deadline without new except clauses."""

    def __init__(self, edge: str):
        super().__init__(f"deadline expired at edge {edge!r}")
        self.edge = edge


class ProtocolError(OSError):
    """Malformed HTTP from a peer.  An ``OSError`` for the same reason as
    :class:`LoopTimeout`: a garbled upstream is a dead upstream."""


class HttpError(Exception):
    """A client request the server refuses with ``status`` (431/413/...)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


# ---------------------------------------------------------------------------
# syscalls
# ---------------------------------------------------------------------------

class _Wait:
    __slots__ = ("fd", "events", "deadline", "edge")

    def __init__(self, fd: int, events: int, deadline, edge: str):
        self.fd, self.events = fd, events
        self.deadline, self.edge = deadline, edge


class _Sleep:
    __slots__ = ("deadline",)

    def __init__(self, deadline: float):
        self.deadline = deadline


class _Thread:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


def sleep(seconds: float):
    """Coroutine: suspend for ``seconds`` without blocking the loop."""
    yield _Sleep(time.monotonic() + seconds)


def run_in_thread(fn):
    """Coroutine: run blocking ``fn`` on a worker thread, resume with its
    return value (or its exception re-raised here).  The escape hatch for
    control-plane work that legitimately blocks (federation scrapes)."""
    result = yield _Thread(fn)
    return result


class _Task:
    __slots__ = ("gen", "wait_fd", "wait_token", "done")

    def __init__(self, gen):
        self.gen = gen
        self.wait_fd = None    # fd currently registered with the selector
        self.wait_token = 0    # invalidates stale timer entries on resume
        self.done = False


@guarded_by("_calls_lock", "_calls")
class Loop:
    """The scheduler: a selector, a timer heap, a ready queue and a
    cross-thread call queue drained via a socketpair waker.  Everything
    except :meth:`call_threadsafe` / :meth:`stop` runs on the loop
    thread."""

    def __init__(self):
        self._selector = selectors.DefaultSelector()
        self._timers: list = []      # (deadline, seq, task, token, edge|None)
        self._seq = itertools.count()
        self._ready: deque = deque()  # (task, value, exc) to resume this tick
        self._tasks: set = set()
        self._stopping = False
        self._calls_lock = threading.Lock()
        self._calls: deque = deque()  # cross-thread callables
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._selector.register(self._waker_r, selectors.EVENT_READ, None)

    # -- cross-thread entry points ----------------------------------------

    def call_threadsafe(self, fn) -> None:
        """Queue ``fn`` to run on the loop thread and wake the selector."""
        with self._calls_lock:
            self._calls.append(fn)
        try:
            self._waker_w.send(b"\x00")
        except OSError:
            pass  # waker full (a wake is already pending) or loop gone

    def stop(self) -> None:
        self._stopping = True

    # -- scheduling --------------------------------------------------------

    def spawn(self, gen) -> _Task:
        """Register generator ``gen`` as a task and start it this tick."""
        task = _Task(gen)
        self._tasks.add(task)
        self._ready.append((task, None, None))
        return task

    def _finish(self, task: _Task) -> None:
        task.done = True
        if task.wait_fd is not None:
            try:
                self._selector.unregister(task.wait_fd)
            except (KeyError, ValueError, OSError):
                pass  # fd already closed/unregistered — nothing to undo
            task.wait_fd = None
        self._tasks.discard(task)

    def _step(self, task: _Task, value, exc) -> None:
        """Resume ``task`` once and act on the syscall it yields."""
        if task.done:
            return
        try:
            if exc is not None:
                syscall = task.gen.throw(exc)
            else:
                syscall = task.gen.send(value)
        except StopIteration:
            self._finish(task)
            return
        except OSError:
            # a connection task ending on socket error/timeout is the
            # normal teardown path, not a loop problem
            self._finish(task)
            return
        except Exception as e:  # a task bug must never kill the loop
            print(f"evloop: task crashed: {e!r}", file=sys.stderr)
            self._finish(task)
            return
        if isinstance(syscall, _Wait):
            task.wait_fd = syscall.fd
            try:
                self._selector.register(syscall.fd, syscall.events, task)
            except (KeyError, ValueError, OSError) as e:
                task.wait_fd = None
                self._ready.append((task, None,
                                    OSError(f"wait on dead fd: {e}")))
                return
            if syscall.deadline is not None:
                heapq.heappush(self._timers,
                               (syscall.deadline, next(self._seq), task,
                                task.wait_token, syscall.edge))
        elif isinstance(syscall, _Sleep):
            heapq.heappush(self._timers,
                           (syscall.deadline, next(self._seq), task,
                            task.wait_token, None))
        elif isinstance(syscall, _Thread):
            self._offload(task, syscall.fn)
        else:
            # bare `yield`: cooperative reschedule on the next tick
            self._ready.append((task, None, None))

    def _offload(self, task: _Task, fn) -> None:
        def runner():
            try:
                res, err = fn(), None
            except Exception as e:  # delivered into the coroutine below
                res, err = None, e
            self.call_threadsafe(lambda: self._step(task, res, err))
        threading.Thread(target=runner, daemon=True,
                         name="evloop-offload").start()

    # -- the run loop ------------------------------------------------------

    def _drain_calls(self) -> None:
        while True:
            with self._calls_lock:
                if not self._calls:
                    return
                fn = self._calls.popleft()
            fn()

    def _resume_timer(self, task: _Task, edge) -> None:
        if task.wait_fd is not None:
            try:
                self._selector.unregister(task.wait_fd)
            except (KeyError, ValueError, OSError):
                pass  # fd vanished with its socket — the throw below ends it
            task.wait_fd = None
        task.wait_token += 1
        if edge is None:
            self._step(task, None, None)        # sleep completed
        else:
            self._step(task, None, LoopTimeout(edge))

    def run(self) -> None:
        """Drive tasks until :meth:`stop`.  On exit every live task is
        closed (GeneratorExit runs its ``finally`` blocks, closing its
        sockets)."""
        try:
            while not self._stopping:
                while self._ready and not self._stopping:
                    task, value, exc = self._ready.popleft()
                    self._step(task, value, exc)
                if self._stopping:
                    break
                timeout = None
                if self._ready:
                    timeout = 0.0
                elif self._timers:
                    timeout = max(0.0,
                                  self._timers[0][0] - time.monotonic())
                events = self._selector.select(timeout)
                # fd readiness is delivered BEFORE timer expiry: bytes that
                # arrived in the same poll round as a deadline win the race
                for key, _mask in events:
                    if key.data is None:
                        try:
                            while self._waker_r.recv(4096):
                                pass
                        except OSError:
                            pass  # drained (EAGAIN) — the wake did its job
                        continue
                    task = key.data
                    try:
                        self._selector.unregister(key.fileobj)
                    except (KeyError, ValueError, OSError):
                        pass  # racing close; resuming the task is still right
                    task.wait_fd = None
                    task.wait_token += 1
                    self._step(task, None, None)
                now = time.monotonic()
                while self._timers and self._timers[0][0] <= now:
                    _dl, _seq, task, token, edge = heapq.heappop(self._timers)
                    if task.done or token != task.wait_token:
                        continue  # the wait this timer guarded already ended
                    self._resume_timer(task, edge)
                self._drain_calls()
        finally:
            for task in list(self._tasks):
                try:
                    task.gen.close()
                except Exception as e:  # a finally-block bug; keep closing
                    print(f"evloop: task close failed: {e!r}",
                          file=sys.stderr)
                self._finish(task)
            try:
                self._selector.unregister(self._waker_r)
            except (KeyError, ValueError, OSError):
                pass  # selector may already be torn down
            _close_quiet(self._waker_r)
            _close_quiet(self._waker_w)
            self._selector.close()


# ---------------------------------------------------------------------------
# non-blocking leaf primitives (the audited raw-socket surface; deliberately
# NOT @loop_callback — see the module docstring)
# ---------------------------------------------------------------------------

def _close_quiet(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass  # closing a dead socket is still closed


def _accept_nb(listen_sock):
    """One non-blocking accept: (sock, addr) or None when drained."""
    try:
        return listen_sock.accept()
    except (BlockingIOError, InterruptedError):
        return None


def recv_some(sock, deadline=None, edge: str = "read", n: int = CHUNK):
    """Coroutine: the next <= ``n`` bytes (b'' on EOF).  Tries the
    non-blocking recv FIRST, so already-delivered bytes beat an
    already-expired deadline."""
    while True:
        try:
            return sock.recv(n)
        except (BlockingIOError, InterruptedError):
            yield _Wait(sock.fileno(), selectors.EVENT_READ, deadline, edge)


def send_all(sock, data: bytes, deadline=None, edge: str = "client_write"):
    """Coroutine: write all of ``data``, parking on EAGAIN.  The deadline
    is the hard kill for peers that stop draining their socket."""
    view = memoryview(data)
    while view:
        try:
            sent = sock.send(view)
        except (BlockingIOError, InterruptedError):
            yield _Wait(sock.fileno(), selectors.EVENT_WRITE, deadline, edge)
            continue
        view = view[sent:]


def dial(addr, deadline=None, edge: str = "connect"):
    """Coroutine: a connected non-blocking TCP socket, or OSError /
    LoopTimeout(edge).  (Named ``dial``, not ``connect``: the blocking
    shortlist LOOP-001 enforces treats any ``connect(...)`` leaf as
    socket I/O, and this audited primitive is called FROM annotated
    callbacks.)"""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ok = False
    try:
        sock.setblocking(False)
        err = sock.connect_ex(addr)
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            raise OSError(err, f"connect to {addr}: {errno.errorcode.get(err, err)}")
        if err != 0:
            yield _Wait(sock.fileno(), selectors.EVENT_WRITE, deadline, edge)
            err = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err != 0:
                raise OSError(
                    err, f"connect to {addr}: {errno.errorcode.get(err, err)}")
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not TCP (tests may hand in socketpairs) — fine unbatched
        ok = True
        return sock
    finally:
        if not ok:
            _close_quiet(sock)


# ---------------------------------------------------------------------------
# server-side HTTP
# ---------------------------------------------------------------------------

class Request:
    """One parsed client request (headers lowercased)."""

    __slots__ = ("method", "path", "version", "headers", "body", "keep_alive")

    def __init__(self, method, path, version, headers, body):
        self.method, self.path, self.version = method, path, version
        self.headers, self.body = headers, body
        conn_tok = headers.get("connection", "").lower()
        if version == "HTTP/1.1":
            self.keep_alive = conn_tok != "close"
        else:
            self.keep_alive = conn_tok == "keep-alive"

    def header(self, name: str, default=None):
        return self.headers.get(name.lower(), default)


@loop_callback
def read_request(sock, buf: bytearray, header_deadline=None,
                 body_deadline=None, max_body: int = 16 * 1024 * 1024):
    """Coroutine: the next Request off one client connection.

    Returns None on clean EOF before any byte (keep-alive close).  A
    peer that dribbles slower than ``header_deadline`` gets
    LoopTimeout("header") — the slow-loris kill.  Raises HttpError for
    requests the caller should answer with a 4xx, ProtocolError for
    garbage not worth answering."""
    while True:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            break
        if len(buf) > MAX_HEAD:
            raise HttpError(431, "request head too large")
        data = yield from recv_some(sock, header_deadline, edge="header")
        if not data:
            if buf:
                raise ProtocolError("connection closed mid-request-head")
            return None
        buf += data
    head = bytes(buf[:head_end])
    del buf[:head_end + 4]
    lines = head.split(b"\r\n")
    parts = lines[0].decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise ProtocolError(f"bad request line {lines[0][:80]!r}")
    method, target, version = parts
    headers: dict = {}
    for raw in lines[1:]:
        name, sep, value = raw.partition(b":")
        if not sep:
            raise ProtocolError(f"bad header line {raw[:80]!r}")
        headers[name.decode("latin-1").strip().lower()] = (
            value.decode("latin-1").strip())
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise HttpError(411, "chunked request bodies not supported")
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise HttpError(400, "bad Content-Length")
    if length > max_body:
        raise HttpError(413, "request body too large")
    while len(buf) < length:
        data = yield from recv_some(sock, body_deadline or header_deadline,
                                    edge="header")
        if not data:
            raise ProtocolError("connection closed mid-request-body")
        buf += data
    body = bytes(buf[:length])
    del buf[:length]
    return Request(method, target, version, headers, body)


def response_bytes(status: int, headers: list, body: bytes = b"",
                   version: str = "HTTP/1.1") -> bytes:
    """One full HTTP response as bytes (headers is a list of (k, v) pairs
    so repeats — two Server-Timing lines — survive)."""
    reason = http.client.responses.get(status, "Unknown")
    lines = [f"{version} {status} {reason}"]
    for k, v in headers:
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


# ---------------------------------------------------------------------------
# loop-native upstream HTTP client
# ---------------------------------------------------------------------------

class Upstream:
    """One upstream connection: request writer + response-head parser.
    The read buffer lives here so a keep-alive reuse keeps leftover
    bytes with the socket they came from."""

    def __init__(self, sock, host: str, port: int):
        self.sock = sock
        self.host, self.port = host, port
        self.buf = bytearray()

    def close(self) -> None:
        _close_quiet(self.sock)

    @loop_callback
    def request(self, method: str, path: str, headers: dict,
                body: bytes = b"", deadline=None):
        """Coroutine: send one request head + body."""
        body = body or b""
        lines = [f"{method} {path} HTTP/1.1",
                 f"Host: {self.host}:{self.port}",
                 "Accept-Encoding: identity"]
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        lines.append(f"Content-Length: {len(body)}")
        data = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
        yield from send_all(self.sock, data, deadline, edge="connect")

    @loop_callback
    def get_response(self, deadline=None, edge: str = "first_byte"):
        """Coroutine: parse the response head; the deadline is the
        first-upstream-byte budget."""
        while True:
            head_end = self.buf.find(b"\r\n\r\n")
            if head_end >= 0:
                break
            if len(self.buf) > MAX_HEAD:
                raise ProtocolError("oversized upstream response head")
            data = yield from recv_some(self.sock, deadline, edge=edge)
            if not data:
                raise ProtocolError("upstream closed before response head")
            self.buf += data
        head = bytes(self.buf[:head_end])
        del self.buf[:head_end + 4]
        lines = head.split(b"\r\n")
        parts = lines[0].decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise ProtocolError(f"bad status line {lines[0][:80]!r}")
        try:
            status = int(parts[1])
        except ValueError:
            raise ProtocolError(f"bad status {parts[1]!r}")
        headers: dict = {}
        for raw in lines[1:]:
            name, sep, value = raw.partition(b":")
            if sep:
                headers[name.decode("latin-1").strip().lower()] = (
                    value.decode("latin-1").strip())
        return UpstreamResponse(self, parts[0], status, headers)


class UpstreamResponse:
    """Incremental body reader over an Upstream: Content-Length, chunked,
    or read-to-EOF framing, decided by the response head."""

    def __init__(self, up: Upstream, version: str, status: int,
                 headers: dict):
        self.up = up
        self.version = version
        self.status = status
        self.headers = headers
        te = headers.get("transfer-encoding", "")
        self._chunked = "chunked" in te.lower()
        self._remaining = None
        if not self._chunked:
            cl = headers.get("content-length")
            if cl is not None:
                try:
                    self._remaining = int(cl)
                except ValueError:
                    raise ProtocolError(f"bad upstream Content-Length {cl!r}")
        self._chunk_rem = 0
        self._chunk_state = "size"
        self._eof = self._remaining == 0
        self._clean = self._eof  # framing completed (vs torn/EOF-mode end)

    def getheader(self, name: str, default=None):
        return self.headers.get(name.lower(), default)

    @property
    def reusable(self) -> bool:
        """Safe to return this socket to the pool: the framed body was
        fully consumed and neither side asked to close."""
        return (self._clean
                and self.version == "HTTP/1.1"
                and "close" not in self.headers.get("connection", "").lower())

    def _take_buffered(self) -> bytes:
        """Decode whatever body bytes already sit in the read buffer."""
        buf = self.up.buf
        if self._eof:
            return b""
        if self._remaining is not None:
            take = min(len(buf), self._remaining)
            out = bytes(buf[:take])
            del buf[:take]
            self._remaining -= take
            if self._remaining == 0:
                self._eof = self._clean = True
            return out
        if self._chunked:
            return self._take_chunked()
        out = bytes(buf)  # EOF-delimited (SSE replicas send Connection: close)
        del buf[:]
        return out

    def _take_chunked(self) -> bytes:
        out = bytearray()
        buf = self.up.buf
        while not self._eof:
            if self._chunk_rem > 0:
                take = min(len(buf), self._chunk_rem)
                if not take:
                    break
                out += buf[:take]
                del buf[:take]
                self._chunk_rem -= take
                if self._chunk_rem == 0:
                    self._chunk_state = "crlf"
                continue
            if self._chunk_state == "crlf":
                if len(buf) < 2:
                    break
                del buf[:2]
                self._chunk_state = "size"
                continue
            if self._chunk_state == "size":
                nl = buf.find(b"\r\n")
                if nl < 0:
                    break
                size_field = bytes(buf[:nl]).split(b";", 1)[0].strip()
                del buf[:nl + 2]
                try:
                    size = int(size_field, 16)
                except ValueError:
                    raise ProtocolError(f"bad chunk size {size_field[:20]!r}")
                if size == 0:
                    self._chunk_state = "trailer"
                else:
                    self._chunk_rem = size
                continue
            # trailer: consume lines until the empty one ends the body
            nl = buf.find(b"\r\n")
            if nl < 0:
                break
            line = bytes(buf[:nl])
            del buf[:nl + 2]
            if not line:
                self._eof = self._clean = True
        return bytes(out)

    def try_read_now(self) -> bytes:
        """Non-blocking: decode pending bytes without suspending — the
        stall-expiry drain (data already delivered beats the budget)."""
        out = self._take_buffered()
        if out or self._eof:
            return out
        try:
            data = self.up.sock.recv(CHUNK)
        except (BlockingIOError, InterruptedError):
            return b""
        except OSError:
            self._eof = True
            return b""
        if not data:
            self._eof = True
            return b""
        self.up.buf += data
        return self._take_buffered()

    @loop_callback
    def read_some(self, deadline=None, edge: str = "stall"):
        """Coroutine: the next decoded body bytes; b'' at end of body.
        The deadline is the inter-byte budget (SSE stall detection)."""
        while True:
            out = self._take_buffered()
            if out or self._eof:
                return out
            data = yield from recv_some(self.up.sock, deadline, edge=edge)
            if not data:
                self._eof = True
                if self._remaining not in (None, 0) or (
                        self._chunked and not self._clean):
                    raise ProtocolError("upstream closed mid-body")
                return b""
            self.up.buf += data

    @loop_callback
    def read_all(self, deadline=None):
        """Coroutine: the whole remaining body."""
        parts = []
        while True:
            chunk = yield from self.read_some(deadline, edge="body")
            if not chunk:
                return b"".join(parts)
            parts.append(chunk)


class UpstreamPool:
    """Idle upstream sockets keyed by (host, port), loop-thread only.
    Only fully-drained framed responses return their socket here
    (:attr:`UpstreamResponse.reusable`); a liveness peek on checkout
    discards sockets the replica closed while idle."""

    def __init__(self, per_key: int = 8):
        self.per_key = per_key
        self._idle: dict = {}

    def get(self, host: str, port: int):
        bucket = self._idle.get((host, port))
        while bucket:
            sock = bucket.pop()
            try:
                pending = sock.recv(1, socket.MSG_PEEK)
            except (BlockingIOError, InterruptedError):
                return sock  # alive and quiet — the healthy idle state
            except OSError:
                _close_quiet(sock)
                continue
            # EOF (b"") or unsolicited bytes: either way not reusable
            _close_quiet(sock)
        return None

    def put(self, host: str, port: int, sock) -> None:
        bucket = self._idle.setdefault((host, port), [])
        if len(bucket) >= self.per_key:
            _close_quiet(sock)
            return
        bucket.append(sock)

    def close_all(self) -> None:
        for bucket in self._idle.values():
            for sock in bucket:
                _close_quiet(sock)
        self._idle.clear()


@loop_callback
def open_upstream(pool, host: str, port: int, deadline=None):
    """Coroutine: an Upstream from the pool or a fresh connect."""
    if pool is not None:
        sock = pool.get(host, port)
        if sock is not None:
            return Upstream(sock, host, port)
    sock = yield from dial((host, port), deadline, edge="connect")
    return Upstream(sock, host, port)


# ---------------------------------------------------------------------------
# the server shell
# ---------------------------------------------------------------------------

class EventLoopServer:
    """Drop-in replacement for the router's ThreadingHTTPServer surface:
    ``server_address`` / ``serve_forever()`` / ``shutdown()`` /
    ``server_close()`` — but one selectors loop instead of a thread per
    connection.

    ``conn_handler(server, sock, addr)`` returns the per-connection
    coroutine.  ``gate(server)`` runs at accept time BEFORE any
    connection state is allocated: returning a reason string sheds the
    connection (``shed_response`` is written best-effort, ``on_shed``
    counts it) — the ``--max-conns`` admission control and the
    ``conn_accept`` fault seam both live in the router's gate."""

    def __init__(self, address, conn_handler, gate=None,
                 shed_response: bytes = b"", on_shed=None,
                 backlog: int = 1024):
        self._handler = conn_handler
        self._gate = gate
        self._shed_response = shed_response
        self._on_shed = on_shed
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(address)
        self._sock.listen(backlog)
        self._sock.setblocking(False)
        self.server_address = self._sock.getsockname()
        self.loop = Loop()
        self.open_conns = 0  # loop-thread only (gauge reads tolerate tears)
        self._started = threading.Event()
        self._done = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self) -> None:
        self._started.set()
        try:
            self.loop.spawn(self._acceptor())
            self.loop.run()
        finally:
            _close_quiet(self._sock)
            self._done.set()

    def shutdown(self) -> None:
        """Stop the loop from any thread; waits for serve_forever to
        return (in-flight connection tasks are closed, their finally
        blocks shut their sockets)."""
        self.loop.call_threadsafe(self.loop.stop)
        if self._started.is_set():
            self._done.wait(timeout=10.0)

    def server_close(self) -> None:
        _close_quiet(self._sock)

    # -- accept path -------------------------------------------------------

    def _shed(self, sock, reason: str) -> None:
        """Refuse one connection before allocating state: best-effort
        canned response (it fits any socket buffer), close, count."""
        if self._on_shed is not None:
            self._on_shed(reason)
        try:
            sock.send(self._shed_response)
        except OSError:
            pass  # the shed client gets a bare close instead — still shed
        _close_quiet(sock)

    @loop_callback
    def _acceptor(self):
        while True:
            yield _Wait(self._sock.fileno(), selectors.EVENT_READ, None,
                        "accept")
            while True:
                pair = _accept_nb(self._sock)
                if pair is None:
                    break
                sock, addr = pair
                sock.setblocking(False)
                try:
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass  # non-TCP test sockets — latency hint only
                reason = self._gate(self) if self._gate is not None else None
                if reason:
                    self._shed(sock, reason)
                    continue
                self.open_conns += 1
                self.loop.spawn(self._conn_task(sock, addr))

    @loop_callback
    def _conn_task(self, sock, addr):
        try:
            yield from self._handler(self, sock, addr)
        finally:
            self.open_conns -= 1
            _close_quiet(sock)
