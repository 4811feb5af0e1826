"""Runtime concurrency sanitizer + the ``guarded_by`` annotation convention.

Two consumers share the annotations declared here:

* the JAX package's **static analyzer** (``python -m dllama_tpu.analysis``,
  which scans that package only) reads the
  ``@guarded_by(...)`` / ``guard_globals(...)`` calls from the AST and proves
  every write to an annotated attribute happens under ``with self.<lock>`` —
  lexically or via an always-called-under-lock helper (rule LOCK-001 and
  friends, interprocedural since dllama-check v2);
* the **runtime sanitizer**, enabled by ``DLLAMA_SANITIZE=1``, instruments the
  annotated classes at import time: each declared lock is replaced by a
  :class:`LockWitness` that records per-thread acquisition order into a global
  lock-order graph (cycle => :class:`LockOrderError`), ``__setattr__`` is
  wrapped to verify the declared lock is held whenever a guarded field is
  rebound (:class:`UnguardedWriteError`), and classes annotated with
  :func:`check_invariants` auto-run their invariant oracle after every
  mutating op (how ``PageAllocator.check()`` runs after every alloc/ref/unref
  in the sanitized CI lane).

When ``DLLAMA_SANITIZE`` is unset the decorators only attach metadata
(``__guarded_fields__`` / ``__invariant_check__``) and return the class
object unchanged — no wrapper enters the import path, no per-call overhead
exists (tests/test_analysis.py asserts the lock is a plain ``_thread.lock``
and ``__init__``/``__setattr__`` are untouched).

Known limits, by design:

* only **writes** (attribute rebinding) are checked at runtime; in-place
  container mutation (``self._rows[k] = v``) bypasses ``__setattr__`` and is
  covered by the static pass instead;
* a ``threading.Condition`` built in ``__init__`` on a declared lock is
  retargeted to the witness after instrumentation, and the witness supplies
  ``_release_save``/``_acquire_restore`` — so ownership bookkeeping is
  **exact** across ``Condition.wait`` (the witness releases and reacquires
  with the condition; a guarded write right after ``wait()`` is correctly
  seen as guarded).  A condition constructed *after* ``__init__``, or on a
  lock not declared via ``guarded_by``, stays raw and is best-effort;
* lock-order nodes are keyed ``ClassName.<attr>`` across classes and
  ``ClassName.<attr>#<instance-serial>`` within a class, so two instances
  of the same class acquired in opposite orders IS a reported inversion;
  re-entrant re-acquisition of a witness already on the thread's stack is
  excluded by identity, never by name.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading

ENV_VAR = "DLLAMA_SANITIZE"


def enabled() -> bool:
    """Live read of the env switch (the module freezes it at import)."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


#: frozen at import time: annotated classes are instrumented at class-creation
#: (decoration) time, so flipping the env var after import has no effect.
#: Tests monkeypatch this before defining fixture classes.
_ENABLED = enabled()


class SanitizerError(AssertionError):
    """Base for sanitizer reports. An AssertionError subclass so the chaos
    suites fail loudly under ``DLLAMA_SANITIZE=1`` without new plumbing."""


class LockOrderError(SanitizerError):
    """Two locks were acquired in both orders somewhere in the process."""


class UnguardedWriteError(SanitizerError):
    """A ``guarded_by``-annotated field was rebound without its lock held."""


# ---------------------------------------------------------------------------
# lock-order graph (global, process-wide)
# ---------------------------------------------------------------------------

_order_lock = threading.Lock()
#: directed edges: lock name held -> lock name acquired while held
_order_edges: dict = {}
#: (src, dst) -> first-seen stack hint (kept tiny: just thread name)
_tls = threading.local()


def reset_order_graph() -> None:
    """Drop all recorded acquisition edges (test isolation)."""
    with _order_lock:
        _order_edges.clear()


def order_edges() -> dict:
    """Snapshot of the acquisition graph {src: set(dst)} (introspection)."""
    with _order_lock:
        return {k: set(v) for k, v in _order_edges.items()}


def _find_path(graph: dict, start: str, goal: str) -> list | None:
    """DFS path start -> goal through ``graph`` (caller holds _order_lock)."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == goal:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in graph.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _record_acquire(witness: "LockWitness") -> None:
    stack = _held_stack()
    # re-entrant re-acquisition (RLock held lower in the stack) records no
    # edge: by identity, so two same-class instances are never mistaken for
    # re-entrancy
    if stack and not any(w is witness for w in stack):
        top = stack[-1]
        if top.name != witness.name:
            src, dst = top.name, witness.name          # cross-class node
        else:
            src, dst = top.iname, witness.iname        # per-instance node
        with _order_lock:
            edges = _order_edges.setdefault(src, set())
            if dst not in edges:
                edges.add(dst)
                # adding src->new: a pre-existing path new->...->src
                # closes a cycle
                path = _find_path(_order_edges, dst, src)
                if path is not None:
                    cycle = " -> ".join(path + [dst])
                    raise LockOrderError(
                        f"lock-order inversion: acquiring "
                        f"{dst!r} while holding {src!r}, but the "
                        f"process has also seen {cycle}")
    stack.append(witness)


def _record_release(witness: "LockWitness") -> None:
    stack = getattr(_tls, "stack", None) or []
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is witness:
            del stack[i]
            break


#: monotonically increasing witness serial: per-instance lock-order nodes
#: are named ``ClassName.<attr>#<serial>``
_witness_serial = itertools.count(1)


class LockWitness:
    """Wraps a Lock/RLock; delegates acquire/release to the raw lock (so a
    ``threading.Condition`` built on the same raw lock stays correct) while
    recording ownership and acquisition order."""

    __slots__ = ("raw", "name", "iname", "_owner", "_count")

    def __init__(self, raw, name: str):
        self.raw = raw
        self.name = name
        self.iname = f"{name}#{next(_witness_serial)}"
        self._owner = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self.raw.acquire(blocking, timeout)
        if ok:
            try:
                # only the holding thread mutates these: serialized by raw
                _record_acquire(self)
            except SanitizerError:
                self.raw.release()  # don't leak the raw lock on report
                raise
            self._owner = threading.get_ident()
            self._count += 1
        return ok

    def release(self):
        self._count -= 1
        if self._count <= 0:
            self._owner = None
            self._count = 0
        _record_release(self)
        self.raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    # Condition() probes these on its lock argument
    def _is_owned(self):
        owned = getattr(self.raw, "_is_owned", None)
        if owned is not None:
            return owned()
        return self.held_by_me()

    # Condition.wait() delegates these when its lock provides them: the
    # witness releases (bookkeeping included) around the wait and restores
    # after, keeping ownership tracking exact across waits.
    def _release_save(self):
        saved = self._count
        self._owner = None
        self._count = 0
        _record_release(self)
        inner = getattr(self.raw, "_release_save", None)
        if inner is not None:  # RLock: drop every recursion level at once
            return (inner(), saved)
        self.raw.release()
        return (None, saved)

    def _acquire_restore(self, state):
        raw_state, saved = state
        inner = getattr(self.raw, "_acquire_restore", None)
        if inner is not None:
            inner(raw_state)
        else:
            self.raw.acquire()
        try:
            _record_acquire(self)
        except SanitizerError:
            self.raw.release()
            raise
        self._owner = threading.get_ident()
        self._count = max(1, saved)

    def locked(self):
        return self.raw.locked()

    def __repr__(self):
        return f"<LockWitness {self.name} raw={self.raw!r}>"


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------

def guarded_by(lock: str | None, *fields: str):
    """Class decorator: declare ``fields`` as shared state guarded by the
    instance lock attribute ``lock`` (e.g. ``"_lock"``).

    ``lock=None`` declares **external serialization**: the class has no lock
    of its own and every mutation must come through a single serialized owner
    (``PageAllocator`` under ``KVBudget``). The static pass then forbids
    direct field writes from outside the class (LOCK-003); the runtime half
    relies on :func:`check_invariants` instead of a witness.

    With ``DLLAMA_SANITIZE`` unset this only records metadata on the class —
    ``__init__`` / ``__setattr__`` are returned untouched.
    """
    def deco(cls):
        guards = dict(getattr(cls, "__guarded_fields__", {}))  # inherit
        for f in fields:
            guards[f] = lock
        cls.__guarded_fields__ = guards
        if _ENABLED and lock is not None:
            _instrument(cls)
        return cls
    return deco


def guard_globals(lock: str, *names: str) -> None:
    """Declare module globals ``names`` guarded by the module-level lock
    ``lock``. Static-analysis metadata only (rule LOCK-004): module globals
    cannot be instrumented without a module ``__setattr__`` hook, and the
    annotated paths are cold."""
    return None


def loop_callback(fn):
    """Annotate ``fn`` as an event-loop callback/coroutine: it runs on the
    single ``selectors`` loop thread (``serving/evloop.py``), where ANY
    blocking call stalls every connection the process is carrying — one
    ``time.sleep`` in a handler is a fleet-wide latency spike.

    dllama-check's LOOP-001 statically forbids the blocking shortlist
    (blocking ``socket.recv/send/connect/accept``, ``time.sleep``,
    no-timeout ``Queue.get``/``.join``, ``conn.getresponse``/``urlopen``)
    inside annotated functions, including their nested ``def``s. The
    audited non-blocking leaf primitives in evloop.py stay UNannotated —
    they are the few lines allowed to touch raw socket calls, and they
    never block (every socket is non-blocking; EAGAIN yields to the loop).

    Metadata-only: returns ``fn`` unchanged (generator-ness preserved)."""
    fn.__loop_callback__ = True
    return fn


def check_invariants(check_method: str, *mutators: str):
    """Class decorator: under ``DLLAMA_SANITIZE=1`` run ``check_method`` after
    every listed mutating method, so the chaos/paged suites execute the
    invariant oracle at every step instead of only where tests remembered to
    call it. Metadata-only (zero wrappers) when the sanitizer is off."""
    def deco(cls):
        cls.__invariant_check__ = (check_method, tuple(mutators))
        if _ENABLED:
            for m in mutators:
                orig = getattr(cls, m)

                def _wrap(orig):
                    @functools.wraps(orig)
                    def run(self, *a, **k):
                        out = orig(self, *a, **k)
                        getattr(self, check_method)()
                        return out
                    return run
                setattr(cls, m, _wrap(orig))
        return cls
    return deco


def _instrument(cls) -> None:
    """Swap declared locks for witnesses post-__init__ and verify guarded
    rebinds hold their lock. Annotated classes must be plain (no __slots__)."""
    guards = cls.__guarded_fields__
    lock_attrs = sorted({l for l in guards.values() if l is not None})
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def init(self, *a, **k):
        object.__setattr__(self, "_dllama_sanitize_ready", False)
        orig_init(self, *a, **k)
        for lattr in lock_attrs:
            raw = getattr(self, lattr, None)
            if raw is not None and not isinstance(raw, LockWitness):
                object.__setattr__(
                    self, lattr,
                    LockWitness(raw, f"{type(self).__name__}.{lattr}"))
        # a Condition built in __init__ on a now-swapped lock still holds
        # the RAW lock: retarget it onto the witness so wait()'s release/
        # reacquire goes through the witness's bookkeeping (exact ownership
        # across Condition.wait, see module docstring)
        for val in list(vars(self).values()):
            if not isinstance(val, threading.Condition):
                continue
            for lattr in lock_attrs:
                w = getattr(self, lattr, None)
                if isinstance(w, LockWitness) and val._lock is w.raw:
                    val._lock = w
                    val.acquire = w.acquire
                    val.release = w.release
                    val._is_owned = w._is_owned
                    val._release_save = w._release_save
                    val._acquire_restore = w._acquire_restore
                    break
        object.__setattr__(self, "_dllama_sanitize_ready", True)

    cls.__init__ = init
    orig_setattr = cls.__setattr__

    def setattr_(self, name, value):
        lattr = guards.get(name)
        if (lattr is not None
                and self.__dict__.get("_dllama_sanitize_ready", False)):
            w = getattr(self, lattr, None)
            if isinstance(w, LockWitness) and not w.held_by_me():
                raise UnguardedWriteError(
                    f"write to {type(self).__name__}.{name} without "
                    f"{lattr} held (declared guarded_by({lattr!r}))")
        orig_setattr(self, name, value)

    cls.__setattr__ = setattr_
