"""Per-request lifecycle primitives for the serving stack: deadlines,
cancellation tokens, bounded admission, and a scheduler supervisor.

PR 1's continuous batcher made the server fast; this layer makes it bounded
under failure. Every way a request can end other than "finished" is a typed
:class:`LifecycleError` carrying the HTTP status the handler should speak
(429 queue overflow, 503 draining/scheduler-crash, 504 deadline), so no
client ever observes an unbounded wait:

* :class:`Deadline` — wall-clock budget from submit, enforced by the decode
  loops BETWEEN chunks (a row never holds its slot past one chunk after
  expiry).
* :class:`CancelToken` — cooperative cancel (client disconnect, shutdown);
  the scheduler releases a cancelled row's slot at the next chunk boundary.
* :class:`AdmissionGate` — bounded in-flight counter: overflow is rejected
  NOW with 429 + Retry-After instead of queuing unboundedly, and
  ``begin_drain`` flips the gate to 503 for SIGTERM graceful shutdown.
* :class:`Supervisor` — owns the scheduler thread: a crash runs the
  ``on_crash`` hook (fail in-flight slots 503) and restarts the loop, so one
  poisoned window can never leave every later ``submit()`` hanging on a dead
  daemon.
* :class:`KVBudget` — the batcher's KV admission accountant: per-bucket
  residency and token-slot reservations against the session's modeled HBM
  budget, published as gauges. In paged mode it additionally OWNS the page
  allocator (free list + per-page refcounts, ``attach_pages``) so page-level
  occupancy is serving-side truth.
"""

from __future__ import annotations

import threading
import time

from .. import observability
from ..analysis.sanitize import guarded_by
from ..runtime import paged_kv

# Module-level metric handles against the shared default registry: created at
# import so every series is visible on /metrics from the first scrape, not
# only after its first failure.
_REG = observability.default_registry()
_M_REJECTIONS = _REG.counter(
    "dllama_admission_rejections_total",
    "Requests rejected at the admission gate, by reason",
    ("reason",))
_M_CRASHES = _REG.counter(
    "dllama_scheduler_crashes_total",
    "Supervised scheduler thread crashes (each one restarts the loop)")
_M_DEADLINES = _REG.counter(
    "dllama_deadline_expirations_total",
    "Requests whose wall-clock budget (--request-timeout) expired")
_M_INFLIGHT = _REG.gauge(
    "dllama_inflight_requests",
    "Requests currently admitted past the gate")
_M_CLASS_INFLIGHT = _REG.gauge(
    "dllama_class_inflight",
    "Requests currently admitted past the gate, by SLO class",
    ("slo_class",))
_M_CLASS_REJECTIONS = _REG.counter(
    "dllama_class_rejections_total",
    "Requests rejected at the admission gate, by SLO class and reason",
    ("slo_class", "reason"))
_M_KV_RESERVED = _REG.gauge(
    "dllama_kv_tokens_reserved",
    "KV token-slots reserved against the session's modeled HBM budget")
_M_KV_BUDGET = _REG.gauge(
    "dllama_kv_tokens_budget",
    "The session's modeled HBM budget in KV token-slots (max_batch*seq_len)")
_M_KV_ROWS = _REG.gauge(
    "dllama_kv_bucket_rows",
    "Rows resident per KV bucket context length",
    ("bucket",))
_M_KV_PAGES = _REG.gauge(
    "dllama_kv_pages",
    "Paged-KV arena pages by state (free / cached / held / reserved)",
    ("state",))
_M_KV_PAGES_TOTAL = _REG.gauge(
    "dllama_kv_pages_total",
    "Usable pages in the paged-KV arena (scratch page excluded)")


class LifecycleError(RuntimeError):
    """A request ended by lifecycle policy rather than by decoding.

    ``http_status``/``retry_after_s`` tell the handler what to speak; the
    message is the client-facing error text.
    """

    http_status = 500
    retry_after_s: float = None


class QueueFull(LifecycleError):
    """Admission rejected: the bounded queue is at capacity (HTTP 429).

    With SLO classes the rejection is lane-scoped: ``slo_class`` names the
    lane that overflowed and ``retry_after_s`` is computed from THAT lane's
    service-time EWMA and depth, so a saturated batch lane tells its clients
    to back off for minutes while interactive clients keep sub-second
    retry hints."""

    http_status = 429

    def __init__(self, depth: int, capacity: int, retry_after_s: float,
                 slo_class: str = None):
        lane = f" in the {slo_class!r} lane" if slo_class else ""
        super().__init__(
            f"server at capacity ({depth}/{capacity} requests in flight"
            f"{lane}); retry later")
        self.retry_after_s = retry_after_s
        self.slo_class = slo_class


class ServerDraining(LifecycleError):
    """Admission rejected: the server is draining for shutdown (HTTP 503)."""

    http_status = 503
    retry_after_s = 30.0

    def __init__(self):
        super().__init__("server is draining for shutdown")


class SchedulerCrashed(LifecycleError):
    """The scheduler thread died with this request in flight (HTTP 503).
    The supervisor restarts the thread; the REQUEST is not retried — replay
    is the client's call, not the server's."""

    http_status = 503
    retry_after_s = 1.0

    def __init__(self, cause: BaseException):
        super().__init__(f"scheduler crashed mid-request: {cause!r}; "
                         "scheduler restarted, retry the request")
        self.cause = cause


class DeadlineExceeded(LifecycleError):
    """The request's wall-clock budget expired mid-decode (HTTP 504)."""

    http_status = 504

    def __init__(self, budget_s: float):
        super().__init__(
            f"request exceeded its {budget_s:.1f}s deadline (--request-"
            "timeout); partial output discarded, slot released")
        self.budget_s = budget_s
        _M_DEADLINES.inc()
        observability.flight_recorder().record(
            "deadline", budget_s=round(budget_s, 3))


class RequestCancelled(LifecycleError):
    """The client went away (or shutdown forced the row out); no response
    channel exists, the error just resolves the slot's waiter."""

    def __init__(self, reason: str):
        super().__init__(f"request cancelled: {reason}")
        self.reason = reason


class Deadline:
    """Wall-clock budget counted from construction (i.e. from submit)."""

    __slots__ = ("budget_s", "expires_at")

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.expires_at = time.monotonic() + budget_s

    @classmethod
    def start(cls, budget_s) -> "Deadline":
        """None/0/negative budget means no deadline."""
        return cls(budget_s) if budget_s and budget_s > 0 else None

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def error(self) -> DeadlineExceeded:
        return DeadlineExceeded(self.budget_s)


class CancelToken:
    """Cooperative cancellation flag, set once with a reason."""

    def __init__(self):
        self._event = threading.Event()
        self.reason: str = None

    def cancel(self, reason: str) -> None:
        if not self._event.is_set():
            self.reason = reason
            self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def error(self) -> RequestCancelled:
        return RequestCancelled(self.reason or "cancelled")


#: the SLO classes the server speaks. A request names its lane with the
#: ``serving/protocol.HDR_CLASS`` hop header; anything else is a 400,
#: never silently defaulted.
SLO_CLASSES = ("interactive", "batch")


class SLOClass:
    """Per-lane admission policy: queue depth, deadline, residency cap.

    ``depth`` bounds how many requests of this class may be in flight at
    once (<=0: inherit the gate's total capacity). ``deadline_s`` is the
    class's default wall-clock budget when the server has no global
    ``--request-timeout`` (<=0: none). ``max_resident`` caps how many
    decode-pool rows the class may hold resident at once (<=0: unbounded);
    the batcher enforces it at admission and it is what makes a batch lane
    *preemptible* — rows beyond interactive's needs are reclaimable.
    """

    __slots__ = ("name", "depth", "deadline_s", "max_resident",
                 "ttft_ms", "tpot_ms", "err_rate")

    def __init__(self, name: str, depth: int = 0, deadline_s: float = 0.0,
                 max_resident: int = 0, ttft_ms: float = 0.0,
                 tpot_ms: float = 0.0, err_rate: float = 0.0):
        self.name = name
        self.depth = int(depth)
        self.deadline_s = float(deadline_s)
        self.max_resident = int(max_resident)
        # burn-rate SLO targets (obsv.burnrate): p95 TTFT/TPOT in ms and
        # the error-fraction budget; 0 = no target, no alert series
        self.ttft_ms = float(ttft_ms)
        self.tpot_ms = float(tpot_ms)
        self.err_rate = float(err_rate)

    def to_dict(self) -> dict:
        return {"depth": self.depth, "deadline_s": self.deadline_s,
                "max_resident": self.max_resident,
                "ttft_ms": self.ttft_ms, "tpot_ms": self.tpot_ms,
                "err_rate": self.err_rate}


def parse_slo_classes(spec: str) -> dict:
    """Parse ``--slo-classes`` into {class_name: SLOClass}.

    Grammar (classes separated by ``;``)::

        interactive:depth=48,deadline=30,ttft=500;batch:depth=16,resident=2

    ``ttft=``/``tpot=`` (p95 targets in ms) and ``err=`` (error-fraction
    budget) are the burn-rate SLO targets the obsv alert engine evaluates;
    left unset (0) a signal simply has no alert. Every class in
    :data:`SLO_CLASSES` gets an entry (unnamed classes get defaults), so
    callers never KeyError on a valid class name."""
    classes = {name: SLOClass(name) for name in SLO_CLASSES}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition(":")
        name = name.strip()
        if name not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {name!r} (known: {SLO_CLASSES})")
        cls = classes[name]
        for kv in filter(None, (s.strip() for s in rest.split(","))):
            if "=" not in kv:
                raise ValueError(f"bad SLO option {kv!r} in {part!r}")
            k, v = (s.strip() for s in kv.split("=", 1))
            if k == "depth":
                cls.depth = int(v)
            elif k == "deadline":
                cls.deadline_s = float(v)
            elif k == "resident":
                cls.max_resident = int(v)
            elif k == "ttft":
                cls.ttft_ms = float(v)
            elif k == "tpot":
                cls.tpot_ms = float(v)
            elif k == "err":
                cls.err_rate = float(v)
            else:
                raise ValueError(
                    f"unknown SLO option {k!r} (want depth/deadline/"
                    "resident/ttft/tpot/err)")
    return classes


@guarded_by("_lock", "_inflight", "_draining", "_service_ewma_s",
            "_class_inflight", "_class_ewma_s")
class AdmissionGate:
    """Bounded in-flight request counter with drain support.

    ``acquire`` either admits (incrementing the in-flight count) or raises
    :class:`QueueFull` / :class:`ServerDraining` — it NEVER blocks, which is
    the whole point: backpressure is a fast typed rejection the client can
    act on, not an invisible queue. ``retry_after`` scales with how loaded
    the gate is, seeded by an EWMA of recent request service times.

    With ``classes`` (see :func:`parse_slo_classes`) the gate keeps one
    bounded lane per SLO class on top of the total capacity: a class whose
    lane is full 429s with a *class-scoped* Retry-After (that lane's EWMA x
    that lane's depth) even while the other lane still admits. The bare
    ``acquire()``/``release()`` calls keep their pre-class behavior (they
    ride the "interactive" lane), so single-class callers are untouched.
    """

    def __init__(self, capacity: int, flight=None, classes: dict = None):
        self.capacity = max(1, capacity)
        self.classes = classes if classes is not None else parse_slo_classes("")
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._service_ewma_s = 1.0  # optimistic prior; updated per release
        self._class_inflight = {name: 0 for name in self.classes}
        self._class_ewma_s = {name: 1.0 for name in self.classes}
        # set-once black box (observability.FlightRecorder); every admission
        # decision lands in its ring so a crash dump shows what the gate was
        # doing in the final seconds
        self._flight = flight if flight is not None \
            else observability.flight_recorder()

    @property
    def depth(self) -> int:
        return self._inflight

    def class_depths(self) -> dict:
        """{class: in-flight count} — the readiness probe's lane view."""
        with self._lock:
            return dict(self._class_inflight)

    def class_capacity(self, slo_class: str) -> int:
        """The lane's effective bound: its configured depth, else the
        gate's total capacity."""
        cls = self.classes.get(slo_class)
        return cls.depth if cls is not None and cls.depth > 0 \
            else self.capacity

    def deadline_for(self, slo_class: str) -> float:
        """The lane's default wall-clock budget (0.0: none configured)."""
        cls = self.classes.get(slo_class)
        return cls.deadline_s if cls is not None else 0.0

    @property
    def draining(self) -> bool:
        return self._draining

    def retry_after_s(self, slo_class: str = None) -> float:
        """Seconds a 429'd client should wait: one EWMA service time per
        queued request ahead of it, floored at 1s so clients never busy-spin.
        Class-scoped when ``slo_class`` names a lane — a saturated batch
        lane's backoff grows with *batch* service times, not the fleet's."""
        if slo_class in self._class_ewma_s:
            return max(1.0, self._class_ewma_s[slo_class]
                       * self._class_inflight[slo_class])
        return max(1.0, self._service_ewma_s * self._inflight)

    def acquire(self, slo_class: str = "interactive") -> float:
        """Admit one request into its class lane; returns its admit
        timestamp (pass back to ``release`` for the service-time EWMA)."""
        with self._lock:
            if self._draining:
                _M_REJECTIONS.inc(reason="draining")
                _M_CLASS_REJECTIONS.inc(slo_class=slo_class,
                                        reason="draining")
                self._flight.record("reject", reason="draining")
                raise ServerDraining()
            lane_cap = self.class_capacity(slo_class)
            lane_depth = self._class_inflight.get(slo_class, 0)
            if self._inflight >= self.capacity or lane_depth >= lane_cap:
                _M_REJECTIONS.inc(reason="queue_full")
                _M_CLASS_REJECTIONS.inc(slo_class=slo_class,
                                        reason="queue_full")
                self._flight.record("reject", reason="queue_full",
                                    depth=self._inflight,
                                    slo_class=slo_class)
                if lane_depth >= lane_cap:
                    raise QueueFull(lane_depth, lane_cap,
                                    self.retry_after_s(slo_class), slo_class)
                raise QueueFull(self._inflight, self.capacity,
                                self.retry_after_s())
            self._inflight += 1
            if slo_class in self._class_inflight:
                self._class_inflight[slo_class] += 1
                _M_CLASS_INFLIGHT.set(self._class_inflight[slo_class],
                                      slo_class=slo_class)
            _M_INFLIGHT.set(self._inflight)
            self._flight.record("admit", depth=self._inflight,
                                slo_class=slo_class)
            return time.monotonic()

    def release(self, admitted_at: float = None,
                slo_class: str = "interactive") -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            _M_INFLIGHT.set(self._inflight)
            if slo_class in self._class_inflight:
                self._class_inflight[slo_class] = max(
                    0, self._class_inflight[slo_class] - 1)
                _M_CLASS_INFLIGHT.set(self._class_inflight[slo_class],
                                      slo_class=slo_class)
            if admitted_at is not None:
                dt = max(0.0, time.monotonic() - admitted_at)
                self._service_ewma_s += 0.2 * (dt - self._service_ewma_s)
                if slo_class in self._class_ewma_s:
                    self._class_ewma_s[slo_class] += 0.2 * (
                        dt - self._class_ewma_s[slo_class])
            if self._inflight == 0:
                self._idle.notify_all()

    def begin_drain(self) -> None:
        """Stop admitting; in-flight requests keep running."""
        with self._lock:
            self._draining = True

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until nothing is in flight (or timeout). True when idle —
        the SIGTERM drain's exit condition."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
            return True


@guarded_by("_lock", "_reserved", "_rows", "pages")
class KVBudget:
    """Serving-side KV admission accountant for a BatchSession.

    The session enforces its own modeled HBM budget (``can_admit``); this
    mirror keeps the SERVER's view — reservations against the budget and
    rows resident per context bucket — and publishes it as gauges
    (``dllama_kv_tokens_reserved``, ``dllama_kv_bucket_rows{bucket}``), so
    an operator can see at a glance how many short rows the bucketed pools
    are packing into the slab the uniform layout spends on max_batch
    full-context rows. The runtime never imports serving: the session takes
    this object duck-typed via ``batch_session(kv_budget=...)``.

    Thread-safe; the scheduler thread mutates it while the metrics thread
    reads. All methods are O(1).
    """

    def __init__(self, total_tokens: int):
        self.total_tokens = max(1, int(total_tokens))
        self._lock = threading.Lock()
        self._reserved = 0
        self._rows: dict = {}  # bucket ctx -> resident rows
        self.pages: paged_kv.PageAllocator = None  # paged mode (attach_pages)
        _M_KV_BUDGET.set(self.total_tokens)
        _M_KV_RESERVED.set(0)

    def attach_pages(self, num_pages: int,
                     page_tokens: int) -> "paged_kv.PageAllocator":
        """Adopt a paged session's free list + refcounts: the allocator
        LIVES here so the serving accountant (and its gauges) always see
        page-level truth, while the runtime session drives it duck-typed.
        Called by BatchSession at construction in paged mode; a scheduler
        restart re-attaches a fresh allocator for its fresh arena."""
        with self._lock:
            self.pages = paged_kv.PageAllocator(
                num_pages, page_tokens, on_stats=self._publish_pages)
            self._publish_pages(self.pages.stats())
            return self.pages

    @staticmethod
    def _publish_pages(s: dict) -> None:
        _M_KV_PAGES_TOTAL.set(s["pages_total"])
        _M_KV_PAGES.set(s["pages_free"], state="free")
        _M_KV_PAGES.set(s["pages_cached"], state="cached")
        _M_KV_PAGES.set(s["pages_held"], state="held")
        _M_KV_PAGES.set(s["pages_reserved"], state="reserved")

    def page_stats(self) -> dict:
        """The attached allocator's occupancy snapshot ({} in slab modes)."""
        with self._lock:
            return self.pages.stats() if self.pages is not None else {}

    @property
    def reserved(self) -> int:
        return self._reserved

    def rows_by_bucket(self) -> dict:
        with self._lock:
            return dict(self._rows)

    def can_fit(self, tokens: int) -> bool:
        with self._lock:
            return self._reserved + tokens <= self.total_tokens

    def reserve(self, tokens: int) -> None:
        with self._lock:
            self._reserved += tokens
            _M_KV_RESERVED.set(self._reserved)

    def release(self, tokens: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - tokens)
            _M_KV_RESERVED.set(self._reserved)

    def place(self, bucket: int) -> None:
        with self._lock:
            self._rows[bucket] = self._rows.get(bucket, 0) + 1
            _M_KV_ROWS.set(self._rows[bucket], bucket=str(bucket))

    def unplace(self, bucket: int) -> None:
        with self._lock:
            self._rows[bucket] = max(0, self._rows.get(bucket, 0) - 1)
            _M_KV_ROWS.set(self._rows[bucket], bucket=str(bucket))

    def migrate(self, old_bucket: int, new_bucket: int) -> None:
        """A row moved buckets: occupancy shifts, reservation unchanged
        (admission reserved the worst-case bucket up front)."""
        with self._lock:
            self._rows[old_bucket] = max(0, self._rows.get(old_bucket, 0) - 1)
            self._rows[new_bucket] = self._rows.get(new_bucket, 0) + 1
            _M_KV_ROWS.set(self._rows[old_bucket], bucket=str(old_bucket))
            _M_KV_ROWS.set(self._rows[new_bucket], bucket=str(new_bucket))


@guarded_by("_lock", "_thread", "crash_count", "_stopped")
class Supervisor:
    """Owns a daemon thread running ``target`` and restarts it on crash.

    ``target`` is a long-running loop (the server scheduler); a normal
    return ends supervision (the drain path). An exception runs
    ``on_crash(exc)`` — which must fail the in-flight work so no waiter
    hangs — then restarts ``target`` after a short pause. ``alive`` is the
    readiness probe's scheduler-liveness answer.
    """

    def __init__(self, target, on_crash, name: str = "supervised",
                 restart_delay_s: float = 0.05, max_restarts: int = None):
        self._target = target
        self._on_crash = on_crash
        self._name = name
        self._restart_delay_s = restart_delay_s
        self._max_restarts = max_restarts  # None = unlimited
        self._lock = threading.Lock()
        self._thread: threading.Thread = None
        self.crash_count = 0
        self._stopped = False

    def start(self) -> None:
        """Idempotent: starts the loop thread on first call."""
        with self._lock:
            if self._thread is not None or self._stopped:
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=self._name)
            self._thread.start()

    def _run(self) -> None:
        while not self._stopped:
            try:
                self._target()
                return  # clean exit: drain finished
            except BaseException as e:  # noqa: BLE001 — supervision IS the catch
                with self._lock:
                    self.crash_count += 1
                    crashes = self.crash_count
                _M_CRASHES.inc()
                observability.flight_recorder().record(
                    "crash", target=self._name, error=repr(e)[:200],
                    crash_count=crashes)
                try:
                    self._on_crash(e)
                except Exception:  # noqa: BLE001 — crash hook must not kill
                    pass  # the supervisor; liveness beats accounting here
                if (self._max_restarts is not None
                        and crashes > self._max_restarts):
                    return
                time.sleep(self._restart_delay_s)

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self) -> None:
        """Stop restarting (the running iteration finishes on its own)."""
        with self._lock:
            self._stopped = True
