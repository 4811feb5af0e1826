"""OpenAI-compatible HTTP API server on the port's engine.

The port of the JAX package's ``serving/api_server.py``, the counterpart of
the reference `dllama-api` app
(`distributed-llama/src/apps/dllama-api/dllama-api.cpp`):

* ``POST /v1/chat/completions`` — messages + ``temperature`` / ``top_p`` /
  ``seed`` / ``max_tokens`` / ``stop`` / ``stream`` (SSE ``data:`` chunks
  terminated by ``[DONE]``), matching the reference's handled params
  (`dllama-api.cpp:202-314`).
* ``GET /v1/models`` — the single loaded model (`dllama-api.cpp:316-322`).

Design differences, all deliberate:

* Requests are parsed by the stdlib ``http.server`` with proper
  Content-Length framing — the reference's single-``recv`` parse can truncate
  large bodies (`distributed-llama/src/socket.cpp:309-339`, a SURVEY.md §7
  quirk we do not replicate).
* Per-request sampler settings are device values that the captured decode
  step reads (``runtime.graphs.StepGraph.load``), so every request replays
  the same CUDA graphs regardless of its temperature/top_p/seed.
* Stop sequences use an incremental detector that withholds only the bytes
  that could still begin a stop string, instead of re-scanning the last 8
  pieces every token (`dllama-api.cpp:264-299`).

Like the reference, one request is served at a time (the engine owns one KV
cache); concurrent connections queue on a lock rather than corrupting state.
Every call that touches the card runs under ``ServerState.lock``, from a
handler thread (the solo path) or the batcher's scheduler thread: a CUDA
graph capture fails if another thread calls into CUDA while it runs.
``/health``, ``/ready``, ``/stats`` and ``/metrics`` read host mirrors only.

Not ported yet, and refused when the server starts (:func:`unsupported`):
bucketed KV slot pools (``--kv-buckets 1`` with ``--batch-window > 0``) and
paged KV (``--kv-pages``, with the ``--role prefill|decode`` migration
endpoints and mid-stream checkpoints, which only the paged pool serves).
Their code paths are kept as the JAX package has them; without a paged pool
the KV endpoints answer 400 as the reference's do.
"""

from __future__ import annotations

import base64
import codecs
import itertools
import json
import os
import queue as queue_mod
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dllama_tpu_torch import faults, observability
from dllama_tpu_torch.analysis.sanitize import guarded_by
from dllama_tpu_torch.observability import RequestTrace
from dllama_tpu_torch.obsv import BurnRateEngine, Sampler, TimeSeriesStore
from dllama_tpu_torch.obsv.timeseries import parse_window
from dllama_tpu_torch.runtime.generate import NumericHealthError
from dllama_tpu_torch.runtime.sampler import SamplerConfig
from dllama_tpu_torch.serving import kv_transfer
from dllama_tpu_torch.serving.lifecycle import (
    AdmissionGate,
    CancelToken,
    Deadline,
    DeadlineExceeded,
    KVBudget,
    LifecycleError,
    SchedulerCrashed,
    SLO_CLASSES,
    Supervisor,
    parse_slo_classes,
)
from dllama_tpu_torch.serving.protocol import (HDR_CKPT, HDR_CKPT_WIRE, HDR_CLASS,
                                         HDR_PARENT_SPAN, HDR_REQUEST_ID,
                                         HDR_RESUME_OFFSET,
                                         HDR_SERVER_TIMING, SSE_EVENT_CKPT)
from dllama_tpu_torch.serving.templates import render_llama2_turn, render_llama3_chat

#: the checkpoint control frame's prefix, derived from the registered event
#: name so emitter and scanner can never drift
_SSE_CKPT_PREFIX = b"event: " + SSE_EVENT_CKPT.encode() + b"\ndata: "


class StopDetector:
    """Incremental stop-string scanner for a streamed byte flow.

    ``feed`` returns (text_safe_to_emit, stopped). Bytes that could be the
    start of a stop sequence are withheld until disambiguated, so a stop
    string spanning two tokens is still caught and never leaks downstream.
    """

    def __init__(self, stops: list):
        self.stops = [s for s in stops if s]
        self.hold = ""  # tail that may be a stop-string prefix
        self.stopped = False

    def _partial_len(self, text: str) -> int:
        """Length of the longest tail of ``text`` that prefixes any stop."""
        best = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if s.startswith(text[-k:]):
                    best = max(best, k)
                    break
        return best

    def feed(self, piece: str) -> tuple:
        if self.stopped:
            return "", True
        text = self.hold + piece
        # earliest occurrence across ALL stops wins (OpenAI semantics), not
        # first stop in list order
        hits = [i for i in (text.find(s) for s in self.stops) if i != -1]
        if hits:
            self.stopped = True
            self.hold = ""
            return text[: min(hits)], True
        k = self._partial_len(text)
        self.hold = text[-k:] if k else ""
        return text[: len(text) - k], False

    def flush(self) -> str:
        out, self.hold = self.hold, ""
        return out

    def state(self) -> dict:
        """Scanback state for the kv_transfer v2 header — what a
        stop-string session must carry to migrate/resume without leaking
        (or double-emitting) a held stop-prefix tail."""
        return {"stops": list(self.stops), "hold": self.hold,
                "stopped": self.stopped}

    @classmethod
    def from_state(cls, state: dict) -> "StopDetector":
        d = cls([str(s) for s in state.get("stops", [])])
        d.hold = str(state.get("hold", ""))
        d.stopped = bool(state.get("stopped", False))
        return d


def unsupported(batch_window_ms: float = 0.0, kv_buckets: int = 1, kv_pages: int = 0,
                role: str = "both"):
    """Why the port cannot serve this configuration yet (None when it can).
    ``cli serve`` asks before it loads the model and :class:`ServerState`
    refuses with NotImplementedError; nothing falls back to another mode."""
    if kv_pages > 0:
        return ("paged KV (--kv-pages) is not ported yet (ROADMAP Queue 1, item 6); "
                "pass --kv-pages 0")
    if role in ("prefill", "decode"):
        return (f"--role {role} needs paged KV, which is not ported yet (ROADMAP Queue 1, "
                "item 6); pass --role both")
    if batch_window_ms > 0 and kv_buckets:
        return ("bucketed KV slot pools (--kv-buckets 1 with --batch-window > 0) are not "
                "ported yet (ROADMAP Queue 1, item 5); pass --kv-buckets 0 for the "
                "uniform pool")
    return None


def padded_batch(prompts: list, row_steps: list) -> tuple:
    """Pad a prompt batch to the next power of two with dummy [0] rows of
    budget 1 (dropped by the caller): distinct request counts reuse a
    handful of batch sizes instead of one per request count."""
    b = 1 << (len(prompts) - 1).bit_length()
    pad = b - len(prompts)
    return prompts + [[0]] * pad, row_steps + [1] * pad


def decode_token_row(tok, prev: int, row: list, stop_ids: tuple,
                     stops: list) -> tuple:
    """Token ids -> (text, finish_reason, tokens_consumed) with the same
    stop-token / stop-string / dangling-UTF-8 semantics as the streaming
    loop. Shared by every batched response path (GreedyBatcher, `n`)."""
    detector = StopDetector(stops)
    utf8 = codecs.getincrementaldecoder("utf-8")("replace")
    text_parts: list = []
    finish, n_gen = "length", 0
    for t in row:
        n_gen += 1
        if t in stop_ids:
            finish = "stop"
            break
        piece = utf8.decode(tok.decode_piece(prev, t))
        prev = t
        out, hit = detector.feed(piece)
        if out:
            text_parts.append(out)
        if hit:
            finish = "stop"
            break
    if not detector.stopped:
        tail = detector.flush() + utf8.decode(b"", True)
        if tail:
            text_parts.append(tail)
    return "".join(text_parts), finish, n_gen


@guarded_by("_lock", "_supervisor", "_window", "_active_sess", "_keep_sess",
            "_class_stats")
class Batcher:
    """CONTINUOUS batching scheduler: concurrent completions — greedy AND
    sampled, non-streaming AND streaming — share one resident slot-pool
    decode (``Engine.batch_session``). A dedicated scheduler thread drains
    an arrival queue and admits requests into free cache slots BETWEEN fused
    decode chunks, so a request arriving mid-decode starts after at most one
    chunk (~chunk tokens) instead of waiting for the whole running batch to
    drain, and a finished row's slot is handed to the next waiter the moment
    it stops — the static-window pathology (a long row holding K idle slots
    hostage) is gone. Every row runs its own generator and settings, so at
    a fixed pool size greedy rows AND sampled rows emit, bit for bit, what
    they would emit admitted into an empty pool with the same
    SamplerConfig — WHENEVER they were admitted (a batched row agrees with
    its solo run within the decode-step tolerance: the kernels sum B rows
    in another order than one). The reference serves strictly one request
    at a time (`distributed-llama/src/apps/dllama-api/dllama-api.cpp:324-355`).

    Streaming rows consume a per-slot queue fed from the scheduler loop:
    tokens arrive in fused-chunk bursts (``--batch-chunk`` tokens per
    dispatch) rather than one SSE event per token — the granularity cost of
    sharing one device program across the pool.

    Two special cases keep their faster paths: a batch of ONE delegates to
    the solo engine path (prefix-session KV reuse, per-token streaming —
    _serve_solo), and an all-greedy window on a --spec-draft server runs the
    batched speculative verify (_serve_spec) when it fits the pool at once —
    speculation's drafting arithmetic assumes a fixed row set, so it runs
    run-to-completion; overflow and mixed windows take the continuous path.

    KV-reuse trade, explicitly: pooled rows (>= 2 concurrent) neither claim
    nor store prefix sessions (extracting per-row sessions from the pool
    cache would pin max_batch full-context KV caches in HBM — the session
    cache's budget is ~2). So under SUSTAINED concurrency a multi-turn chat
    re-prefills its history each turn; that is the deliberate price for
    sharing every decode weight stream, and prefill is the cheap
    (tensor-core-bound, bucketed) phase. The zero/low-concurrency cases keep full
    reuse: prompts extending a cached session route solo at the gate, and
    singletons delegate to _serve_solo.
    """

    class _Slot:
        __slots__ = ("prompt", "steps", "sampler", "tokens", "error", "done",
                     "queue", "deadline", "cancel", "trace", "kind", "snap",
                     "export", "ckpt_every", "since_ckpt", "slo_class",
                     "preempted")

        def __init__(self, prompt, steps, sampler, streaming: bool,
                     deadline=None, cancel=None, trace=None,
                     kind: str = "completion", snap=None,
                     ckpt_every: int = 0, slo_class: str = "interactive"):
            self.prompt, self.steps, self.sampler = prompt, steps, sampler
            self.tokens = None
            self.error = None
            self.done = threading.Event()
            #: SLO lane ("interactive"/"batch"): drives lane ordering at
            #: admission and marks batch rows preemptible
            self.slo_class = slo_class
            #: True while this row sits in the scheduler's preempted
            #: parking lot (exported at a chunk boundary to make room for
            #: interactive work; re-admitted via admit_from_export)
            self.preempted = False
            #: disaggregation job kind: "completion" (the normal request),
            #: "prefill" (admit + first chunk, then export the row's KV
            #: pages for migration) or "import" (admit a row warm from a
            #: sibling replica's export snapshot and continue its decode)
            self.kind = kind
            #: decoded kv_transfer snapshot (kind "import" only)
            self.snap = snap
            #: export_row snapshot (kind "prefill", when the row migrated
            #: instead of finishing inside its first chunk)
            self.export = None
            #: mid-stream failover: checkpoint this streaming row every N
            #: emitted tokens (0 = off). Token-count based, so the ckpt
            #: schedule is deterministic across identical greedy runs.
            self.ckpt_every = int(ckpt_every) if streaming else 0
            self.since_ckpt = 0
            # streaming protocol: list-of-token-ids items, then exactly one
            # terminal item — None (clean end) or an Exception
            self.queue = queue_mod.Queue() if streaming else None
            #: lifecycle.Deadline — wall-clock budget from submit, checked
            #: by the scheduler BETWEEN chunks (and between solo tokens)
            self.deadline = deadline
            #: lifecycle.CancelToken — set by the SSE writer when the client
            #: socket dies; the scheduler releases the row's slot at the
            #: next chunk boundary instead of decoding for a dead socket
            self.cancel = cancel
            #: observability.RequestTrace — the scheduler marks routing
            #: (mark_start: which path served this request), prefill and
            #: token times on it; the HTTP handler owns emission
            self.trace = trace

        def mark_start(self, path: str) -> None:
            if self.trace is not None:
                self.trace.mark_start(path)

        def mark_prefill(self, ms: float) -> None:
            if self.trace is not None:
                self.trace.mark_prefill(ms)

        def mark_prefill_chunk(self, t_begin: float, t_end: float) -> None:
            if self.trace is not None:
                self.trace.mark_prefill_chunk(t_begin, t_end)

        def mark_token(self) -> None:
            if self.trace is not None:
                self.trace.mark_token()

        def lifecycle_error(self):
            """None, or the typed error that should resolve this request
            NOW (cancellation outranks deadline: a dead client's row frees
            its slot whatever its remaining budget)."""
            if self.cancel is not None and self.cancel.cancelled:
                return self.cancel.error()
            if self.deadline is not None and self.deadline.expired():
                return self.deadline.error()
            return None

    #: extra client-side wait past a slot's deadline before the HTTP thread
    #: gives up on the scheduler resolving it (a wedged device dispatch must
    #: not hang the connection forever — the chaos suite's no-hang bound)
    DEADLINE_GRACE_S = 5.0

    def __init__(self, state, window_ms: float = 15.0, max_batch: int = 8,
                 chunk: int = 8, prefill_chunk: int = -1,
                 kv_buckets: bool = True, kv_bucket_min: int = 0,
                 kv_pages: int = 0, slo_classes: dict = None):
        self.state = state
        #: {name: lifecycle.SLOClass} — per-lane admission order and
        #: residency caps (see _serve_continuous's lane-aware admission)
        self.slo_classes = (slo_classes if slo_classes is not None
                            else parse_slo_classes(""))
        self.window_s = window_ms / 1000.0
        #: HBM bound: the pool's KV budget is max_batch full-context caches
        #: (--batch-max; size against seq_len x n_layers x kv x cache dtype)
        self.max_batch = max(1, max_batch)
        #: fused steps between admission checks (--batch-chunk): smaller =
        #: lower admission latency for mid-decode arrivals, larger = fewer
        #: host round trips per token
        self.chunk = max(1, chunk)
        #: --prefill-chunk: prompt tokens consumed per scheduler tick while
        #: a long prompt fills its cache (admit_begin/prefill_step).
        #: < 0 = auto (one decode chunk's worth of token-forwards:
        #: chunk * max_batch); 0 = monolithic admission (the pre-chunking
        #: behavior: every resident row stalls for the whole prefill)
        self.prefill_chunk = (self.chunk * self.max_batch
                              if prefill_chunk < 0 else int(prefill_chunk))
        #: --kv-buckets: length-bucketed slot pools under the same modeled
        #: HBM budget (more resident rows for short traffic); off = the
        #: classic uniform [L, max_batch, S, kv, hd] slab
        self.kv_buckets = bool(kv_buckets)
        self.kv_bucket_min = max(0, int(kv_bucket_min))
        #: --kv-pages: paged KV pool + radix prefix cache (tokens per page;
        #: 0 = slab modes). Shared prompt prefixes are aliased
        #: copy-on-write instead of re-prefilled, under the same budget
        self.kv_pages = max(0, int(kv_pages))
        #: serving-side KV accountant, shared across pool sessions so the
        #: dllama_kv_* gauges stay continuous between traffic bursts
        self.kv_budget = KVBudget(
            self.max_batch * int(getattr(state.cfg, "seq_len", 1)))
        self._lock = threading.Lock()
        self._arrivals: queue_mod.Queue = queue_mod.Queue()
        # scheduler-layer telemetry (shares the server's registry): which
        # path served each request, and how full the slot pool ran
        reg = state.metrics
        self._m_path = reg.counter(
            "dllama_requests_path_total",
            "Completions served, by decode path (solo/spec/continuous)",
            ("path",))
        self._m_occupancy = reg.histogram(
            "dllama_batch_occupancy",
            "Occupied slots of the pooled decode session, observed per "
            "fused chunk",
            buckets=tuple(float(i) for i in range(1, self.max_batch + 1)))
        # SLO-class scheduling telemetry: every preemption decision by
        # outcome, plus live per-lane pressure (these two gauges are what
        # `cli top`'s lane columns read off /metrics/fleet)
        self._m_preemptions = reg.counter(
            "dllama_preemptions_total",
            "Chunk-boundary preemptions of batch-class rows, by outcome "
            "(ok=exported+parked, resumed=re-admitted bit-identically, "
            "retry=re-admission deferred, injected/error=preemption "
            "aborted, row kept decoding)",
            ("outcome",))
        self._m_class_queue = reg.gauge(
            "dllama_class_queue_depth",
            "Requests waiting for a decode slot, by SLO class",
            ("slo_class",))
        self._m_class_resident = reg.gauge(
            "dllama_class_resident_rows",
            "Rows resident in the decode slot pool, by SLO class",
            ("slo_class",))
        self._m_class_preempted = reg.gauge(
            "dllama_class_preempted_rows",
            "Preempted rows parked awaiting re-admission, by SLO class",
            ("slo_class",))
        #: latest per-lane scheduler snapshot ({class: {waiting, resident,
        #: preempted}}), published each chunk tick for /ready (the router's
        #: class-aware scoring reads it there)
        self._class_stats = {name: {"waiting": 0, "resident": 0,
                                    "preempted": 0}
                             for name in SLO_CLASSES}
        #: lifecycle.Supervisor owning the scheduler thread: a crashed loop
        #: fails its window's slots 503 and restarts instead of leaving
        #: every later submit() hanging on a dead daemon
        self._supervisor: Supervisor = None
        #: the window currently being routed — what _on_crash must fail
        self._window: list = []
        #: the live slot-pool session (while _serve_continuous runs):
        #: readiness reporting + crash cleanup
        self._active_sess = None
        #: paged mode keeps ONE session resident across batch windows: the
        #: arena IS the radix prefix cache, so closing it per window would
        #: throw away every cached system prompt. Slab modes still open and
        #: close per window (idle HBM freed); closed on crash cleanup.
        self._keep_sess = None

    # -- introspection (readiness probe) ----------------------------------
    @property
    def scheduler_alive(self) -> bool:
        """False only when the scheduler thread has died and the supervisor
        has not (yet) restarted it; a never-started scheduler is healthy —
        it starts on demand at the first submit."""
        sup = self._supervisor
        return sup is None or sup.alive

    @property
    def crash_count(self) -> int:
        sup = self._supervisor
        return 0 if sup is None else sup.crash_count

    def queue_depth(self) -> int:
        """Arrivals waiting for the scheduler to route them."""
        return self._arrivals.qsize()

    def occupancy(self) -> tuple:
        """(occupied slots, pool size) of the live decode session — (0, B)
        between pool sessions."""
        sess = self._active_sess
        return (len(sess.occupied) if sess is not None else 0, self.max_batch)

    def kv_info(self) -> dict:
        """KV occupancy for /ready and /stats: token reservations, resident
        rows per bucket (slab modes) and — in paged mode — page-pool state
        plus the prefix-cache hit rate. The multi-replica router weighs
        replicas by exactly this payload, so the load-picture fields it
        scores on (``kv_pages_free``/``kv_pages_total``/``prefix_hit_rate``)
        are ALWAYS present — zero in slab modes — and one cheap /ready
        probe carries the whole picture (/stats stays a superset)."""
        info = {
            "kv_tokens_reserved": self.kv_budget.reserved,
            "kv_tokens_budget": self.kv_budget.total_tokens,
            "kv_rows": {str(k): v for k, v in sorted(
                self.kv_budget.rows_by_bucket().items()) if v},
            "kv_pages_free": 0,
            "kv_pages_total": 0,
            "prefix_hit_rate": 0.0,
        }
        if self.kv_pages > 0:
            sess = self._active_sess or self._keep_sess
            pages = (sess.page_stats() if sess is not None
                     else self.kv_budget.page_stats())
            info["kv_pages"] = pages
            info["kv_pages_free"] = pages.get("pages_free", 0)
            info["kv_pages_total"] = pages.get("pages_total", 0)
            info["prefix_hit_rate"] = pages.get("prefix_hit_rate", 0.0)
        return info

    def class_stats(self) -> dict:
        """Per-SLO-class lane pressure ({class: {waiting, resident,
        preempted}}) as of the last scheduler tick — the readiness probe's
        lane view (the router scores classes off this)."""
        with self._lock:
            return {k: dict(v) for k, v in self._class_stats.items()}

    def _publish_class_stats(self, waiting: list, slot_map: dict,
                             preempted: list) -> None:
        """One chunk tick's lane picture -> gauges + readiness snapshot."""
        stats = {name: {"waiting": 0, "resident": 0, "preempted": 0}
                 for name in SLO_CLASSES}
        for s in waiting:
            if s.slo_class in stats:
                stats[s.slo_class]["waiting"] += 1
        for s in slot_map.values():
            if s.slo_class in stats:
                stats[s.slo_class]["resident"] += 1
        for s in preempted:
            if s.slo_class in stats:
                stats[s.slo_class]["preempted"] += 1
        for name, row in stats.items():
            self._m_class_queue.set(row["waiting"], slo_class=name)
            self._m_class_resident.set(row["resident"], slo_class=name)
            self._m_class_preempted.set(row["preempted"], slo_class=name)
        with self._lock:
            self._class_stats = stats

    def _class_resident_cap(self, slo_class: str) -> int:
        """The lane's max resident decode rows (0 = unbounded)."""
        cls = self.slo_classes.get(slo_class)
        return max(0, cls.max_resident) if cls is not None else 0

    def _preempt_one(self, sess, slot_map: dict, preempted: list) -> bool:
        """Preempt ONE batch-class resident row at this chunk boundary to
        make room for queued interactive work: snapshot its KV pages +
        sampler chain with the failover export machinery, free its slot,
        and park the SAME slot (queue and all — its SSE stream just pauses)
        for bit-identical re-admission via admit_from_export once pressure
        drops. A faulted/failed export leaves the row decoding untouched —
        preemption must never tear a healthy stream."""
        mid_prefill = set(sess.pending_prefills)
        victims = [b for b, s in slot_map.items()
                   if s.slo_class == "batch" and s.kind != "prefill"
                   and b not in mid_prefill  # a half-built cache has no
                   #  resumable snapshot — it waits out its prefill
                   and not sess.is_done(b)
                   and s.lifecycle_error() is None]
        if not victims:
            return False
        b = victims[-1]  # youngest batch row: least decode work discarded
        s = slot_map[b]
        try:
            faults.fire("preempt")
            snap = sess.export_row(b, fire_fault=False)
        except faults.FaultInjected:
            self._m_preemptions.inc(outcome="injected")
            return False
        except Exception:  # noqa: BLE001 — mid-prefill/unexportable row
            self._m_preemptions.inc(outcome="error")
            return False
        self._m_preemptions.inc(outcome="ok")
        self.state.flight.record(
            "preempt", request_id=(s.trace.request_id
                                   if s.trace is not None else None),
            emitted=int(snap.get("emitted", 0)))
        sess.release(b)
        del slot_map[b]
        s.kind = "import"
        s.snap = snap
        s.preempted = True
        preempted.append(s)
        return True

    def _serve_solo(self, s) -> None:
        """A batch of ONE delegates to the solo engine path, WITH prefix-
        session claim/store: a lone conversation ticking along under
        --batch-window must keep its KV reuse (and per-token streaming
        granularity) instead of re-prefilling its whole history through the
        batch path every turn — batching only changes anything under real
        concurrency. Caller holds state.lock. Tokens are bit-identical to
        the batched row (same per-request chain; the invariant
        generate_batch documents). A --spec-draft server speculates here
        too (generate_spec is exact at any temperature)."""
        st = self.state
        try:
            err = s.lifecycle_error()
            if err is not None:
                self._resolve_err(s, err)
                return
            s.mark_start("solo")
            self._m_path.inc(path="solo")
            session, feed = st.take_prefix_session(s.prompt)
            history = list(s.prompt)
            stream = st.open_stream(s.prompt, feed, session, s.steps,
                                    s.sampler)
            toks: list = []
            err = None
            for t, _ in stream:
                history.append(t)
                toks.append(t)
                s.mark_token()
                if s.queue is not None:
                    s.queue.put([t])
                err = s.lifecycle_error()
                if err is not None:
                    break  # abandon the generator at a token boundary;
                    # final_session is refreshed before every yield, so the
                    # stored state matches exactly what was consumed
            s.mark_prefill(getattr(st.engine, "prefill_ms", 0.0) or 0.0)
            st.store_prefix_session(history, st.engine.final_session)
            if err is not None:
                self._resolve_err(s, err)
                return
            s.tokens = toks
            if s.queue is not None:
                s.queue.put(None)
            s.done.set()
        except Exception as e:  # noqa: BLE001
            self._resolve_err(
                s, e if isinstance(e, (LifecycleError, NumericHealthError))
                else RuntimeError(f"decode failed: {e!r}"))

    @staticmethod
    def _resolve_err(s, err) -> None:
        """Resolve ONE waiter with ``err`` (typed lifecycle errors pass
        through so the handler can speak their HTTP status)."""
        s.error = err
        if s.queue is not None:
            s.queue.put(err)
        s.done.set()

    def _fail(self, slots, e) -> None:
        """Resolve every waiter with an error — ALWAYS on failure (a waiter
        left hanging would hang its HTTP connection)."""
        err = (e if isinstance(e, (LifecycleError, NumericHealthError))
               else RuntimeError(f"batched decode failed: {e!r}"))
        for s in slots:
            self._resolve_err(s, err)

    def _serve_spec(self, batch: list) -> None:
        """All-greedy window on a --spec-draft server: BATCHED speculative
        verify — every launch scores draft_len+1 positions for all rows
        (exact; rows equal plain batched greedy), single-device or
        quantized-TP. Streaming rows get per-launch bursts (already
        budget/stop-truncated). Run-to-completion: speculation's per-row
        drafting state assumes a fixed row set, so this fast path keeps the
        static shape — the scheduler only routes a window here when it fits
        the pool at once; contended windows decode continuously instead.
        The prompt list is padded to the next power of two (dummy greedy
        [0] rows of budget 1, dropped after) so distinct arrival counts
        reuse a handful of batch sizes.

        Lifecycle: cancelled/expired requests are resolved BEFORE the batch
        forms, AND mid-verify via ``row_cancel``: between verify launches a
        row whose client died (or whose deadline expired) stops decoding —
        the fixed row set speculation needs is preserved (the cancelled row
        keeps its slot but spends no more launches on new tokens), and its
        waiter is resolved with the typed error right after the batch."""
        batch = [s for s in batch if not self._reap_slot(s)]
        if not batch:
            return
        try:
            for s in batch:
                s.mark_start("spec")
                self._m_path.inc(path="spec")
            prompts, row_steps = padded_batch(
                [s.prompt for s in batch], [s.steps for s in batch])

            def on_step(fresh):
                for i, s in enumerate(batch):
                    if fresh[i]:
                        s.mark_token()
                        if s.queue is not None:
                            s.queue.put(fresh[i])

            def row_cancel(i):
                return (i < len(batch)
                        and batch[i].lifecycle_error() is not None)

            # explicit greedy sampler: the ENGINE default may be sampled
            # (CLI --temperature 0.8) and would trip the greedy-only
            # guard even though every REQUEST in this batch is greedy
            rows, _stats = self.state.engine.generate_batch_spec(
                prompts, max(s.steps for s in batch),
                stop_tokens=self.state.stop_token_ids(),
                row_steps=row_steps,
                draft_len=self.state.spec_draft,
                sampler=SamplerConfig(temperature=0.0, seed=0),
                on_step=on_step,
                row_cancel=row_cancel,
            )
            prefill_ms = getattr(self.state.engine, "prefill_ms", 0.0) or 0.0
            for s, row in zip(batch, rows):
                s.mark_prefill(prefill_ms)
                if self._reap_slot(s):
                    continue  # cancelled/expired mid-verify: typed error
                s.tokens = row[: s.steps]
                if s.queue is not None:
                    s.queue.put(None)
                s.done.set()
        except Exception as e:  # noqa: BLE001 — every waiter gets a 500
            self._fail(batch, e)

    def _reap_slot(self, s) -> bool:
        """Resolve ``s`` with its lifecycle error if it has one. True when
        the slot was resolved (drop it from scheduling)."""
        err = s.lifecycle_error()
        if err is None:
            return False
        self._resolve_err(s, err)
        return True

    def _serve_continuous(self, batch: list) -> None:
        """THE continuous path: open a slot-pool session, admit ``batch``
        into free slots, and between every fused chunk (a) stream each live
        row's fresh burst to its own queue, (b) release rows the moment
        they hit stop/budget — resolving their waiters immediately, not at
        batch end — and (c) admit newly arrived requests into the freed
        slots (rolling admission; the arrival queue is polled between
        chunks, so a mid-decode arrival waits at most one chunk). Runs
        until the pool drains AND no arrivals are waiting. Every admitted
        row is bit-identical to its solo run (BatchSession's invariant);
        the session is closed on exit so the pool cache's HBM is held only
        while traffic needs it."""
        st = self.state
        stop_ids = st.stop_token_ids()
        waiting = list(batch)
        slot_map: dict = {}  # session slot handle -> _Slot
        #: batch-class rows exported out of the pool to make room for
        #: interactive work; re-admitted (bit-identically) once no
        #: interactive request is waiting. Scheduler-thread-local, like
        #: ``waiting`` — readiness reads the _publish_class_stats snapshot.
        preempted: list = []
        sess = None
        try:
            sess = self._keep_sess
            if sess is None:
                sess = st.engine.batch_session(
                    self.max_batch, chunk=self.chunk,
                    bucket_kv=self.kv_buckets,
                    min_bucket=self.kv_bucket_min or None,
                    prefill_chunk=self.prefill_chunk,
                    kv_budget=self.kv_budget,
                    kv_pages=self.kv_pages)
                if self.kv_pages > 0:
                    with self._lock:
                        self._keep_sess = sess
            with self._lock:
                self._active_sess = sess
            while waiting or slot_map or preempted:
                # lifecycle reap, BETWEEN chunks: a cancelled (client gone)
                # or deadline-expired row is released NOW — its slab goes to
                # the next waiter this very loop pass — and dead waiters
                # never occupy a slot at all (a mid-prefill row's half-built
                # cache is dropped the same way). Parked preempted rows reap
                # identically: a batch client that gave up while parked
                # resolves here instead of being pointlessly re-admitted.
                waiting = [s for s in waiting if not self._reap_slot(s)]
                preempted = [s for s in preempted if not self._reap_slot(s)]
                # pressure dropped (no interactive work queued): move every
                # parked batch row back to the FRONT of the line — resumed
                # work outranks new batch arrivals (it already paid for its
                # decoded prefix once)
                if preempted and not any(s.slo_class == "interactive"
                                         for s in waiting):
                    waiting = preempted + waiting
                    preempted = []
                for b in list(slot_map):
                    s = slot_map[b]
                    err = s.lifecycle_error()
                    if err is not None:
                        sess.cancel(b)
                        sess.release(b)
                        del slot_map[b]
                        self._resolve_err(s, err)
                # paged sessions get the actual tokens so admission counts
                # the radix prefix match (a warm prompt needs fewer pages)
                while waiting:
                    # per-class lanes: interactive admits first (FIFO
                    # within a lane); a batch waiter additionally honors
                    # its lane's max_resident cap. Import jobs (disagg
                    # migrations, preempted resumes) skip the cap — a
                    # migration refused residency would fail the transfer.
                    resident: dict = {}
                    for sl in slot_map.values():
                        resident[sl.slo_class] = \
                            resident.get(sl.slo_class, 0) + 1
                    pick = None
                    for lane in SLO_CLASSES:
                        cap = self._class_resident_cap(lane)
                        for i, w in enumerate(waiting):
                            if w.slo_class != lane:
                                continue
                            if (w.kind != "import" and cap
                                    and resident.get(lane, 0) >= cap):
                                break  # lane at its residency cap (FIFO
                                #        holds: no later same-lane waiter
                                #        may jump the capped head)
                            pick = i
                            break
                        if pick is not None:
                            break
                    if pick is None:
                        break  # every lane capped out this tick
                    s = waiting[pick]
                    if s.kind == "import":
                        # migrated row arriving: admit it warm from its
                        # export snapshot NOW — no can_admit wait (a full
                        # pool must fail fast so the router can fall back
                        # to re-prefilling, not queue behind cold prompts).
                        # A preempted row coming back rides the same path,
                        # but a failed RE-admission re-parks it (retry next
                        # tick) instead of failing the client.
                        waiting.pop(pick)
                        resumed = s.preempted
                        if not resumed:
                            s.mark_start("import")
                            self._m_path.inc(path="import")
                        try:
                            b = sess.admit_from_export(s.prompt, s.snap)
                        except Exception as e:  # noqa: BLE001 — this row
                            if resumed:
                                self._m_preemptions.inc(outcome="retry")
                                preempted.append(s)
                                break  # no room this tick; decode on
                            self.state._m_kv_imports.inc(outcome="error")
                            self._fail([s], e)
                            continue
                        if resumed:
                            s.preempted = False
                            self._m_preemptions.inc(outcome="resumed")
                        else:
                            self.state._m_kv_imports.inc(outcome="ok")
                            s.tokens = []
                        s.snap = None  # free the page payloads now
                        slot_map[b] = s
                        continue
                    if not sess.can_admit(len(s.prompt), s.steps, s.prompt):
                        # pool full for the highest-priority waiter: an
                        # interactive one reclaims batch residency at this
                        # very chunk boundary and retries immediately
                        if (s.slo_class == "interactive"
                                and self._preempt_one(sess, slot_map,
                                                      preempted)):
                            continue
                        break
                    waiting.pop(pick)
                    path = ("prefill" if s.kind == "prefill"
                            else "continuous")
                    s.mark_start(path)
                    self._m_path.inc(path=path)
                    pre_admit_ms = sess.prefill_ms
                    try:
                        if self.prefill_chunk > 0:
                            # chunked admission: reserve the row now, feed
                            # the prompt one prefill_step per tick below —
                            # resident rows keep decoding in between
                            b = sess.admit_begin(
                                s.prompt, s.steps, sampler=s.sampler,
                                stop_tokens=stop_ids)
                        else:
                            b = sess.admit(s.prompt, s.steps,
                                           sampler=s.sampler,
                                           stop_tokens=stop_ids)
                    except Exception as e:  # noqa: BLE001 — this row only
                        self._fail([s], e)
                        continue
                    if self.prefill_chunk <= 0:
                        s.mark_prefill(sess.prefill_ms - pre_admit_ms)
                    s.tokens = []
                    slot_map[b] = s
                # ONE incremental prefill piece per tick (FIFO): the oldest
                # pending prompt advances by <= prefill_chunk tokens, so
                # every resident row's inter-token gap is bounded by one
                # prefill chunk + one decode chunk instead of a whole
                # monolithic prompt
                if self.prefill_chunk > 0:
                    t_pf = time.monotonic()
                    adv = sess.prefill_step()
                    if adv is not None:
                        b, finished = adv
                        s = slot_map.get(b)
                        if s is not None:
                            s.mark_prefill_chunk(t_pf, time.monotonic())
                            if finished:
                                s.mark_prefill(sess.prefill_ms_of(b))
                self._publish_class_stats(waiting, slot_map, preempted)
                if slot_map:
                    self._m_occupancy.observe(float(len(slot_map)))
                    # the black box keeps the in-flight request ids per
                    # tick: a replica killed mid-decode dumps a ring whose
                    # last events say exactly whose work died with it
                    st.flight.record(
                        "chunk_tick", rows=len(slot_map),
                        requests=[s.trace.request_id
                                  for s in slot_map.values()
                                  if s.trace is not None][:8])
                for b, burst in sess.step_chunk().items():
                    s = slot_map[b]
                    s.tokens.extend(burst)
                    if burst:
                        s.mark_token()
                    if s.queue is not None and burst:
                        s.queue.put(burst)
                    if sess.is_done(b):
                        # free the slab NOW — the next waiter admits into
                        # it on this very loop pass
                        quarantined = sess.finish_reason(b) == "error"
                        sess.release(b)
                        del slot_map[b]
                        if quarantined:
                            # numeric-health quarantine: THIS row's logits
                            # went non-finite; its waiter gets the typed
                            # error (500 / finish_reason "error"), siblings
                            # decode on bit-identically
                            self._resolve_err(s, NumericHealthError(
                                "in pooled decode row; row quarantined"))
                            continue
                        if s.queue is not None:
                            s.queue.put(None)
                        s.done.set()
                    elif s.kind == "prefill":
                        # first chunk after go-live and the row is NOT done:
                        # migrate now — snapshot its pages + decode state,
                        # free the slot, and hand the snapshot (plus the
                        # chunk's already-emitted tokens) to the exporting
                        # HTTP handler. A faulted/failed export frees the
                        # slot the same way and fails THIS waiter only.
                        try:
                            snap = sess.export_row(b)
                        except Exception as e:  # noqa: BLE001
                            self.state._m_kv_exports.inc(outcome="error")
                            sess.cancel(b)
                            sess.release(b)
                            del slot_map[b]
                            self._fail([s], e)
                            continue
                        self.state._m_kv_exports.inc(outcome="ok")
                        sess.release(b)
                        del slot_map[b]
                        s.export = snap
                        s.done.set()
                    elif s.ckpt_every > 0 and s.queue is not None and burst:
                        # mid-stream failover checkpoint, taken AT the
                        # chunk boundary (so it lines up with an SSE event
                        # boundary downstream) and pushed THROUGH the
                        # queue: the writer attaches its rendering state
                        # at exactly the point the snapshot describes. The
                        # row stays live — a failed write is a skipped
                        # checkpoint (shorter resume coverage), never a
                        # stream error.
                        s.since_ckpt += len(burst)
                        if s.since_ckpt >= s.ckpt_every:
                            s.since_ckpt = 0
                            try:
                                faults.fire("ckpt_write")
                                snap = sess.export_row(b, fire_fault=False)
                            except Exception:  # noqa: BLE001
                                self.state._m_ckpt_writes.inc(
                                    outcome="error")
                            else:
                                self.state._m_ckpt_writes.inc(outcome="ok")
                                s.queue.put(("ckpt", snap))
                while True:  # rolling admission: drain mid-chunk arrivals
                    try:
                        waiting.append(self._arrivals.get_nowait())
                    except queue_mod.Empty:
                        break
        except Exception as e:  # noqa: BLE001 — every waiter gets a 500
            self._fail(list(slot_map.values()) + waiting + preempted, e)
            # a session that threw mid-window is suspect: never keep it
            if sess is not None and sess is self._keep_sess:
                with self._lock:
                    self._keep_sess = None
        finally:
            self._publish_class_stats([], {}, [])
            with self._lock:
                self._active_sess = None
            if sess is not None and sess is not self._keep_sess:
                sess.close()

    def _scheduler_loop(self) -> None:
        """The scheduler daemon: wait for an arrival, hold the admission
        window open for companions, then route the window — singleton ->
        solo path (prefix-cache reuse), all-greedy spec-capable fit ->
        batched speculative verify, anything else -> continuous slot-pool
        decode. The engine lock is held per window, so handler-side solo
        requests (stop strings, prefix-session extensions) interleave
        between windows exactly as before.

        Runs under a lifecycle.Supervisor: an exception escaping a window
        fails that window's slots with a 503-able SchedulerCrashed (see
        _on_crash) and the loop restarts — queued arrivals stay queued for
        the restarted thread. Returns (ending supervision) only when the
        server is draining and the queue is empty."""
        while True:
            try:
                first = self._arrivals.get(timeout=0.25)
            except queue_mod.Empty:
                if self.state.gate.draining:
                    return  # drain complete: clean supervisor exit
                continue
            if self.window_s > 0:
                time.sleep(self.window_s)  # let concurrent requests join
            window = [first]
            while True:
                try:
                    window.append(self._arrivals.get_nowait())
                except queue_mod.Empty:
                    break
            # NO try/finally here: on an exception _window must SURVIVE the
            # unwind so the supervisor's _on_crash can fail exactly these
            # slots (a finally would clear it first and strand the waiters)
            with self._lock:
                self._window = window
            faults.fire("scheduler")
            window = [s for s in window if not self._reap_slot(s)]
            if window:
                t_win = time.monotonic()
                # disaggregation jobs (prefill-export / import-admit) and
                # checkpointing streams exist only in the paged slot pool:
                # they never route solo or spec. Batch-class rows route
                # continuous too — solo/spec run-to-completion would make
                # them unpreemptible, and preemptibility is the lane's
                # contract
                plain = all(s.kind == "completion" and not s.ckpt_every
                            and s.slo_class == "interactive"
                            for s in window)
                with self.state.lock:  # the engine serves one pool at a time
                    if plain and len(window) == 1 and self._arrivals.empty():
                        self._serve_solo(window[0])
                    elif (plain and len(window) <= self.max_batch
                            and self.state.spec_draft > 0
                            and getattr(self.state.engine,
                                        "supports_batch_spec", False)
                            and all(s.sampler.temperature == 0.0
                                    for s in window)):
                        self._serve_spec(window)
                    else:
                        self._serve_continuous(window)
                # one span per routed window on the scheduler track (tid 0);
                # request tracks (allocated span ids) group right under it
                observability.emit_trace_events([
                    observability.scheduler_trace_event(
                        "scheduler_window", t_win, time.monotonic(),
                        {"window": len(window)})])
            with self._lock:
                self._window = []

    def _on_crash(self, exc: BaseException) -> None:
        """Supervisor hook for a crashed scheduler iteration: every slot of
        the in-flight window resolves with a 503-able error (no waiter may
        hang on a dead thread), and a leaked pool session's HBM is freed.
        Arrivals still queued are NOT failed — the restarted loop serves
        them; replaying the FAILED window is the client's call, not ours."""
        with self._lock:
            window, self._window = self._window, []
        self.state.flight.record(
            "scheduler_crash", error=repr(exc)[:200],
            requests=[s.trace.request_id for s in window
                      if s.trace is not None][:8])
        self.state.flight.dump("scheduler_crash")
        err = exc if isinstance(exc, LifecycleError) else SchedulerCrashed(exc)
        for s in window:
            if not s.done.is_set():
                self._resolve_err(s, err)
        with self._lock:
            sess, self._active_sess = self._active_sess, None
            if sess is None:
                sess = self._keep_sess
            self._keep_sess = None
        if sess is not None:
            try:
                sess.close()
            except Exception:  # noqa: BLE001 — cleanup must not re-crash
                pass

    def _enqueue(self, slot) -> None:
        with self._lock:
            if self._supervisor is None:
                self._supervisor = Supervisor(
                    self._scheduler_loop, self._on_crash,
                    name="dllama-batch-scheduler")
            self._supervisor.start()
        self._arrivals.put(slot)

    def _wait_resolution(self, slot, tick_s: float = 0.25) -> None:
        """Wait for the scheduler to resolve ``slot`` — BOUNDED: gives up
        with a typed error when the scheduler thread is dead (supervisor
        exhausted) or the slot's deadline passed long enough ago that the
        between-chunks enforcement clearly isn't coming (wedged device
        dispatch). submit() must never block forever."""
        while not slot.done.wait(tick_s):
            if not self.scheduler_alive:
                raise SchedulerCrashed(
                    RuntimeError("scheduler thread is not running"))
            dl = slot.deadline
            if dl is not None and dl.remaining() < -self.DEADLINE_GRACE_S:
                raise dl.error()

    def submit(self, prompt_tokens: list, max_tokens: int,
               sampler: SamplerConfig, deadline: Deadline = None,
               cancel: CancelToken = None, trace=None,
               slo_class: str = "interactive") -> list:
        """Blocks until this request's tokens are decoded (by the scheduler
        thread's pool). Thread-safe; raises the decode's failure as
        RuntimeError (typed LifecycleError for deadline/cancel/crash)."""
        slot = self._Slot(list(prompt_tokens), max_tokens, sampler,
                          streaming=False, deadline=deadline, cancel=cancel,
                          trace=trace, slo_class=slo_class)
        self._enqueue(slot)
        self._wait_resolution(slot)
        if slot.error is not None:
            raise slot.error
        return slot.tokens

    def submit_stream(self, prompt_tokens: list, max_tokens: int,
                      sampler: SamplerConfig, deadline: Deadline = None,
                      cancel: CancelToken = None, trace=None,
                      ckpt_every: int = 0, slo_class: str = "interactive"):
        """Yields bursts (lists) of token ids as the pool decodes — from
        admission, not from batch completion. Raises the decode failure as
        RuntimeError. A set ``cancel`` token ends the generator (the
        scheduler releases the row's slot at its next chunk boundary).
        ``ckpt_every`` > 0 interleaves ``("ckpt", export_snapshot)``
        markers into the yielded stream every that-many tokens — the SSE
        writer serializes them into checkpoint frames for the router."""
        slot = self._Slot(list(prompt_tokens), max_tokens, sampler,
                          streaming=True, deadline=deadline, cancel=cancel,
                          trace=trace, ckpt_every=ckpt_every,
                          slo_class=slo_class)
        self._enqueue(slot)
        return self._drain_stream(slot, cancel)

    def _drain_stream(self, slot, cancel):
        """Consume a streaming slot's queue: yield bursts — token-id lists
        interleaved with ``("ckpt", snapshot)`` markers when the slot
        checkpoints — until the terminal item (None = clean end,
        Exception = raised)."""
        while True:
            try:
                item = slot.queue.get(timeout=0.25)
            except queue_mod.Empty:
                if cancel is not None and cancel.cancelled:
                    return  # the writer stopped consuming; don't spin
                if not self.scheduler_alive:
                    raise SchedulerCrashed(
                        RuntimeError("scheduler thread is not running"))
                dl = slot.deadline
                if dl is not None and dl.remaining() < -self.DEADLINE_GRACE_S:
                    raise dl.error()
                continue
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    # -- disaggregation jobs (role-aware serving) -------------------------
    def submit_prefill(self, prompt_tokens: list, max_tokens: int,
                       sampler: SamplerConfig, deadline: Deadline = None,
                       trace=None) -> tuple:
        """Prefill ``prompt_tokens`` in the paged pool, decode ONE chunk,
        and migrate: returns ``(export_snapshot, emitted_tokens)``. The
        snapshot is None when the row finished inside its first chunk (a
        stop token or a one-chunk budget) — then ``emitted_tokens`` is the
        complete row and nothing migrates. Raises like :meth:`submit`."""
        slot = self._Slot(list(prompt_tokens), max_tokens, sampler,
                          streaming=False, deadline=deadline,
                          trace=trace, kind="prefill")
        self._enqueue(slot)
        self._wait_resolution(slot)
        if slot.error is not None:
            raise slot.error
        return slot.export, slot.tokens

    def submit_import(self, snap: dict, deadline: Deadline = None,
                      trace=None) -> list:
        """Admit a migrated row from a decoded kv_transfer snapshot and
        block until its remaining tokens are decoded. Raises like
        :meth:`submit` (a pool that can't fit the row raises RuntimeError
        — the caller's cue to fall back to re-prefilling)."""
        slot = self._import_slot(snap, deadline=deadline, trace=trace,
                                 streaming=False)
        self._enqueue(slot)
        self._wait_resolution(slot)
        if slot.error is not None:
            raise slot.error
        return slot.tokens

    def submit_import_stream(self, snap: dict, deadline: Deadline = None,
                             cancel: CancelToken = None, trace=None,
                             ckpt_every: int = 0):
        """Streaming variant of :meth:`submit_import`: yields bursts of
        freshly decoded token ids (the carried already-emitted tokens are
        the CALLER's to prepend — they were streamed by the exporter's
        chunk, not decoded here). ``ckpt_every`` keeps the resumed row
        checkpointing, so a SECOND death during resume is itself
        resumable."""
        slot = self._import_slot(snap, deadline=deadline, cancel=cancel,
                                 trace=trace, streaming=True,
                                 ckpt_every=ckpt_every)
        self._enqueue(slot)
        return self._drain_stream(slot, cancel)

    def _import_slot(self, snap: dict, deadline=None, cancel=None,
                     trace=None, streaming: bool = False,
                     ckpt_every: int = 0):
        sampler = SamplerConfig(temperature=float(snap["temp"]),
                                topp=float(snap["topp"]), seed=0)
        steps = max(1, int(snap["budget"]) - int(snap["emitted"]))
        return self._Slot(list(snap["prompt"]), steps, sampler,
                          streaming=streaming, deadline=deadline,
                          cancel=cancel, trace=trace, kind="import",
                          snap=snap, ckpt_every=ckpt_every)


class ServerState:
    """Everything the handler needs; one instance per server."""

    def __init__(self, engine, tokenizer, cfg, model_name: str, template: str = "llama3",
                 default_sampler: SamplerConfig = SamplerConfig(),
                 default_seed: int = None, spec_draft: int = 0,
                 session_cache: int = 2, batch_window_ms: float = 0.0,
                 batch_max: int = 8, batch_chunk: int = 8,
                 prefill_chunk: int = -1, kv_buckets: int = 1,
                 kv_bucket_min: int = 0, kv_pages: int = 0,
                 request_timeout: float = 0.0, queue_depth: int = 64,
                 metrics=None, log_json: bool = False,
                 log_prompts: bool = False, log_stream=None, flight=None,
                 role: str = "both", ckpt_interval: int = 32,
                 slo_classes=None, ts_interval: float = 1.0,
                 burn_short: float = 60.0, burn_long: float = 300.0):
        """``default_seed``: seed for requests that send none — None means a
        fresh time-based seed per request (the launch-flag --seed plumbs in
        here so an operator can make the whole server reproducible).
        ``spec_draft`` > 0 serves requests with prompt-lookup speculative
        decoding (Engine.generate_spec — multiple tokens per device step on
        repetitive text). Responses are byte-identical to the plain path at
        any temperature: greedy verifies against argmax, sampled against the
        same per-request key chain. ``session_cache``: how many conversation
        KV states to keep resident (each holds a full KV cache in HBM —
        size this against seq_len x n_layers x kv_dim x cache dtype).
        ``request_timeout``: per-request wall-clock budget in seconds
        (--request-timeout; 0 = unlimited) — an expired request 504s and
        its decode row is released at the next chunk boundary.
        ``queue_depth``: max concurrent requests admitted (--queue-depth);
        overflow is rejected 429 + Retry-After instead of queuing
        unboundedly.
        ``prefill_chunk``: prompt tokens per incremental prefill piece in
        the pooled path (--prefill-chunk; <0 = auto, 0 = monolithic).
        ``kv_buckets``/``kv_bucket_min``: length-bucketed KV slot pools
        (--kv-buckets/--kv-bucket-min) — more resident rows at the same
        modeled HBM budget when traffic skews short.
        ``kv_pages``: tokens per KV page (--kv-pages; 0 = slab modes) —
        paged KV pool with a copy-on-write radix prefix cache: shared
        prompt prefixes are aliased instead of re-prefilled, and growing
        rows append pages instead of migrating slabs.
        ``metrics``: observability.MetricsRegistry to register server-layer
        series on (None = the process-wide default registry, which the
        engine/lifecycle/weights layers already share — one /metrics scrape
        covers all four layers). ``log_json``: emit one structured JSON
        line per finished request to ``log_stream`` (default stderr).
        ``log_prompts``: include raw prompt text in those logs — OFF by
        default; logs carry only token counts and a sha256 prompt digest.
        ``role``: this replica's disaggregation role (--role): "prefill"
        (the fleet router sends it new prompts and migrates their KV to a
        decode replica at first token), "decode" (receives migrated rows)
        or "both" (the default — a colocated replica). The role only
        steers the ROUTER's placement; every replica answers every
        endpoint, so a lone "both" fleet behaves exactly as before.
        ``ckpt_interval``: default mid-stream checkpoint cadence in
        emitted tokens (--ckpt-interval) for streams that opt in via the
        ``X-Dllama-Ckpt`` header without naming their own K; 0 disables
        even opted-in checkpointing. A stream never checkpoints unless
        the request asks — direct (router-less) clients never see
        checkpoint control frames.
        ``slo_classes``: per-class admission policy (--slo-classes) — a
        {name: lifecycle.SLOClass} dict or the raw spec string (see
        lifecycle.parse_slo_classes). Defaults leave every lane bounded
        only by ``queue_depth``, i.e. exactly the single-class behavior.
        ``ts_interval``: time-series sampler cadence in seconds
        (--ts-interval; 0 disables history + burn-rate alerts).
        ``burn_short``/``burn_long``: the burn-rate engine's evaluation
        windows (--burn-short/--burn-long) against the class ``ttft=``/
        ``tpot=``/``err=`` targets."""
        why = unsupported(batch_window_ms, kv_buckets, kv_pages, role)
        if why is not None:
            raise NotImplementedError(why)
        self.engine = engine
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.model_name = model_name
        self.template = template
        self.default_sampler = default_sampler
        self.default_seed = default_seed
        self.spec_draft = spec_draft
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be prefill/decode/both, got {role!r}")
        self.role = role
        self.ckpt_interval = max(0, int(ckpt_interval))
        self.session_cache = max(1, session_cache)
        #: HBM bound shared by the batcher AND the `n` parameter: a batch's
        #: KV cache holds this many full-context caches
        self.batch_max = max(1, batch_max)
        self.request_timeout = max(0.0, request_timeout or 0.0)
        #: per-class admission policy: parsed --slo-classes (dict form
        #: accepted so in-process tests can hand SLOClass objects straight
        #: in; every class in lifecycle.SLO_CLASSES has an entry)
        self.slo_classes = (parse_slo_classes(slo_classes)
                            if isinstance(slo_classes, str) or slo_classes
                            is None else dict(slo_classes))
        #: bounded admission: EVERY completion request (solo or batched)
        #: acquires before doing work, so backpressure is a fast 429 at the
        #: door rather than an unbounded pile of blocked HTTP threads —
        #: lane-scoped (429s carry class-aware Retry-After) under classes
        self.gate = AdmissionGate(queue_depth, classes=self.slo_classes)
        self.lock = threading.Lock()  # engine serves one request at a time
        # -- observability: server-layer series (HTTP + per-request latency).
        # Registered BEFORE the batcher so its scheduler-layer handles share
        # the same registry instance.
        self.metrics = (metrics if metrics is not None
                        else observability.default_registry())
        #: the process's flight-recorder ring (GET /debug/flight; dumped on
        #: crash/504/SIGTERM). The process-global instance by default so the
        #: lifecycle layer's module-level hooks land in the same ring;
        #: in-process multi-replica tests pass their own for isolation.
        self.flight = (flight if flight is not None
                       else observability.flight_recorder())
        self.log_json = bool(log_json)
        self.log_prompts = bool(log_prompts)
        self.log_stream = log_stream
        self.started_at = time.time()
        #: replica identity: start nonce + (once bound) the listen port.
        #: Survives nothing — that is the point: a crash-restart mints a NEW
        #: generation, so federated series and router logs can tell "the
        #: same replica came back" from "a stale snapshot of the old one".
        self.start_nonce = uuid.uuid4().hex[:8]
        self.replica_id = f"0-{self.start_nonce}"  # port set by create_server
        reg = self.metrics
        self._m_http = reg.counter(
            "dllama_http_requests_total",
            "HTTP responses written, by route and status code",
            ("route", "code"))
        self._m_ttft = reg.histogram(
            "dllama_ttft_ms",
            "Time to first token (from request arrival), by decode path",
            ("path",))
        self._m_tpot = reg.histogram(
            "dllama_tpot_ms",
            "Mean time per output token after the first, by decode path",
            ("path",))
        self._m_queue_wait = reg.histogram(
            "dllama_queue_wait_ms",
            "Arrival-to-scheduling wait (admission + batching window)")
        # per-SLO-class latency series: the workload harness's per-class
        # SLO gates (and `cli top`'s lane view) read these off the
        # federated /metrics/fleet
        self._m_class_ttft = reg.histogram(
            "dllama_class_ttft_ms",
            "Time to first token (from request arrival), by SLO class",
            ("slo_class",))
        self._m_class_tpot = reg.histogram(
            "dllama_class_tpot_ms",
            "Mean time per output token after the first, by SLO class",
            ("slo_class",))
        self._m_tokens_in = reg.counter(
            "dllama_prompt_tokens_total", "Prompt tokens accepted")
        self._m_tokens_out = reg.counter(
            "dllama_completion_tokens_total", "Completion tokens generated")
        # token-COUNT distributions: power-of-two buckets (TOKEN_BUCKETS),
        # NOT the latency boundaries — each bucket reads directly as "which
        # KV bucket would this request land in"
        self._m_prompt_hist = reg.histogram(
            "dllama_prompt_tokens",
            "Prompt length per request, in power-of-two token buckets",
            buckets=observability.TOKEN_BUCKETS)
        self._m_completion_hist = reg.histogram(
            "dllama_completion_tokens",
            "Completion length per request, in power-of-two token buckets",
            buckets=observability.TOKEN_BUCKETS)
        self._m_sse_disconnect = reg.counter(
            "dllama_sse_disconnects_total",
            "Streaming responses whose client vanished mid-stream (the "
            "decode row is cancelled at its next chunk boundary)")
        # disaggregated serving: KV page-stream handoff between replicas.
        # outcome="error" moves when the kv_export/kv_import fault sites
        # fire — a failed transfer is machine-visible fleet-wide via the
        # router's federated /metrics/fleet, same as every dllama_* series
        self._m_kv_exports = reg.counter(
            "dllama_kv_transfer_exports_total",
            "KV page-stream export attempts (a migrating row leaving "
            "this replica), by outcome", ("outcome",))
        self._m_kv_imports = reg.counter(
            "dllama_kv_transfer_imports_total",
            "KV page-stream import attempts (a migrating row arriving at "
            "this replica), by outcome", ("outcome",))
        self._m_kv_bytes = reg.counter(
            "dllama_kv_transfer_bytes_total",
            "Framed KV page-stream wire bytes, by direction (in/out)",
            ("direction",))
        self._m_kv_pages = reg.counter(
            "dllama_kv_transfer_pages_total",
            "KV pages shipped on the transfer wire, by direction (in/out)",
            ("direction",))
        # mid-stream failover: periodic session checkpoints shipped in-band
        # to the router. outcome="error" moves when the ckpt_write fault
        # site fires (or a live export fails) — a failed checkpoint only
        # shrinks resume coverage, never the stream
        self._m_ckpt_writes = reg.counter(
            "dllama_ckpt_writes_total",
            "Mid-stream session checkpoint attempts (every --ckpt-interval "
            "emitted tokens on an opted-in stream), by outcome",
            ("outcome",))
        # info-style gauge (value 1, identity in the labels): the resolved
        # TP wire format, overlap mode and reduce direction ride /metrics —
        # and therefore the router's federated /metrics/fleet — so a q80
        # request that was warned-and-dropped to plain gathers (or a
        # tp_reduce that declined) is machine-visible fleet-wide
        from dllama_tpu_torch.serving.protocol import TP_WIRE_INFO_LABELS

        reg.gauge("dllama_tp_wire_info",
                  "Resolved TP wire/overlap/reduce configuration (labels "
                  "carry the values; constant 1)",
                  labelnames=TP_WIRE_INFO_LABELS).set(
            1.0,
            tp_wire=getattr(engine, "tp_wire", "plain"),
            tp_overlap=("on" if getattr(engine, "tp_overlap_active", False)
                        else "off"),
            tp_reduce=getattr(engine, "tp_reduce", "off"))
        reg.gauge("dllama_batch_queue_depth",
                  "Arrivals waiting for the batch scheduler").set_function(
            lambda: float(self.batcher.queue_depth())
            if self.batcher is not None else 0.0)
        reg.gauge("dllama_slots_occupied",
                  "Occupied slots of the live pooled decode session"
                  ).set_function(
            lambda: float(self.batcher.occupancy()[0])
            if self.batcher is not None else 0.0)
        # --batch-window > 0: requests (greedy or sampled, streaming or
        # not) that arrive within the window share a continuously batched
        # slot-pool decode (Batcher) — single-device or tensor-parallel
        # alike; later arrivals are admitted into freed slots between
        # fused chunks of --batch-chunk steps. Off by default: batching
        # adds up to window_ms latency per request and only pays off under
        # concurrency.
        self.batcher = (
            Batcher(self, batch_window_ms, max_batch=batch_max,
                    chunk=batch_chunk, prefill_chunk=prefill_chunk,
                    kv_buckets=bool(kv_buckets),
                    kv_bucket_min=kv_bucket_min,
                    kv_pages=kv_pages, slo_classes=self.slo_classes)
            if batch_window_ms > 0 else None
        )
        # prefix cache: KV state + token history of recent completions, LRU.
        # Multi-turn chats resend the whole conversation; when a new prompt
        # extends a cached history, only the suffix is prefilled — and with
        # N slots, INTERLEAVED conversations each keep their own hot state.
        # The reference restarts pos=0 with no reuse every request
        # (`distributed-llama/src/apps/dllama-api/dllama-api.cpp:257`).
        self._sessions: list = []  # [(tokens, session)], oldest first
        # -- continuous observability (obsv/): bounded metric history
        # (GET /metrics/history) + SLO burn-rate alerts (GET /alerts),
        # sampled off this state's registry. The sampler THREAD starts
        # with the HTTP listener (create_server), so bare in-process
        # states stay thread-free; --ts-interval 0 disables the whole
        # subsystem (the BENCH_OBS off-leg).
        self.ts_store = TimeSeriesStore()
        self.burn_engine = BurnRateEngine(
            self.ts_store, self.slo_classes, reg, flight=self.flight,
            short_s=burn_short, long_s=burn_long)
        self.sampler = Sampler(reg, self.ts_store, interval_s=ts_interval,
                               hooks=(self.burn_engine.evaluate,))

    @staticmethod
    def _session_matches(cached: list, session, prompt_tokens: list) -> bool:
        """THE prefix-match predicate, shared by the claim
        (take_prefix_session) and the lock-free peek (has_prefix_session) so
        the batcher gate can never drift from what the solo path would
        actually claim: cached history must be a non-empty prefix of the
        prompt, and an exact-length match needs a pending token (an empty
        suffix with nothing pending would leave generate() with no input)."""
        if not (0 < len(cached) <= len(prompt_tokens)):
            return False
        if prompt_tokens[: len(cached)] != cached:
            return False
        return not (len(cached) == len(prompt_tokens)
                    and session.pending_token is None)

    def has_prefix_session(self, prompt_tokens: list) -> bool:
        """Read-only peek: does any cached session's history prefix
        ``prompt_tokens``? Used WITHOUT the engine lock by the batcher gate
        (a lock-free snapshot is safe under the GIL; a racy miss just costs
        one re-prefill, a racy hit routes one request solo) — a multi-turn
        conversation must keep its KV reuse instead of re-prefilling its
        whole history through the batch path every turn."""
        return any(self._session_matches(cached, session, prompt_tokens)
                   for cached, session in list(self._sessions))

    def take_prefix_session(self, prompt_tokens: list) -> tuple:
        """Returns (session, tokens_to_feed). Claims (removes) the cached
        session with the LONGEST history that ``prompt_tokens`` extends;
        (None, prompt_tokens) when no entry matches (from-scratch prefill —
        unmatched entries stay cached for their own conversations). Call
        under lock."""
        best, best_len = -1, 0
        for i, (cached, session) in enumerate(self._sessions):
            if not self._session_matches(cached, session, prompt_tokens):
                continue
            if len(cached) > best_len:
                best, best_len = i, len(cached)
        if best < 0:
            # miss at capacity: evict the oldest entry BEFORE the caller
            # allocates a fresh cache, or peak HBM would transiently hold
            # session_cache + 1 full KV caches during the prefill
            if len(self._sessions) >= self.session_cache:
                self._evict_oldest()
            return None, prompt_tokens
        cached, session = self._sessions.pop(best)
        return session, prompt_tokens[len(cached):]

    def _evict_oldest(self) -> None:
        """Drop the LRU session and free its KV cache NOW (its tensors and
        the step graphs captured on it, ``Engine.free_cache``) — waiting
        for GC would transiently hold an extra cache in HBM. Call under
        lock."""
        _, old = self._sessions.pop(0)
        self.engine.free_cache(old.cache)

    def store_prefix_session(self, tokens: list, session) -> None:
        """Cache the post-request state: ``tokens`` = every token fed or
        sampled this request (the session's pending token last); evicts
        beyond capacity."""
        self._sessions.append((list(tokens), session))
        while len(self._sessions) > self.session_cache:
            self._evict_oldest()

    def open_stream(self, prompt_tokens: list, feed_tokens: list, session,
                    max_tokens: int, sampler: SamplerConfig):
        """THE solo token-stream dispatch, shared by the HTTP solo path and
        the batcher's singleton delegation so the spec-vs-plain branch and
        the n-gram history arithmetic can never drift. A --spec-draft
        server speculates (generate_spec is exact at any temperature);
        ``history`` tells its n-gram index about tokens already consumed
        into the claimed session's cache (the cached prefix minus its
        pending token, when it has one) so drafts match across earlier
        turns of the chat."""
        stop_ids = self.stop_token_ids()
        if self.spec_draft > 0:
            pending = 1 if (session is not None
                            and session.pending_token is not None) else 0
            n_consumed = len(prompt_tokens) - len(feed_tokens) - pending
            return self.engine.generate_spec(
                feed_tokens, max_tokens, session=session,
                stop_tokens=stop_ids, draft_len=self.spec_draft,
                history=prompt_tokens[:n_consumed] if session else None,
                sampler=sampler,
            )
        return self.engine.generate(
            feed_tokens, max_tokens, session=session,
            stop_tokens=stop_ids, sampler=sampler,
        )

    def stop_token_ids(self) -> tuple:
        """Hard stop ids: EOS plus the Llama-3 end-of-turn token when the
        vocab carries one. Single source for the solo and batched paths."""
        ids = tuple(i for i in (self.tokenizer.eos_id,) if i >= 0)
        eot = self.tokenizer.piece_id(b"<|eot_id|>")
        return ids + ((eot,) if eot >= 0 else ())

    def begin_drain(self) -> None:
        """SIGTERM path: stop admitting (new requests 503), let in-flight
        requests finish. The scheduler loop exits cleanly once its queue is
        empty and the gate reports draining."""
        self.gate.begin_drain()

    def readiness(self) -> tuple:
        """(ready, info) for the /ready probe. NOT ready while draining or
        while the scheduler thread is dead (supervisor mid-restart); the
        info dict reports the load picture either way so operators see WHY."""
        batcher = self.batcher
        occupied, total = (batcher.occupancy() if batcher is not None
                           else (0, self.batch_max))
        scheduler_alive = (batcher.scheduler_alive
                          if batcher is not None else True)
        ready = not self.gate.draining and scheduler_alive
        kv = (batcher.kv_info() if batcher is not None
              else {"kv_tokens_reserved": 0, "kv_tokens_budget": 0,
                    "kv_rows": {}, "kv_pages_free": 0, "kv_pages_total": 0,
                    "prefix_hit_rate": 0.0})
        return ready, {
            "status": "ready" if ready else "not_ready",
            # identity + clock: the router keys federated series and its
            # generation-change log on replica_id, and estimates this
            # replica's trace-clock offset (skew + RTT/2) from time_us
            # against its own probe send/recv timestamps
            "replica_id": self.replica_id,
            # disaggregation role: the router routes new prompts to
            # prefill-capable replicas and migrated rows to decode-capable
            # ones off this single field
            "role": self.role,
            "started_at": round(self.started_at, 3),
            "time_us": observability.mono_to_us(),
            "draining": self.gate.draining,
            "scheduler_alive": scheduler_alive,
            "scheduler_crashes": (batcher.crash_count
                                  if batcher is not None else 0),
            "inflight": self.gate.depth,
            "queue_capacity": self.gate.capacity,
            "queue_depth": (batcher.queue_depth()
                            if batcher is not None else 0),
            "slots_occupied": occupied,
            "slots_total": total,
            # TP wire resolution, machine-visible: a q80 request the CLI
            # warned-and-dropped reads back "plain" here, and tp_overlap
            # says whether the microbatch-overlap programs were actually
            # built (with the drop reason when not)
            "tp_wire": getattr(self.engine, "tp_wire", "plain"),
            "tp_overlap": ("on" if getattr(self.engine, "tp_overlap_active",
                                           False) else "off"),
            "tp_overlap_reason": getattr(self.engine, "tp_overlap_reason",
                                         "not requested"),
            # row-parallel reduce direction, same contract: the resolved
            # mode ("off" when declined) plus the machine-visible reason
            "tp_reduce": getattr(self.engine, "tp_reduce", "off"),
            "tp_reduce_reason": getattr(self.engine, "tp_reduce_reason",
                                        "not requested"),
            # decode kernel-fusion resolution (flash / fused norm / fused
            # rope+cache): the env flags resolved against what this
            # engine's weights and TP path can actually engage
            "kernel_fusions": getattr(self.engine, "kernel_fusions", {}),
            # per-SLO-class lane picture: gate in-flight depth + the
            # scheduler's waiting/resident/preempted counts. The router's
            # class-aware scoring penalizes a replica by ITS lane's
            # pressure, not the aggregate
            "classes": self._class_readiness(),
            **kv,
        }

    def _class_readiness(self) -> dict:
        """{class: {inflight, capacity, waiting, resident, preempted}} —
        the per-lane slice of the readiness payload."""
        depths = self.gate.class_depths()
        stats = (self.batcher.class_stats() if self.batcher is not None
                 else {})
        out = {}
        for name in self.slo_classes:
            lane = stats.get(name, {})
            out[name] = {
                "inflight": depths.get(name, 0),
                "capacity": self.gate.class_capacity(name),
                "waiting": lane.get("waiting", 0),
                "resident": lane.get("resident", 0),
                "preempted": lane.get("preempted", 0),
            }
        return out

    def finish_request(self, trace: RequestTrace) -> None:
        """Per-request telemetry sink, called once per completion request
        (success, typed rejection, or failure alike): observe the latency
        histograms, append the request's spans to the DLLAMA_TRACE file,
        and emit the structured JSON log line (--log-json). Prompt text
        never reaches the log unless --log-prompts: the record carries
        token counts and a sha256 digest instead."""
        path = trace.path or "none"
        slo_class = trace.slo_class or "interactive"
        if trace.ttft_ms is not None:
            self._m_ttft.observe(trace.ttft_ms, path=path)
            self._m_class_ttft.observe(trace.ttft_ms, slo_class=slo_class)
        if trace.tpot_ms is not None:
            self._m_tpot.observe(trace.tpot_ms, path=path)
            self._m_class_tpot.observe(trace.tpot_ms, slo_class=slo_class)
        if trace.queue_wait_ms is not None:
            self._m_queue_wait.observe(trace.queue_wait_ms)
        if trace.tokens_in:
            self._m_tokens_in.inc(trace.tokens_in)
            self._m_prompt_hist.observe(float(trace.tokens_in))
        if trace.tokens_out:
            self._m_tokens_out.inc(trace.tokens_out)
            self._m_completion_hist.observe(float(trace.tokens_out))
        observability.emit_trace_events(trace.trace_events())
        self.flight.record(
            "request_end", request_id=trace.request_id, status=trace.status,
            finish_reason=trace.finish_reason, tokens_out=trace.tokens_out)
        if trace.status == 504 or trace.finish_reason == "timeout":
            # a blown deadline is an incident worth its black box: the dump
            # shows what the gate/scheduler were doing while budget burned
            self.flight.dump("deadline")
        if self.log_json:
            rec = trace.record()
            if self.log_prompts and trace.prompt_text is not None:
                rec["prompt"] = trace.prompt_text
            observability.log_json_line(rec, stream=self.log_stream)

    def stats(self) -> dict:
        """JSON stats for GET /stats: the readiness picture plus latency
        percentiles (served from each histogram's raw-sample reservoir) —
        the human-curl view of what /metrics exposes for scrapers."""
        _, info = self.readiness()
        snap = self.metrics.snapshot()
        return {
            "model": self.model_name,
            "replica_id": self.replica_id,
            "started_at": round(self.started_at, 3),
            "uptime_s": round(time.time() - self.started_at, 1),
            "load": info,
            "metrics": snap,
        }

    def build_prompt(self, messages: list) -> str:
        """Render a full conversation (the API is stateless: each request
        carries all messages, same as the reference, `dllama-api.cpp:173-181`)."""
        if self.template == "llama3":
            return render_llama3_chat(messages)
        system = ""
        parts = []
        first = True
        for m in messages:
            if m["role"] == "system":
                system = m["content"]
            elif m["role"] == "user":
                parts.append(render_llama2_turn(m["content"], system, first))
                first = False
            elif m["role"] == "assistant":
                parts.append(f" {m['content']} ")
        return "".join(parts)


def _completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:16]


class OpenAIHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state: ServerState = None  # set by create_server

    def log_message(self, fmt, *args):  # quiet; the CLI prints its own lines
        pass

    # -- helpers ----------------------------------------------------------
    #: every HTTP response path funnels through here or _send_sse_headers,
    #: so the request-id echo and the http-requests counter cover 200s,
    #: SSE streams, and every 4xx/5xx alike
    _KNOWN_ROUTES = ("/v1/chat/completions", "/chat/completions",
                     "/v1/models", "/health", "/healthz", "/ready",
                     "/metrics", "/metrics/history", "/alerts",
                     "/stats", "/debug/flight",
                     "/v1/prefill", "/v1/kv/import", "/v1/kv/resume")

    def _route(self) -> str:
        """Route label for the HTTP counter: known paths verbatim, anything
        else bucketed as "other" so probe scans can't explode cardinality."""
        p = self.path.split("?", 1)[0]
        return p if p in self._KNOWN_ROUTES else "other"

    def _begin_request(self) -> None:
        """Per-request handler state: the request id (client-supplied
        X-Request-Id when sane, freshly minted otherwise) echoed on EVERY
        response, the router's hop span (X-Dllama-Parent-Span) for trace
        stitching, and the not-yet-emitted trace for POSTs."""
        self._rid = observability.sanitize_request_id(
            self.headers.get(HDR_REQUEST_ID))
        self._parent_span = observability.sanitize_parent_span(
            self.headers.get(HDR_PARENT_SPAN))
        self._trace = None
        self._t_begin = time.monotonic()

    def _ckpt_request(self) -> tuple:
        """Parse the router's ``X-Dllama-Ckpt`` / ``X-Dllama-Ckpt-Wire``
        headers into ``(ckpt_every, wire)``. 0 = checkpointing not
        requested — or disabled on this replica (--ckpt-interval 0
        outranks any header); a bare/"auto" value takes the replica's
        --ckpt-interval default. An unknown wire falls back to f32, the
        bit-exact mode a resume can always trust."""
        st = self.state
        raw = (self.headers.get(HDR_CKPT) or "").strip().lower()
        if not raw or st.ckpt_interval <= 0:
            return 0, "f32"
        k = (st.ckpt_interval if not raw.isdigit() else int(raw))
        wire = (self.headers.get(HDR_CKPT_WIRE) or "f32").strip()
        if wire not in kv_transfer.WIRE_MODES:
            wire = "f32"
        return max(0, k), wire

    def _start_deadline(self) -> "Deadline":
        """Effective wall-clock budget for this request: the class lane's
        configured deadline when one is set (the SLO the lane promised its
        clients), else the server-wide --request-timeout."""
        st = self.state
        lane = st.gate.deadline_for(getattr(self, "_slo_class",
                                            "interactive"))
        return Deadline.start(lane or st.request_timeout)

    def _count(self, code: int) -> None:
        self.state._m_http.inc(route=self._route(), code=str(code))
        if self._trace is not None and self._trace.status == 0:
            self._trace.status = code
        if code >= 500:
            self.state.flight.record("http_5xx", code=code,
                                     route=self._route(),
                                     request_id=self._rid)

    def _server_timing(self) -> str:
        """Server-Timing value for THIS response: the request trace's phase
        durations when one exists (the router's hop attribution reads
        queue/prefill/decode), handler wall time otherwise — every endpoint
        emits the header (CONTRIBUTING rule), even plain GETs."""
        st = (observability.server_timing_header(self._trace)
              if self._trace is not None else "")
        total = f"total;dur={(time.monotonic() - self._t_begin) * 1e3:.3f}"
        return f"{st}, {total}" if st else total

    def _json(self, code: int, obj: dict, headers: dict = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header(HDR_REQUEST_ID, self._rid)
        self.send_header(HDR_SERVER_TIMING, self._server_timing())
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self._count(code)
        self.wfile.write(body)

    def _send_sse_headers(self, extra: dict = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.send_header(HDR_REQUEST_ID, self._rid)
        # headers leave before decode runs: only the phases known NOW (queue
        # wait at best) appear; the router attributes the rest to stream time
        self.send_header(HDR_SERVER_TIMING, self._server_timing())
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self._count(200)

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"error": {"message": message,
                                    "type": "invalid_request_error",
                                    "request_id": self._rid}})

    def _lifecycle_error(self, e: LifecycleError) -> None:
        """Speak a typed lifecycle rejection: its own HTTP status (429
        queue-full, 503 draining/crash, 504 deadline) and a Retry-After
        header when the error carries one."""
        headers = {}
        if e.retry_after_s is not None:
            headers["Retry-After"] = str(max(1, int(round(e.retry_after_s))))
        self._json(e.http_status,
                   {"error": {"message": str(e), "type": "server_error",
                              "request_id": self._rid}},
                   headers=headers)

    # -- routes -----------------------------------------------------------
    def do_GET(self):
        self._begin_request()
        st = self.state
        if self.path == "/v1/models":
            self._json(200, {
                "object": "list",
                "data": [{
                    "id": st.model_name,
                    "object": "model",
                    "created": int(time.time()),
                    "owned_by": "dllama_tpu",
                }],
            })
        elif self.path in ("/health", "/healthz"):
            # LIVENESS: 200 whenever the process can answer — a draining or
            # scheduler-crashed server is still alive (don't restart it);
            # readiness is /ready's job. The body carries the same load
            # picture as /ready so one curl answers "alive AND why".
            _, info = st.readiness()
            self._json(200, {
                "status": "ok",
                "scheduler_alive": info["scheduler_alive"],
                "crash_count": info["scheduler_crashes"],
                "queue_depth": info["queue_depth"],
            })
        elif self.path == "/ready":
            # READINESS: should a load balancer send traffic here?
            ready, info = st.readiness()
            info["crash_count"] = info["scheduler_crashes"]
            self._json(200 if ready else 503, info)
        elif self.path == "/metrics":
            # Prometheus text exposition (hand-rolled, stdlib only): every
            # layer's series — server/scheduler (this file), lifecycle gate,
            # engine decode, weight integrity — off one registry
            body = st.metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.send_header(HDR_REQUEST_ID, self._rid)
            self.end_headers()
            self._count(200)
            self.wfile.write(body)
        elif self.path.split("?", 1)[0] == "/metrics/history":
            # the time-series ring as windowed JSON: what every sampled
            # series did over the last ?window= seconds (default 300)
            self._json(200, dict(
                st.ts_store.window(parse_window(self.path)),
                replica_id=st.replica_id))
        elif self.path == "/alerts":
            # live SLO burn-rate picture: one entry per configured
            # (class, signal) target, firing or resolved
            self._json(200, dict(st.burn_engine.alerts_payload(),
                                 replica_id=st.replica_id))
        elif self.path == "/stats":
            self._json(200, st.stats())
        elif self.path == "/debug/flight":
            # the live flight-recorder ring, no dump required: what this
            # process saw happen recently, for incident triage and for the
            # router's aggregated fleet view
            self._json(200, dict(st.flight.snapshot(),
                                 replica_id=st.replica_id))
        else:
            self._error(404, f"unknown path {self.path}")

    def do_POST(self):
        self._begin_request()
        if self.path in ("/v1/chat/completions", "/chat/completions"):
            handle, binary = self._handle_completions, False
        elif self.path == "/v1/prefill":
            # disaggregated serving, hop 1: prefill + first chunk here,
            # then answer either the finished completion or a framed KV
            # page stream for the router to hand a decode replica
            handle, binary = self._handle_prefill, False
        elif self.path == "/v1/kv/import":
            # hop 2: admit a migrated row warm from its page stream and
            # decode the rest (body is kv_transfer-framed bytes, not JSON)
            handle, binary = self._handle_kv_import, True
        elif self.path == "/v1/kv/resume":
            # mid-stream failover: admit a dead sibling's checkpointed
            # session and continue its SSE stream bit-identically (body
            # is the checkpoint's kv_transfer-framed bytes)
            handle, binary = self._handle_kv_resume, True
        else:
            self._error(404, f"unknown path {self.path}")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            req = body if binary else json.loads(body or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"bad JSON body: {e}")
            return
        # one trace per completion attempt — ALSO for typed rejections
        # (429/503/504), so rejected request ids still appear in the
        # structured log and the latency histograms stay success-only.
        # A router-minted parent span stitches this trace under the
        # router's proxy span in the merged fleet timeline.
        trace = self._trace = RequestTrace(self._rid,
                                           parent_span=self._parent_span)
        trace.model = self.state.model_name
        # SLO lane: X-Dllama-Class names the request's class. An UNKNOWN
        # class is a 400, never a silent default — a typo'd "bulk" job
        # must not land in (and blow) the interactive lane
        slo_class = (self.headers.get(HDR_CLASS)
                     or "interactive").strip().lower()
        if slo_class not in SLO_CLASSES:
            self._error(400, f"unknown SLO class {slo_class!r} "
                             f"(known: {', '.join(SLO_CLASSES)})")
            return
        trace.slo_class = self._slo_class = slo_class
        # bounded admission at the door: gate capacity covers EVERY in-
        # flight completion (solo and batched alike), so overflow is an
        # immediate 429 + Retry-After and a draining server answers 503
        # instead of stranding requests behind a closing engine. Lane-
        # scoped: a saturated batch lane 429s its own clients (with ITS
        # Retry-After) while interactive admission continues
        try:
            admitted_at = self.state.gate.acquire(slo_class)
        except LifecycleError as e:
            self._lifecycle_error(e)
            trace.finish_reason = "rejected"
            self.state.finish_request(trace)
            return
        trace.admission_depth = self.state.gate.depth
        self.state.flight.record("request_start", request_id=self._rid,
                                 depth=trace.admission_depth,
                                 slo_class=slo_class)
        try:
            handle(req, trace)
        except LifecycleError as e:
            # typed lifecycle end that escaped before any bytes were
            # written (non-streaming deadline/crash): speak its status
            try:
                self._lifecycle_error(e)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client vanished while we wrote the error body
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream (FIN -> BrokenPipe, RST ->
            # ConnectionReset); per-request isolation like the reference's
            # per-request catch (`dllama-api.cpp:347-351`)
        finally:
            self.state.gate.release(admitted_at, slo_class)
            self.state.finish_request(trace)

    def _stream_batched(self, base: dict, sampler: SamplerConfig,
                        prompt_tokens: list, max_tokens: int,
                        deadline: Deadline = None, trace=None,
                        carried: list = None, source=None,
                        cancel: CancelToken = None,
                        detector: StopDetector = None,
                        ckpt_every: int = 0, ckpt_wire: str = "f32",
                        resume_state: dict = None,
                        extra_headers: dict = None) -> None:
        """SSE streaming from the shared pool decode: bursts of up to
        batch-chunk tokens per event instead of one event per token (the
        granularity trade for sharing one device program across concurrent
        requests). ``detector`` enables stop-string truncation here (a
        tripped detector cancels the row at its next chunk boundary);
        without one, only stop TOKENS and budgets truncate — the batch
        gate still routes plain stop-string requests solo.

        Lifecycle: a write failure (client FIN/RST — or an injected
        ``stream:raise`` fault, which simulates exactly that) flips the
        request's CancelToken instead of decoding on for a dead socket; the
        scheduler releases the row's slot at the next chunk boundary. A
        deadline expiry ends the stream with finish_reason "timeout".

        Disaggregation reuse: ``source`` (a callable taking the
        CancelToken, returning a burst iterator) swaps in the import-admit
        decode of a migrated row, and ``carried`` prepends the tokens the
        exporting replica already emitted — the client's stream is the
        solo stream whichever replica decoded which half.

        Mid-stream failover: ``ckpt_every`` > 0 serializes each
        ``("ckpt", snapshot)`` marker the scheduler interleaves into one
        in-band ``event: dllama-ckpt`` control frame — the snapshot plus
        THIS writer's rendering state (emitted byte count, incremental
        UTF-8 decoder state, pending-token/render counters, the response
        ``base`` identity, the detector's scanback) — which the router
        strips into its checkpoint store; clients talking to the replica
        directly never request checkpoints and never see the frames.
        ``resume_state`` is the other half: /v1/kv/resume rehydrates that
        rendering state so the continued stream's bytes are EXACTLY what
        the dead replica would have written, letting the router splice by
        byte offset alone."""
        st = self.state
        tok = st.tokenizer
        cancel = cancel if cancel is not None else CancelToken()
        self._send_sse_headers(extra=extra_headers)

        client_gone = False
        #: client-visible SSE bytes written so far — checkpoint control
        #: frames excluded, so the count matches what the ROUTER forwards
        #: and the resume splice is pure byte arithmetic
        bytes_emitted = 0

        def emit_frame(frame: bytes, fire: bool = True) -> None:
            nonlocal client_gone, bytes_emitted
            if client_gone:
                return
            try:
                if fire:
                    faults.fire("stream")
                self.wfile.write(frame)
                self.wfile.flush()
                if fire:  # ckpt control frames are stripped by the
                    #       router, so they never count toward the
                    #       client-visible splice offset
                    bytes_emitted += len(frame)
            except (BrokenPipeError, ConnectionResetError,
                    faults.FaultInjected):
                st._m_sse_disconnect.inc()
                client_gone = True
                cancel.cancel("client disconnected mid-stream")

        def emit_chunk(delta: dict, finish=None) -> None:
            chunk = dict(base, object="chat.completion.chunk",
                         choices=[{"index": 0, "delta": delta,
                                   "finish_reason": finish}])
            emit_frame(b"data: " + json.dumps(chunk).encode() + b"\n\n")

        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        if resume_state is not None:
            # continue the dead replica's stream mid-sentence: same byte
            # position, same half-decoded UTF-8 tail, same pending token —
            # and NO role preamble (the client got it long ago)
            bytes_emitted = int(resume_state["bytes"])
            utf8.setstate((bytes.fromhex(resume_state["utf8"][0]),
                           int(resume_state["utf8"][1])))
            prev = int(resume_state["prev"])
            n_generated = int(resume_state["n_generated"])
        else:
            emit_chunk({"role": "assistant"})
            prev = prompt_tokens[-1]
            n_generated = 0
        stop_ids = st.stop_token_ids()
        finish_reason = "length"

        def emit_ckpt(snap: dict) -> None:
            # at a chunk boundary the writer is exactly between SSE
            # events, so bytes_emitted IS the splice point. A failed
            # serialize is a skipped checkpoint, never a stream error.
            try:
                ustate = utf8.getstate()
                payload = kv_transfer.encode_snapshot(
                    snap, prompt_tokens, mode=ckpt_wire,
                    extra={"resume": {
                        "base": base, "bytes": bytes_emitted,
                        "utf8": [ustate[0].hex(), int(ustate[1])],
                        "prev": prev, "n_generated": n_generated,
                        "request_id": self._rid}},
                    stop_state=(detector.state() if detector is not None
                                else None))
            except Exception:  # noqa: BLE001
                st._m_ckpt_writes.inc(outcome="error")
                return
            emit_frame(_SSE_CKPT_PREFIX
                       + str(bytes_emitted).encode() + b" "
                       + base64.b64encode(payload) + b"\n\n", fire=False)

        try:
            bursts = (source(cancel) if source is not None
                      else st.batcher.submit_stream(
                          prompt_tokens, max_tokens, sampler,
                          deadline=deadline, cancel=cancel, trace=trace,
                          ckpt_every=ckpt_every,
                          slo_class=getattr(self, "_slo_class",
                                            "interactive")))
            if carried:
                bursts = itertools.chain([list(carried)], bursts)
            for burst in bursts:
                if isinstance(burst, tuple) and burst[0] == "ckpt":
                    emit_ckpt(burst[1])
                    continue
                parts = []
                stopped = False
                for t in burst:
                    n_generated += 1
                    if t in stop_ids:
                        stopped = True
                        break
                    piece = utf8.decode(tok.decode_piece(prev, t))
                    prev = t
                    if detector is not None:
                        out, hit = detector.feed(piece)
                        if out:
                            parts.append(out)
                        if hit:
                            stopped = True
                            break
                    else:
                        parts.append(piece)
                text = "".join(parts)
                if text:
                    emit_chunk({"content": text})
                if stopped:
                    finish_reason = "stop"
                    # a stop-STRING trip leaves the pool row live: cancel
                    # so the scheduler frees its slot at the next chunk
                    # boundary instead of decoding to budget
                    cancel.cancel("stop string hit mid-stream")
                    break
                if client_gone:
                    break  # cancel is set; the scheduler reaps the row at
                    # its next chunk boundary — stop consuming now
        except DeadlineExceeded as e:
            emit_chunk({"content": f"\n[error: {e}]"})
            finish_reason = "timeout"
        except NumericHealthError as e:
            # quarantined row: what was streamed before the blowup stands
            # (those chunks were finite); the stream ends with
            # finish_reason "error" so the client knows not to trust more
            emit_chunk({"content": f"\n[error: {e}]"})
            finish_reason = "error"
        except RuntimeError as e:
            emit_chunk({"content": f"\n[error: {e}]"})
        tail = utf8.decode(b"", True)
        if detector is not None and not detector.stopped:
            tail = detector.flush() + tail
        if tail:
            emit_chunk({"content": tail})
        emit_chunk({}, finish=finish_reason)
        if trace is not None:
            trace.finish_reason = finish_reason
            trace.tokens_out = n_generated
        if not client_gone:
            try:
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client closed between the last chunk and [DONE]
        self.close_connection = True

    def _handle_completions(self, req: dict, trace: RequestTrace) -> None:
        st = self.state
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            self._error(400, "messages must be a non-empty list")
            return
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                self._error(400, "each message needs role and content")
                return

        try:
            sampler = SamplerConfig(
                temperature=float(req.get("temperature", st.default_sampler.temperature)),
                topp=float(req.get("top_p", st.default_sampler.topp)),
                seed=int(req["seed"]) if req.get("seed") is not None
                else st.default_seed if st.default_seed is not None
                else int(time.time_ns() % (1 << 31)),
            )
            stops = req.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            if not (isinstance(stops, list) and all(isinstance(s, str) for s in stops)):
                raise ValueError("stop must be a string or list of strings")
            stream = bool(req.get("stream", False))
            mt = req.get("max_tokens")
            max_tokens = None if mt is None else max(1, int(mt))
            n_choices = max(1, int(req.get("n", 1) or 1))
        except (TypeError, ValueError) as e:
            self._error(400, f"bad request parameter: {e}")
            return
        if n_choices > st.batch_max:
            self._error(400, f"n is capped at {st.batch_max} (--batch-max: "
                             "each choice holds a full KV cache in device "
                             "memory)")
            return
        if n_choices > 1 and stream:
            self._error(400, "n > 1 with stream is not supported")
            return

        tok = st.tokenizer
        prompt = st.build_prompt(messages)
        prompt_tokens = tok.encode(prompt, add_bos=True)
        trace.tokens_in = len(prompt_tokens)
        trace.prompt_sha = observability.prompt_digest(prompt)
        if st.log_prompts:
            trace.prompt_text = prompt
        if st.batcher is not None:
            trace.queue_depth = st.batcher.queue_depth()
        room = st.cfg.seq_len - len(prompt_tokens)
        if room <= 0:
            self._error(400, f"prompt of {len(prompt_tokens)} tokens exceeds "
                             f"the {st.cfg.seq_len}-token context")
            return
        max_tokens = room if max_tokens is None else min(max_tokens, room)
        # wall-clock budget counted from HERE (admission), not from first
        # token: queue time burns budget too, by design. Class-scoped: a
        # lane's configured deadline outranks the global --request-timeout
        deadline = self._start_deadline()

        cid = _completion_id()
        created = int(time.time())
        base = {"id": cid, "object": "chat.completion", "created": created,
                "model": st.model_name}

        if n_choices > 1:
            # n samples of one prompt decode as ONE batch: the shared
            # prefix prefills once, every step streams the weights once for
            # all n rows (generate_batch); choice i runs its own chain at
            # seed+i — bit-identical to a solo request with that seed
            try:
                prompts, row_steps = padded_batch(
                    [list(prompt_tokens)] * n_choices,
                    [max_tokens] * n_choices)
                samplers = [
                    SamplerConfig(temperature=sampler.temperature,
                                  topp=sampler.topp, seed=sampler.seed + i)
                    for i in range(n_choices)
                ] + [SamplerConfig(temperature=0.0, seed=0)] * (
                    len(prompts) - n_choices)
                with st.lock:
                    trace.mark_start("n_batch")
                    rows = st.engine.generate_batch(
                        prompts, max_tokens,
                        samplers=samplers, stop_tokens=st.stop_token_ids(),
                        row_steps=row_steps,
                    )[:n_choices]
                    trace.mark_prefill(
                        getattr(st.engine, "prefill_ms", 0.0) or 0.0)
            except Exception as e:  # noqa: BLE001
                self._error(500, f"batched n-sampling failed: {e!r}")
                return
            row_health = getattr(st.engine, "row_health", None)
            choices, total = [], 0
            for idx, row in enumerate(rows):
                text, finish, n_gen = decode_token_row(
                    tok, prompt_tokens[-1], row[:max_tokens],
                    st.stop_token_ids(), stops)
                total += n_gen
                if row_health is not None and not row_health[idx]:
                    # this choice's logits went non-finite mid-decode: its
                    # text is untrustworthy from the blowup point — flag it
                    # instead of failing the healthy sibling choices
                    finish = "error"
                choices.append({
                    "index": idx,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish,
                })
            trace.tokens_out = total
            trace.finish_reason = choices[0]["finish_reason"]
            self._json(200, dict(base, choices=choices, usage={
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": total,
                "total_tokens": len(prompt_tokens) + total,
            }))
            return

        # mid-stream failover: the router opts a stream into periodic
        # checkpointing with X-Dllama-Ckpt. Only a streaming request in
        # the PAGED batcher pool can checkpoint (export_row needs pages);
        # anything else ignores the header and degrades to the router's
        # no-checkpoint fallback (clean SSE error on death).
        ckpt_every, ckpt_wire = self._ckpt_request()
        if not (stream and st.batcher is not None
                and st.batcher.kv_pages > 0):
            ckpt_every = 0

        if (st.batcher is not None and (not stops or ckpt_every > 0)
                and not st.has_prefix_session(prompt_tokens)):
            # stop STRINGS stay on the solo path: its host loop aborts at
            # the string, while a batch would decode the row's whole budget
            # on device before the host truncates. EXCEPT when the router
            # asked for checkpoints — resumability needs the paged pool,
            # so a checkpointing stop-string stream runs batched with an
            # in-handler StopDetector (its scanback state rides every
            # checkpoint), trading the early-abort for failover coverage.
            # A prompt that EXTENDS a cached conversation also stays solo:
            # the batch path skips the prefix cache, and re-prefilling a
            # growing history every turn would regress multi-turn latency
            # with zero concurrency.
            # Everything else — greedy or sampled, streaming or not —
            # merges into one batched decode; every row runs its own
            # sampler chain, so tokens are bit-identical to the solo path
            # for the same SamplerConfig. On a --spec-draft server an
            # all-greedy batch (streaming included — per-launch bursts)
            # runs the BATCHED speculative verify (Batcher._serve);
            # singletons speculate on the solo path either way.
            if stream:
                self._stream_batched(base, sampler, prompt_tokens, max_tokens,
                                     deadline=deadline, trace=trace,
                                     detector=(StopDetector(stops)
                                               if stops else None),
                                     ckpt_every=ckpt_every,
                                     ckpt_wire=ckpt_wire)
            else:
                try:
                    row = st.batcher.submit(prompt_tokens, max_tokens, sampler,
                                            deadline=deadline, trace=trace,
                                            slo_class=getattr(
                                                self, "_slo_class",
                                                "interactive"))
                except LifecycleError:
                    raise  # do_POST speaks its status (504/503) — must
                    # outrank the RuntimeError catch below (LifecycleError
                    # IS a RuntimeError)
                except RuntimeError as e:
                    # one poisoned batch must not reset K connections: every
                    # waiter gets its own 500
                    self._error(500, str(e))
                    return
                text, finish_reason, n_generated = decode_token_row(
                    tok, prompt_tokens[-1], row, st.stop_token_ids(), stops)
                trace.tokens_out = n_generated
                trace.finish_reason = finish_reason
                self._json(200, dict(base, choices=[{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish_reason,
                }], usage={
                    "prompt_tokens": len(prompt_tokens),
                    "completion_tokens": n_generated,
                    "total_tokens": len(prompt_tokens) + n_generated,
                }))
            return

        if stream:
            self._send_sse_headers()

        detector = StopDetector(stops)
        text_parts: list = []
        finish_reason = "length"
        n_generated = 0
        client_gone = False

        def emit_chunk(delta: dict, finish=None) -> None:
            nonlocal client_gone
            if client_gone:
                return
            try:
                faults.fire("stream")
                chunk = dict(base, object="chat.completion.chunk",
                             choices=[{"index": 0, "delta": delta,
                                       "finish_reason": finish}])
                self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError,
                    faults.FaultInjected):
                # dead socket: stop decoding at the next token boundary but
                # DON'T raise out of the locked loop — the prefix session
                # still gets stored (the conversation may reconnect)
                st._m_sse_disconnect.inc()
                client_gone = True

        if stream:
            emit_chunk({"role": "assistant"})

        # incremental UTF-8: a multi-byte character split across byte-fallback
        # tokens must not be decoded per piece (that would emit U+FFFD pairs)
        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        interrupted = None  # "timeout" when the deadline ends the decode
        health_err = None  # NumericHealthError when the watchdog trips
        with st.lock:
            trace.mark_start("solo")
            prev = prompt_tokens[-1]
            stop_ids = st.stop_token_ids()
            session, feed_tokens = st.take_prefix_session(prompt_tokens)
            history = list(prompt_tokens)
            stream_iter = st.open_stream(prompt_tokens, feed_tokens, session,
                                         max_tokens, sampler)
            try:
                for tok_id, _stats in stream_iter:
                    n_generated += 1
                    trace.mark_token()
                    history.append(tok_id)
                    if tok_id in stop_ids:
                        finish_reason = "stop"
                        break
                    piece = utf8.decode(tok.decode_piece(prev, tok_id))
                    prev = tok_id
                    out, hit_stop = detector.feed(piece)
                    if out:
                        text_parts.append(out)
                        if stream:
                            emit_chunk({"content": out})
                    if hit_stop:
                        finish_reason = "stop"
                        break
                    if client_gone:
                        break  # abandon the generator at a token boundary
                    if deadline is not None and deadline.expired():
                        interrupted = "timeout"
                        break
            except NumericHealthError as e:
                # the watchdog tripped: everything emitted so far was
                # finite, but the session's KV state is poisoned — do NOT
                # cache it for the next turn of this conversation
                health_err = e
            trace.mark_prefill(getattr(st.engine, "prefill_ms", 0.0) or 0.0)
            if health_err is None:
                st.store_prefix_session(history, st.engine.final_session)

        trace.tokens_out = n_generated
        if health_err is not None:
            trace.finish_reason = "error"
            if not stream:
                self._error(500, f"decode failed: {health_err}")
                return
            emit_chunk({"content": f"\n[error: {health_err}]"})
            finish_reason = "error"
        elif interrupted == "timeout":
            if not stream:
                raise deadline.error()  # -> 504 via do_POST
            emit_chunk({"content": f"\n[error: {deadline.error()}]"})
            finish_reason = "timeout"
        elif not detector.stopped:
            # flush text withheld as a possible stop-string prefix — on EOS or
            # length it is legitimate output, only a stop-string hit eats it —
            # plus the replacement char for any dangling incomplete UTF-8 bytes
            tail = detector.flush() + utf8.decode(b"", True)
            if tail:
                text_parts.append(tail)
                if stream:
                    emit_chunk({"content": tail})

        trace.finish_reason = finish_reason
        if stream:
            emit_chunk({}, finish=finish_reason)
            if not client_gone:
                try:
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client closed between the last chunk and [DONE]
            self.close_connection = True
        else:
            self._json(200, dict(base, choices=[{
                "index": 0,
                "message": {"role": "assistant", "content": "".join(text_parts)},
                "finish_reason": finish_reason,
            }], usage={
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": n_generated,
                "total_tokens": len(prompt_tokens) + n_generated,
            }))


    # -- disaggregated serving (role-aware fleet) -------------------------
    def _finished_row_response(self, base: dict, prompt_tokens: list,
                               row: list, stream: bool, trace,
                               stops: list = None) -> None:
        """Answer a COMPLETE token row in the client's requested shape —
        the prefill hop uses this when the row finished inside its first
        chunk (nothing migrated), and the import hop for its final
        non-streaming answer. SSE here is a replay of finished tokens,
        not a live stream; the router relays the bytes verbatim."""
        st = self.state
        text, finish, n_gen = decode_token_row(
            st.tokenizer, prompt_tokens[-1], row, st.stop_token_ids(),
            stops or [])
        trace.tokens_out = n_gen
        trace.finish_reason = finish
        if not stream:
            self._json(200, dict(base, choices=[{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }], usage={
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": n_gen,
                "total_tokens": len(prompt_tokens) + n_gen,
            }))
            return
        self._send_sse_headers()
        try:
            for delta, fin in ((({"role": "assistant"}), None),
                               (({"content": text} if text else None), None),
                               ({}, finish)):
                if delta is None and fin is None:
                    continue
                chunk = dict(base, object="chat.completion.chunk",
                             choices=[{"index": 0, "delta": delta or {},
                                       "finish_reason": fin}])
                self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client vanished; nothing is decoding on its behalf
        self.close_connection = True

    def _handle_prefill(self, req: dict, trace: RequestTrace) -> None:
        """POST /v1/prefill — hop 1 of a disaggregated request: admit the
        prompt into the paged pool, decode its FIRST chunk here, then
        export the row (pages + carried sampler-chain state) as a framed
        KV stream for the router to deliver to a decode replica. A row
        that finishes inside that first chunk answers the client's shape
        directly (nothing to migrate). Body = the chat-completions JSON
        plus optional "kv_wire" ("f32" bit-exact, default / "q80"
        block-quantized)."""
        st = self.state
        if st.batcher is None or st.batcher.kv_pages <= 0:
            self._error(400, "disaggregated prefill needs --batch-window "
                             "> 0 and --kv-pages (paged KV pool)")
            return
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            self._error(400, "messages must be a non-empty list")
            return
        for m in messages:
            if not isinstance(m, dict) or "role" not in m \
                    or "content" not in m:
                self._error(400, "each message needs role and content")
                return
        try:
            sampler = SamplerConfig(
                temperature=float(req.get(
                    "temperature", st.default_sampler.temperature)),
                topp=float(req.get("top_p", st.default_sampler.topp)),
                seed=int(req["seed"]) if req.get("seed") is not None
                else st.default_seed if st.default_seed is not None
                else int(time.time_ns() % (1 << 31)),
            )
            stream = bool(req.get("stream", False))
            mt = req.get("max_tokens")
            max_tokens = None if mt is None else max(1, int(mt))
            wire = str(req.get("kv_wire", "f32"))
        except (TypeError, ValueError) as e:
            self._error(400, f"bad request parameter: {e}")
            return
        stops = req.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        if not (isinstance(stops, list)
                and all(isinstance(s, str) for s in stops)):
            self._error(400, "stop must be a string or list of strings")
            return
        if int(req.get("n", 1) or 1) != 1:
            self._error(400, "n > 1 cannot be served disaggregated")
            return
        if wire not in kv_transfer.WIRE_MODES:
            self._error(400, f"unknown kv_wire {wire!r} "
                             f"(know {kv_transfer.WIRE_MODES})")
            return
        tok = st.tokenizer
        prompt = st.build_prompt(messages)
        prompt_tokens = tok.encode(prompt, add_bos=True)
        trace.tokens_in = len(prompt_tokens)
        trace.prompt_sha = observability.prompt_digest(prompt)
        room = st.cfg.seq_len - len(prompt_tokens)
        if room <= 0:
            self._error(400, f"prompt of {len(prompt_tokens)} tokens "
                             f"exceeds the {st.cfg.seq_len}-token context")
            return
        max_tokens = room if max_tokens is None else min(max_tokens, room)
        deadline = self._start_deadline()
        base = {"id": _completion_id(), "object": "chat.completion",
                "created": int(time.time()), "model": st.model_name}
        try:
            snap, emitted = st.batcher.submit_prefill(
                prompt_tokens, max_tokens, sampler, deadline=deadline,
                trace=trace)
        except LifecycleError:
            raise  # do_POST speaks its status
        except RuntimeError as e:
            self._error(500, f"prefill-export failed: {e}")
            return
        if snap is None:
            # finished inside the first chunk: answer the client directly
            self._finished_row_response(base, prompt_tokens, emitted,
                                        stream, trace, stops=stops)
            return
        # stop STRINGS migrate with the row: the exporter decoded only
        # token ids (never text), so a FRESH detector state travels in
        # the v2 header and the importer scans carried + fresh text
        # through it — the same scanback the solo path would have run
        payload = kv_transfer.encode_snapshot(
            snap, prompt_tokens, mode=wire,
            extra={"stream": stream,
                   "emitted_tokens": [int(t) for t in emitted],
                   "request_id": self._rid},
            stop_state=({"stops": stops, "hold": "", "stopped": False}
                        if stops else None))
        st._m_kv_bytes.inc(len(payload), direction="out")
        st._m_kv_pages.inc(float(snap["n_blocks"]), direction="out")
        trace.tokens_out = len(emitted)
        trace.finish_reason = "migrated"
        self.send_response(200)
        self.send_header("Content-Type", kv_transfer.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header(HDR_REQUEST_ID, self._rid)
        self.send_header(HDR_SERVER_TIMING, self._server_timing())
        self.end_headers()
        self._count(200)
        self.wfile.write(payload)

    def _handle_kv_import(self, body: bytes, trace: RequestTrace) -> None:
        """POST /v1/kv/import — hop 2: decode the framed page stream
        FULLY (a torn stream is rejected before the pool is touched),
        admit the row warm, and serve the remaining decode in the
        client's shape — carried tokens the exporter already emitted are
        prepended, so the client sees one seamless stream."""
        st = self.state
        if st.batcher is None or st.batcher.kv_pages <= 0:
            self._error(400, "KV import needs --batch-window > 0 and "
                             "--kv-pages (paged KV pool)")
            return
        try:
            snap = kv_transfer.decode_snapshot(body)
        except kv_transfer.TransferError as e:
            st._m_kv_imports.inc(outcome="rejected")
            self._error(422, f"rejected KV stream: {e}")
            return
        st._m_kv_bytes.inc(len(body), direction="in")
        st._m_kv_pages.inc(float(snap["n_blocks"]), direction="in")
        extra = snap.get("extra") or {}
        stream = bool(extra.get("stream"))
        carried = [int(t) for t in extra.get("emitted_tokens") or []]
        prompt_tokens = list(snap["prompt"])
        trace.tokens_in = len(prompt_tokens)
        # a v2 stream migrates its stop-string scanback; the carried
        # tokens' text runs through the same detector before any fresh
        # decode, so the stop fires exactly where the solo path's would
        stop_state = snap.get("stop_state")
        detector = (StopDetector.from_state(stop_state)
                    if stop_state else None)
        deadline = self._start_deadline()
        base = {"id": _completion_id(), "object": "chat.completion",
                "created": int(time.time()), "model": st.model_name}
        if stream:
            sampler = SamplerConfig(temperature=float(snap["temp"]),
                                    topp=float(snap["topp"]), seed=0)
            # a migrated stream can opt into checkpointing too — a decode
            # replica death after a migration is just another failover
            ckpt_every, ckpt_wire = self._ckpt_request()
            # pre-pull the FIRST burst before any SSE byte leaves: a row
            # the pool can't admit must answer 5xx (the router's fallback
            # cue), not a 200 stream that dies mid-flight
            cancel = CancelToken()
            gen = st.batcher.submit_import_stream(
                snap, deadline=deadline, cancel=cancel, trace=trace,
                ckpt_every=ckpt_every)
            try:
                first = next(gen, None)
            except LifecycleError:
                raise
            except RuntimeError as e:
                self._error(503, f"KV import failed: {e}")
                return
            self._stream_batched(
                base, sampler, prompt_tokens,
                int(snap["budget"]) - int(snap["emitted"]),
                deadline=deadline, trace=trace, carried=carried,
                source=lambda _c: (itertools.chain([first], gen)
                                   if first is not None else gen),
                cancel=cancel, detector=detector,
                ckpt_every=ckpt_every, ckpt_wire=ckpt_wire)
            return
        try:
            fresh = st.batcher.submit_import(snap, deadline=deadline,
                                             trace=trace)
        except LifecycleError:
            raise
        except RuntimeError as e:
            # includes "no free KV pages": the router's cue to fall back
            self._error(503, f"KV import failed: {e}")
            return
        self._finished_row_response(
            base, prompt_tokens, carried + fresh, stream, trace,
            stops=(list(stop_state["stops"]) if stop_state else None))

    def _handle_kv_resume(self, body: bytes, trace: RequestTrace) -> None:
        """POST /v1/kv/resume — mid-stream failover: decode a dead
        sibling's checkpoint FULLY, admit the row warm, rehydrate the
        dead writer's rendering state (byte offset, half-decoded UTF-8
        tail, pending token, stop-string scanback) and continue the SSE
        stream from the NEXT token. The continued bytes are EXACTLY what
        the dead replica would have written, so the router splices by
        discarding the prefix the client already holds — echoed in the
        X-Dllama-Resume-Offset header before any SSE byte leaves. A row
        this pool can't admit answers 5xx (the router tries the next
        sibling, then degrades to the clean SSE error termination)."""
        st = self.state
        if st.batcher is None or st.batcher.kv_pages <= 0:
            self._error(400, "KV resume needs --batch-window > 0 and "
                             "--kv-pages (paged KV pool)")
            return
        try:
            snap = kv_transfer.decode_snapshot(body)
        except kv_transfer.TransferError as e:
            st._m_kv_imports.inc(outcome="rejected")
            self._error(422, f"rejected KV stream: {e}")
            return
        resume = (snap.get("extra") or {}).get("resume")
        try:
            base = dict(resume["base"])
            bytes.fromhex(str(resume["utf8"][0]))  # validated BEFORE the
            # SSE headers go out — a torn hex tail must 422, not crash a
            # 200 stream
            resume_state = {"bytes": int(resume["bytes"]),
                            "utf8": [str(resume["utf8"][0]),
                                     int(resume["utf8"][1])],
                            "prev": int(resume["prev"]),
                            "n_generated": int(resume["n_generated"])}
        except (KeyError, IndexError, TypeError, ValueError) as e:
            st._m_kv_imports.inc(outcome="rejected")
            self._error(422, f"not a resumable checkpoint: {e}")
            return
        st._m_kv_bytes.inc(len(body), direction="in")
        st._m_kv_pages.inc(float(snap["n_blocks"]), direction="in")
        prompt_tokens = list(snap["prompt"])
        trace.tokens_in = len(prompt_tokens)
        detector = (StopDetector.from_state(snap["stop_state"])
                    if snap.get("stop_state") else None)
        # the resumed stream keeps checkpointing at the router's cadence:
        # a SECOND death mid-resume is just another resume
        ckpt_every, ckpt_wire = self._ckpt_request()
        deadline = self._start_deadline()
        sampler = SamplerConfig(temperature=float(snap["temp"]),
                                topp=float(snap["topp"]), seed=0)
        cancel = CancelToken()
        gen = st.batcher.submit_import_stream(
            snap, deadline=deadline, cancel=cancel, trace=trace,
            ckpt_every=ckpt_every)
        try:
            first = next(gen, None)
        except LifecycleError:
            raise
        except RuntimeError as e:
            # includes "no free KV pages" and "row already finished"
            self._error(503, f"KV resume failed: {e}")
            return
        self._stream_batched(
            base, sampler, prompt_tokens,
            int(snap["budget"]) - int(snap["emitted"]),
            deadline=deadline, trace=trace,
            source=lambda _c: (itertools.chain([first], gen)
                               if first is not None else gen),
            cancel=cancel, detector=detector,
            ckpt_every=ckpt_every, ckpt_wire=ckpt_wire,
            resume_state=resume_state,
            extra_headers={HDR_RESUME_OFFSET:
                           str(resume_state["bytes"])})


def create_server(state: ServerState, host: str = "0.0.0.0", port: int = 9990):
    handler = type("Handler", (OpenAIHandler,), {"state": state})
    srv = ThreadingHTTPServer((host, port), handler)
    # identity binds to the ACTUAL port (port=0 tests get the kernel's
    # pick): port names the replica across restarts, the nonce names this
    # generation of it
    bound = srv.server_address[1]
    state.replica_id = f"{bound}-{state.start_nonce}"
    state.flight.process = f"replica-{bound}"
    # history/alerts start with the listener: a bare ServerState (unit
    # tests, bench replays) stays thread-free, a serving one remembers
    state.sampler.start()
    return srv


def drain_and_shutdown(state: ServerState, srv, drain_timeout_s: float) -> bool:
    """SIGTERM graceful drain: stop admitting (new requests 503 at the
    gate, /ready flips 503 so the balancer stops routing here), wait up to
    ``drain_timeout_s`` for in-flight requests, then stop the listener.
    Returns True when the drain completed with nothing in flight (a False
    means live requests were cut off at the timeout)."""
    state.flight.dump("sigterm")  # the shutdown's black box, written FIRST:
    # if the drain itself wedges, the ring already shows what was in flight
    state.begin_drain()
    idle = state.gate.wait_idle(drain_timeout_s)
    state.sampler.stop()
    srv.shutdown()
    return idle


def serve(args) -> None:
    """Start the server from parsed CLI args (the ``serve`` mode of
    ``dllama_tpu_torch.cli``, analogous to launching the reference's dllama-api
    binary with the same flag set, `dllama-api.cpp:357-362`)."""
    import signal

    from dllama_tpu_torch.cli import load_engine, write_pid_file

    why = unsupported(args.batch_window, args.kv_buckets, args.kv_pages, args.role)
    if why is not None:  # refused before the model loads
        raise SystemExit(f"❌ {why}")
    engine, tok, cfg = load_engine(args)
    state = ServerState(
        engine, tok, cfg,
        model_name=args.model.rsplit("/", 1)[-1],
        template=args.chat_template,
        # default_sampler carries only temperature/topp; the per-request seed
        # comes from default_seed (single source of truth)
        default_sampler=SamplerConfig(temperature=args.temperature, topp=args.topp),
        default_seed=args.seed,
        spec_draft=getattr(args, "spec_draft", 0),
        session_cache=getattr(args, "session_cache", 2),
        batch_window_ms=getattr(args, "batch_window", 0.0),
        batch_max=getattr(args, "batch_max", 8),
        batch_chunk=getattr(args, "batch_chunk", 8),
        prefill_chunk=getattr(args, "prefill_chunk", -1),
        kv_buckets=getattr(args, "kv_buckets", 1),
        kv_bucket_min=getattr(args, "kv_bucket_min", 0),
        kv_pages=getattr(args, "kv_pages", 0),
        request_timeout=getattr(args, "request_timeout", 0.0),
        queue_depth=getattr(args, "queue_depth", 64),
        log_json=getattr(args, "log_json", False),
        log_prompts=getattr(args, "log_prompts", False),
        role=getattr(args, "role", "both") or "both",
        ckpt_interval=getattr(args, "ckpt_interval", 32),
        slo_classes=getattr(args, "slo_classes", None),
        ts_interval=getattr(args, "ts_interval", 1.0),
        burn_short=getattr(args, "burn_short", 60.0),
        burn_long=getattr(args, "burn_long", 300.0),
    )
    srv = create_server(state, host=args.host, port=args.port)
    # label this pid's track group in a merged fleet trace (no-op when
    # DLLAMA_TRACE is unset)
    observability.emit_process_name(f"replica:{args.port}")
    pid_path = getattr(args, "pid_file", None)
    if pid_path:
        write_pid_file(pid_path)
    drain_timeout_s = getattr(args, "drain_timeout", 30.0)

    def _on_sigterm(_signum, _frame):
        # drain OFF the signal frame: srv.shutdown() blocks until
        # serve_forever exits, and wait_idle may sleep for the full drain
        # window — neither belongs in a signal handler
        print(f"⛔ SIGTERM: draining (up to {drain_timeout_s:.0f}s) ...")
        threading.Thread(
            target=drain_and_shutdown, args=(state, srv, drain_timeout_s),
            daemon=True, name="dllama-drain").start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded/test use): no signal hook
    print(f"📡 listening on {args.host}:{args.port} "
          "(POST /v1/chat/completions, GET /v1/models /metrics /stats)")
    try:
        srv.serve_forever()
    finally:
        if pid_path:
            try:
                os.remove(pid_path)
            except OSError:
                pass  # pid file already gone (drain path) or never written


def main(argv=None) -> None:
    import sys

    from dllama_tpu_torch.cli import build_parser

    if argv is None:
        argv = sys.argv[1:]
    serve(build_parser().parse_args(["serve"] + list(argv)))


if __name__ == "__main__":
    main()
