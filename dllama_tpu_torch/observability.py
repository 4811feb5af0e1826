"""Dependency-free serving telemetry: metrics, request traces, structured logs.

Three cooperating pieces, all stdlib-only (matching the repo's no-deps style):

* ``MetricsRegistry`` — hand-rolled Counter / Gauge / Histogram families with
  Prometheus text exposition (``render()``) and a JSON snapshot (``snapshot()``)
  for the ``/stats`` endpoint.  Metric handles are get-or-create so every layer
  (server, scheduler, engine, weights I/O) can register against the shared
  default registry without import-order coupling.  The hot path of a disabled
  component is a single ``is not None`` check, mirroring ``faults.fire``.

* ``RequestTrace`` — per-request phase marks (queue wait, prefill, decode,
  first/last token) accumulated lock-free by whichever thread owns the phase
  (HTTP handler or scheduler) and read once at completion.  ``finish`` turns
  the marks into derived latencies (TTFT, TPOT, queue-wait) plus Chrome
  trace-event spans.

* Trace/log emitters — ``DLLAMA_TRACE=<path>`` streams Chrome trace events
  (JSON Array Format: one event per line, ``]`` intentionally omitted as the
  format allows, loadable by Perfetto and chrome://tracing), and
  ``log_json_line`` prints one structured JSON log line per request.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import math
import os
import threading
import time
import uuid
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .analysis.sanitize import guard_globals, guarded_by

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RequestTrace",
    "default_registry",
    "configure_trace",
    "trace_path",
    "emit_trace_events",
    "emit_process_name",
    "merge_trace_parts",
    "flight_recorder",
    "log_json_line",
    "prompt_digest",
    "new_request_id",
    "next_span_id",
    "mono_to_us",
    "parent_span_value",
    "sanitize_parent_span",
    "server_timing_header",
    "parse_server_timing",
    "scheduler_trace_event",
    "SCHEDULER_TID",
    "LATENCY_BUCKETS_MS",
    "TOKEN_BUCKETS",
]

# Default latency buckets (milliseconds). Wide enough for CPU-smoke prefill
# (hundreds of ms) down to per-chunk decode on hardware (single-digit ms).
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

# Token-COUNT buckets: powers of two, matching the engine's prefill/KV
# bucket ladder, so a token histogram reads directly as "which KV bucket
# would this request land in". Token series must NOT reuse the
# latency-tuned boundaries above — a 30-token prompt and a 30ms chunk are
# different axes.
TOKEN_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0, 8192.0, 16384.0,
)

_RESERVOIR_CAP = 2048  # per-series ring of raw samples, for percentiles


def _escape_label(value: object) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


@guarded_by("_lock", "_children")
class _Metric:
    """Common family machinery: label keying, child storage, exposition.

    ``_lock`` is the owning registry's RLock (shared across every family in
    the registry): exposition iterates families under it, so per-family
    locks would only add an ordering hazard. ``_children`` rebinds are
    guarded; per-key item writes happen under the same ``with self._lock``
    blocks (the static pass checks both)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._registry = registry
        self._lock = registry._lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    # Subclasses implement render_into(lines) and snapshot_values().


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._children.get(key, 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._children.values()))

    def render_into(self, lines: List[str]) -> None:
        with self._lock:
            items = sorted(self._children.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for key, v in items:
            lines.append(f"{self.name}{self._label_str(key)} {_fmt_value(v)}")

    def snapshot_values(self) -> List[dict]:
        with self._lock:
            items = sorted(self._children.items())
        return [
            {"labels": dict(zip(self.labelnames, key)), "value": v}
            for key, v in items
        ]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            cur = self._children.get(key, 0.0)
            self._children[key] = (cur if isinstance(cur, float) else 0.0) + amount

    def set_function(self, fn: Callable[[], float], **labels: object) -> None:
        """Callback gauge: ``fn`` is sampled at render/snapshot time.

        Re-registering replaces the previous callback, so short-lived owners
        (test fixtures, benches) can safely rebind the same series.
        """
        key = self._key(labels)
        with self._lock:
            self._children[key] = fn

    def value(self, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            v = self._children.get(key, 0.0)
        return self._resolve(v)

    @staticmethod
    def _resolve(v: object) -> float:
        if callable(v):
            try:
                return float(v())
            except Exception:
                return float("nan")  # stale callback (owner torn down)
        return float(v)  # type: ignore[arg-type]

    def render_into(self, lines: List[str]) -> None:
        with self._lock:
            items = sorted(self._children.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for key, v in items:
            val = self._resolve(v)
            if math.isnan(val):
                continue
            lines.append(f"{self.name}{self._label_str(key)} {_fmt_value(val)}")

    def snapshot_values(self) -> List[dict]:
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, v in items:
            val = self._resolve(v)
            if math.isnan(val):
                continue
            out.append({"labels": dict(zip(self.labelnames, key)), "value": val})
        return out


class _HistChild:
    __slots__ = ("bucket_counts", "sum", "count", "samples", "_ring")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # cumulative at render time only
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []
        self._ring = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, registry,
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS):
        super().__init__(name, help, labelnames, registry)
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != math.inf:
            bs.append(math.inf)
        self.buckets: Tuple[float, ...] = tuple(bs)

    def observe(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _HistChild(len(self.buckets))
                self._children[key] = child
            for i, b in enumerate(self.buckets):
                if v <= b:
                    child.bucket_counts[i] += 1
                    break
            child.sum += v
            child.count += 1
            if len(child.samples) < _RESERVOIR_CAP:
                child.samples.append(v)
            else:
                child.samples[child._ring % _RESERVOIR_CAP] = v
            child._ring += 1

    def count(self, **labels: object) -> int:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            return child.count if child is not None else 0

    def total_count(self) -> int:
        with self._lock:
            return sum(c.count for c in self._children.values())

    def percentile(self, p: float, **labels: object) -> float:
        """Percentile over the raw-sample reservoir (nan when empty)."""
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            samples = list(child.samples) if child is not None else []
        if not samples:
            return float("nan")
        samples.sort()
        idx = min(len(samples) - 1, max(0, int(round((p / 100.0) * (len(samples) - 1)))))
        return samples[idx]

    def render_into(self, lines: List[str]) -> None:
        with self._lock:
            items = sorted(
                (k, list(c.bucket_counts), c.sum, c.count)
                for k, c in self._children.items()
            )
        for key, bucket_counts, total, count in items:
            cum = 0
            for b, n in zip(self.buckets, bucket_counts):
                cum += n
                extra = f'le="{_fmt_value(b)}"'
                lines.append(
                    f"{self.name}_bucket{self._label_str(key, extra)} {cum}"
                )
            lines.append(f"{self.name}_sum{self._label_str(key)} {_fmt_value(total)}")
            lines.append(f"{self.name}_count{self._label_str(key)} {count}")

    def snapshot_values(self) -> List[dict]:
        with self._lock:
            items = sorted(
                (k, c.sum, c.count, list(c.samples))
                for k, c in self._children.items()
            )
        out = []
        for key, total, count, samples in items:
            samples.sort()

            def pct(p: float) -> Optional[float]:
                if not samples:
                    return None
                i = min(len(samples) - 1,
                        max(0, int(round((p / 100.0) * (len(samples) - 1)))))
                return samples[i]

            out.append({
                "labels": dict(zip(self.labelnames, key)),
                "count": count,
                "sum": round(total, 3),
                "p50": pct(50), "p95": pct(95), "p99": pct(99),
            })
        return out


@guarded_by("_lock", "_metrics")
class MetricsRegistry:
    """Get-or-create registry of metric families with Prometheus exposition."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Iterable[str], **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} "
                        f"labels={labelnames}, existing {m.kind} labels={m.labelnames}"
                    )
                return m
            m = cls(name, help, labelnames, self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)  # type: ignore[return-value]

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            m.render_into(lines)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-friendly dump for /stats: histograms carry p50/p95/p99."""
        out: Dict[str, dict] = {}
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "values": m.snapshot_values()}
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


# ---------------------------------------------------------------------------
# Chrome trace-event output (DLLAMA_TRACE=<path>)

_trace_lock = threading.RLock()  # re-entrant: trace_path -> configure_trace
_trace_path: Optional[str] = None
_trace_file = None
_trace_env_checked = False
guard_globals("_trace_lock", "_trace_path", "_trace_file",
              "_trace_env_checked")

# Wall-clock anchor so monotonic phase marks land on the epoch timeline.
_T0_MONO = time.monotonic()
_T0_EPOCH_US = int(time.time() * 1e6)


def _mono_to_us(t_mono: float) -> int:
    return _T0_EPOCH_US + int((t_mono - _T0_MONO) * 1e6)


def mono_to_us(t_mono: Optional[float] = None) -> int:
    """This process's trace-timeline clock (µs since epoch, monotonic-anchored).

    Replicas report it on ``/ready`` (``time_us``) so the router can estimate
    the per-replica clock offset from its probe round trip (skew + RTT/2) and
    merge fleet trace parts onto one skew-corrected timeline."""
    return _mono_to_us(time.monotonic() if t_mono is None else t_mono)


def configure_trace(path: Optional[str]) -> None:
    """Point span output at ``path`` (truncates), or disable with None."""
    global _trace_path, _trace_file, _trace_env_checked
    with _trace_lock:
        if _trace_file is not None:
            try:
                _trace_file.close()
            except OSError:
                pass  # best-effort close on reconfigure; the handle is
                # dropped either way and tracing is advisory
            _trace_file = None
        _trace_path = path or None
        _trace_env_checked = True
        if _trace_path:
            # Chrome JSON Array Format: open bracket now, one event per line,
            # closing bracket optional per the spec — Perfetto loads it as-is.
            _trace_file = open(_trace_path, "w", encoding="utf-8")
            _trace_file.write("[\n")
            _trace_file.flush()


def trace_path() -> Optional[str]:
    global _trace_env_checked
    if not _trace_env_checked:
        # double-checked under the lock (an RLock so configure_trace can
        # re-enter): two first callers racing here used to publish
        # _trace_env_checked lock-free (dllama-check LOCK-004) — one could
        # observe the flag set with configuration still in flight
        with _trace_lock:
            if not _trace_env_checked:
                env = os.environ.get("DLLAMA_TRACE")
                if env:
                    configure_trace(env)  # sets _trace_env_checked
                else:
                    _trace_env_checked = True
    return _trace_path


def emit_trace_events(events: List[dict]) -> None:
    if trace_path() is None or not events:
        return
    with _trace_lock:
        f = _trace_file
        if f is None:
            return
        try:
            for e in events:
                f.write(json.dumps(e, separators=(",", ":")) + ",\n")
            f.flush()
        except OSError:
            pass  # tracing is advisory: a full disk or closed file must
            # never fail the request being traced


def emit_process_name(name: str) -> None:
    """Label this pid's track group in Perfetto (``process_name`` metadata).

    In a merged fleet trace the router and each replica keep distinct pids;
    this is what makes the merged file read "router" / "replica:9990"
    instead of bare numbers."""
    emit_trace_events([{
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": name},
    }])


def merge_trace_parts(base_path: str,
                      parts: Sequence[Tuple[str, float]]) -> int:
    """Append per-process trace part files onto ``base_path``'s timeline.

    ``parts`` is ``(path, delta_us)`` pairs; ``delta_us`` is ADDED to every
    event's ``ts`` — pass the NEGATED estimated clock offset of the part's
    process relative to the base process, so its spans land skew-corrected
    on the base timeline. The line-per-event Chrome JSON Array format (no
    closing bracket) makes this a line rewrite, not a JSON-document merge.
    Returns the number of events merged; unreadable parts and unparsable
    lines are skipped (merging is advisory, like tracing itself)."""
    n = 0
    try:
        out = open(base_path, "a", encoding="utf-8")
    except OSError:
        return 0
    with out:
        for path, delta_us in parts:
            try:
                fh = open(path, "r", encoding="utf-8")
            except OSError:
                continue  # a missing/unreadable part (replica never wrote
                #            a trace) skips, the rest still merge
            with fh:
                for line in fh:
                    line = line.strip().rstrip(",")
                    if not line or line in ("[", "]"):
                        continue
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue  # a torn line from a killed writer is
                        #            expected in a crash-path merge
                    if "ts" in e:
                        e["ts"] = int(e["ts"] + delta_us)
                    try:
                        out.write(json.dumps(e, separators=(",", ":")) + ",\n")
                    except OSError:
                        return n
                    n += 1
    return n


# ---------------------------------------------------------------------------
# Structured JSON logs

_log_lock = threading.Lock()


def log_json_line(record: dict, stream=None) -> None:
    """One JSON object per line; safe under concurrent request threads."""
    import sys
    out = stream if stream is not None else sys.stdout
    line = json.dumps(record, separators=(",", ":"), sort_keys=True)
    with _log_lock:
        try:
            out.write(line + "\n")
            out.flush()
        except (OSError, ValueError):
            pass  # a closed/full log stream must never take down serving


def prompt_digest(text: str) -> str:
    """Privacy-preserving prompt identifier: short sha256, never the text."""
    return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()[:16]


def new_request_id() -> str:
    return "req-" + uuid.uuid4().hex[:20]


# Monotonic span-id allocator for trace tracks. Tid 0 is the scheduler's
# track; every RequestTrace takes the next id at construction, so
# concurrent requests get DISTINCT, stable, collision-free tracks (the old
# hashed-request-id tid could collide and scattered tracks randomly across
# the tid space, which kept request spans from nesting under the scheduler
# track group in Perfetto).
SCHEDULER_TID = 0
_span_ids = itertools.count(1)
_span_lock = threading.Lock()


def next_span_id() -> int:
    with _span_lock:
        return next(_span_ids)


def scheduler_trace_event(name: str, t_a: float, t_b: float,
                          args: Optional[dict] = None) -> dict:
    """A complete-event on the scheduler track (tid 0): batcher windows and
    other engine-wide phases, under which per-request tracks group."""
    return {
        "name": name, "ph": "X", "pid": os.getpid(), "tid": SCHEDULER_TID,
        "ts": _mono_to_us(t_a), "dur": max(1, int((t_b - t_a) * 1e6)),
        "cat": "scheduler", "args": args or {},
    }


def sanitize_request_id(raw: Optional[str]) -> str:
    """Honor a client X-Request-Id if it is sane, else mint one."""
    if raw:
        rid = "".join(c for c in raw.strip() if c.isprintable() and c not in '",\\')
        if 0 < len(rid) <= 128:
            return rid
    return new_request_id()


# ---------------------------------------------------------------------------
# Cross-process trace stitching (X-Dllama-Parent-Span hop header)

def parent_span_value(span_id: int) -> str:
    """The ``X-Dllama-Parent-Span`` value the router sends upstream:
    ``<router_pid>:<router_span_id>`` — globally unique across the fleet's
    processes, and used verbatim as the Chrome flow-event id binding the
    router's proxy span to the replica's request span in the merged file."""
    return f"{os.getpid()}:{int(span_id)}"


def sanitize_parent_span(raw: Optional[str]) -> Optional[str]:
    """Accept a hop header only in the exact shape the router mints (two
    decimal fields); anything else is ignored — a malformed value must not
    leak into the trace file or flow-event ids."""
    if not raw:
        return None
    raw = raw.strip()
    pid, sep, span = raw.partition(":")
    if sep and pid.isdigit() and span.isdigit() and len(raw) <= 64:
        return raw
    return None


def flow_start_event(flow_id: str, tid: int, t_mono: float) -> dict:
    """Flow-arrow start ('ph':'s') on the ROUTER's proxy track; the replica
    emits the matching finish so Perfetto draws router→replica arrows."""
    return {"name": "hop", "ph": "s", "cat": "flow", "id": flow_id,
            "pid": os.getpid(), "tid": tid, "ts": _mono_to_us(t_mono)}


# ---------------------------------------------------------------------------
# Server-Timing (per-hop latency attribution)

def server_timing_header(trace: "RequestTrace") -> str:
    """Render the replica's phase durations as a ``Server-Timing`` response
    header (``queue;dur=…, prefill;dur=…, decode;dur=…``). Phases not yet
    known at header time (e.g. decode on an SSE response whose headers go
    out before tokens) are simply omitted — the header is additive."""
    parts = []
    q = trace.queue_wait_ms
    if q is not None:
        parts.append(f"queue;dur={q:.3f}")
    if trace.prefill_ms is not None:
        parts.append(f"prefill;dur={trace.prefill_ms:.3f}")
    if trace.t_first is not None and trace.t_last is not None:
        parts.append(f"decode;dur={(trace.t_last - trace.t_first) * 1e3:.3f}")
    return ", ".join(parts)


def parse_server_timing(header: Optional[str]) -> Dict[str, float]:
    """Parse ``Server-Timing`` into {metric_name: dur_ms}; entries without a
    ``dur`` param (legal per the spec) are skipped, garbage is ignored."""
    out: Dict[str, float] = {}
    if not header:
        return out
    for item in header.split(","):
        name, _, params = item.strip().partition(";")
        name = name.strip()
        if not name:
            continue
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k.strip().lower() == "dur":
                try:
                    out[name] = float(v.strip().strip('"'))
                except ValueError:
                    pass  # a garbled dur from a foreign server: skip the
                    #       entry, keep parsing the rest of the header
                break
    return out


# ---------------------------------------------------------------------------
# SSE event framing (mid-stream failover)

class SSEScanner:
    """Incremental server-sent-events splitter: feed raw socket chunks,
    get back complete ``\\n\\n``-terminated events as they close. The
    router's resumable relay uses this to strip checkpoint control frames
    and count forwarded bytes exactly; tests use it to assert splice
    arithmetic. Single-threaded by construction (one relay loop owns one
    scanner), so no lock.

    The scanner is name-agnostic: every *registered* event name a caller
    matches against lives in ``serving/protocol.SSE_EVENTS`` (dllama-check
    PROTO-002 bans raw event literals at the call sites)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list:
        """Append ``chunk``; return every COMPLETE event now available,
        each as raw bytes INCLUDING its terminating blank line — so
        forwarding the returned events verbatim plus :meth:`tail` at EOF
        reproduces the input byte-for-byte."""
        self._buf += chunk
        out = []
        while True:
            i = self._buf.find(b"\n\n")
            if i < 0:
                return out
            out.append(bytes(self._buf[:i + 2]))
            del self._buf[:i + 2]

    def tail(self) -> bytes:
        """Bytes buffered past the last complete event (flush at EOF)."""
        return bytes(self._buf)


def sse_event_fields(event: bytes) -> Dict[str, bytes]:
    """Minimal SSE field parse of one complete event: ``{field: value}``
    with multi-``data`` lines joined by ``\\n`` per the SSE spec; comment
    lines (leading ``:``) and garbage are skipped."""
    fields: Dict[str, bytes] = {}
    for line in event.split(b"\n"):
        if not line or line.startswith(b":"):
            continue
        name, sep, value = line.partition(b":")
        if not sep:
            continue
        if value.startswith(b" "):
            value = value[1:]
        key = name.decode("ascii", "replace")
        fields[key] = (fields[key] + b"\n" + value) if key in fields \
            else value
    return fields


# ---------------------------------------------------------------------------
# Flight recorder: the process's black box

@guarded_by("_lock", "_events", "_seq")
class FlightRecorder:
    """Bounded ring of recent structured events — the process's black box.

    Request admits/rejections, chunk ticks, fired faults and 5xx responses
    land here as tiny dicts; on crash, deadline (504), quarantine or SIGTERM
    the ring is dumped to ``$DLLAMA_FLIGHT/flight-<process>-<pid>-<reason>.json``
    so the incident ships its own evidence instead of requiring a repro.
    ``record`` is O(1) and allocation-bounded (deque maxlen); ``dump`` never
    raises — a black box that can crash the plane is worse than none.
    """

    def __init__(self, capacity: int = 256, process: str = "server"):
        self.capacity = max(8, int(capacity))
        self.process = process  # display name; rebound once by create_server
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seq = 0

    def record(self, kind: str, **fields: object) -> None:
        e = dict(fields)
        e["kind"] = kind
        e["t_us"] = _mono_to_us(time.monotonic())
        with self._lock:
            self._seq += 1
            e["seq"] = self._seq
            self._events.append(e)

    def snapshot(self) -> dict:
        """The ring as JSON-ready dict (``seq`` tells how much history the
        bounded ring has already shed)."""
        with self._lock:
            events = list(self._events)
            seq = self._seq
        return {"process": self.process, "pid": os.getpid(),
                "capacity": self.capacity, "seq": seq, "events": events}

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``path`` (or under ``$DLLAMA_FLIGHT``); returns
        the file written, or None (env unset, or the write failed — either
        way the caller's crash/drain path proceeds untouched)."""
        snap = self.snapshot()
        snap["reason"] = reason
        snap["dumped_at_us"] = _mono_to_us(time.monotonic())
        try:
            from . import faults
            faults.fire("flight_dump")
            target = path
            if target is None:
                d = os.environ.get("DLLAMA_FLIGHT")
                if not d:
                    return None
                os.makedirs(d, exist_ok=True)
                target = os.path.join(
                    d, f"flight-{self.process}-{os.getpid()}-{reason}.json")
            with open(target, "w", encoding="utf-8") as f:
                json.dump(snap, f, separators=(",", ":"))
            _M_FLIGHT_DUMPS.inc(reason=reason)
            return target
        except Exception:  # noqa: BLE001 — incl. injected FaultInjected:
            # the black box must never take down the process it observes
            _M_FLIGHT_DUMPS.inc(reason="error")
            return None


# Dump accounting on the shared default registry so every process exposes
# it from first scrape; the reason label distinguishes crash/504/sigterm
# dumps from failed ones ("error").
_M_FLIGHT_DUMPS = _DEFAULT.counter(
    "dllama_flight_dumps_total",
    "Flight-recorder ring dumps, by trigger reason (error = dump failed)",
    ("reason",))

# Process-global recorder for code with no handle to a server/router state
# (lifecycle's module-level error paths); states that want isolation (the
# router; in-process multi-replica tests) construct their own.
_flight_lock = threading.Lock()
_flight: Optional[FlightRecorder] = None
guard_globals("_flight_lock", "_flight")


def flight_recorder() -> FlightRecorder:
    global _flight
    with _flight_lock:
        if _flight is None:
            _flight = FlightRecorder()
        return _flight


# ---------------------------------------------------------------------------
# Per-request trace

class RequestTrace:
    """Phase marks for one request; each field is written by exactly one
    thread (handler or scheduler) and read after completion, so no lock."""

    __slots__ = (
        "request_id", "span_id", "parent_span", "t0", "path", "t_start",
        "prefill_ms", "t_first", "t_last", "admission_depth", "queue_depth",
        "tokens_in", "tokens_out", "finish_reason", "status",
        "prompt_sha", "prompt_text", "model", "prefill_chunks", "slo_class",
    )

    def __init__(self, request_id: str, parent_span: Optional[str] = None):
        self.request_id = request_id
        #: the router hop's span ("<pid>:<span_id>", from
        #: X-Dllama-Parent-Span via sanitize_parent_span) — None on a solo
        #: server, where trace output is byte-for-byte what it always was
        self.parent_span = parent_span
        #: this request's trace track: a real allocated span id (see
        #: next_span_id), never a hash of the request id
        self.span_id = next_span_id()
        self.t0 = time.monotonic()
        self.path: Optional[str] = None       # solo | spec | continuous | n_batch
        self.t_start: Optional[float] = None  # decode admitted / lock acquired
        self.prefill_ms: Optional[float] = None
        self.t_first: Optional[float] = None  # first token produced
        self.t_last: Optional[float] = None
        self.admission_depth: int = 0         # gate depth at admission
        self.queue_depth: int = 0             # batcher backlog at enqueue
        self.tokens_in: int = 0
        self.tokens_out: int = 0
        self.finish_reason: Optional[str] = None
        self.status: int = 0
        self.prompt_sha: Optional[str] = None
        #: raw prompt text — ONLY populated when the server runs with
        #: --log-prompts; never written to logs otherwise (privacy default)
        self.prompt_text: Optional[str] = None
        self.model: Optional[str] = None
        #: the request's SLO lane ("interactive"/"batch", from
        #: X-Dllama-Class) — drives the per-class TTFT/TPOT series
        self.slo_class: str = "interactive"
        #: (t_begin, t_end) monotonic pairs, one per chunked-prefill piece
        self.prefill_chunks: List[tuple] = []

    # -- marks (cheap; called from scheduler/handler hot paths) --

    def mark_start(self, path: str) -> None:
        if self.t_start is None:
            self.t_start = time.monotonic()
        self.path = path

    def mark_prefill(self, ms: float) -> None:
        self.prefill_ms = ms

    def mark_prefill_chunk(self, t_begin: float, t_end: float) -> None:
        """One incremental prefill piece ran for this request (chunked
        admission): a child span per piece shows exactly where the prompt's
        consumption interleaved with the pool's decode chunks."""
        self.prefill_chunks.append((t_begin, t_end))

    def mark_token(self) -> None:
        now = time.monotonic()
        if self.t_first is None:
            self.t_first = now
        self.t_last = now

    # -- derived latencies --

    @property
    def queue_wait_ms(self) -> Optional[float]:
        if self.t_start is None:
            return None
        return (self.t_start - self.t0) * 1e3

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t0) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        if self.t_first is None or self.t_last is None or self.tokens_out < 2:
            return None
        return (self.t_last - self.t_first) * 1e3 / (self.tokens_out - 1)

    # -- emission --

    def record(self) -> dict:
        r = {
            "event": "request",
            "request_id": self.request_id,
            "path": self.path,
            "status": self.status,
            "finish_reason": self.finish_reason,
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "admission_depth": self.admission_depth,
            "queue_depth": self.queue_depth,
            "slo_class": self.slo_class,
            "queue_wait_ms": _r(self.queue_wait_ms),
            "prefill_ms": _r(self.prefill_ms),
            "ttft_ms": _r(self.ttft_ms),
            "tpot_ms": _r(self.tpot_ms),
            "total_ms": _r((time.monotonic() - self.t0) * 1e3),
        }
        if self.prompt_sha:
            r["prompt_sha256"] = self.prompt_sha
        if self.model:
            r["model"] = self.model
        return r

    def trace_events(self) -> List[dict]:
        """Chrome complete-events ('ph':'X'), one track per request so child
        spans (queue_wait / prefill / decode) nest under the request span.
        The track's tid is the request's allocated ``span_id`` — sequential
        and collision-free, so concurrent request tracks line up right
        after the scheduler track (tid 0) instead of scattering across the
        hashed tid space — plus a thread_name metadata event so Perfetto
        labels the track with the request id."""
        end = time.monotonic()
        pid = os.getpid()
        tid = self.span_id
        args = {"request_id": self.request_id, "path": self.path,
                "tokens_in": self.tokens_in, "tokens_out": self.tokens_out,
                "finish_reason": self.finish_reason}
        if self.parent_span:
            args["parent_span"] = self.parent_span

        def ev(name: str, t_a: float, t_b: float, extra: Optional[dict] = None) -> dict:
            return {
                "name": name, "ph": "X", "pid": pid, "tid": tid,
                "ts": _mono_to_us(t_a),
                "dur": max(1, int((t_b - t_a) * 1e6)),
                "cat": "request", "args": extra or {},
            }

        events = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": f"req {self.request_id}"}},
            ev("request", self.t0, end, args),
        ]
        if self.parent_span:
            # Flow-arrow finish: binds this replica-side request span to the
            # router's proxy span (which emitted the matching 'ph':'s' with
            # the same id) so the merged fleet trace draws the hop.
            events.append({
                "name": "hop", "ph": "f", "bp": "e", "cat": "flow",
                "id": self.parent_span, "pid": pid, "tid": tid,
                "ts": _mono_to_us(self.t0),
            })
        if self.t_start is not None:
            events.append(ev("queue_wait", self.t0, self.t_start))
            if self.prefill_ms is not None and not self.prefill_chunks:
                pf_end = min(end, self.t_start + self.prefill_ms / 1e3)
                events.append(ev("prefill", self.t_start, pf_end))
        for i, (t_a, t_b) in enumerate(self.prefill_chunks):
            events.append(ev("prefill_chunk", t_a, min(end, t_b),
                             {"chunk": i}))
        if self.t_first is not None and self.t_last is not None:
            events.append(ev("decode", self.t_first, min(end, self.t_last),
                             {"tokens": self.tokens_out}))
        return events


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)
