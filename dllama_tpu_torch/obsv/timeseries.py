"""Fixed-memory time-series ring store + the sampler thread that feeds it.

The store holds one bounded ring of ``(t_s, value)`` points per series.
A series is one sampled number: a counter/gauge child keeps its label
set verbatim; a histogram child fans out into ``:p50``/``:p95``/``:p99``
percentile series plus a ``:count`` series, because percentiles are the
thing a burn-rate engine and a sparkline actually want. Memory is bounded
twice — per-ring ``capacity`` points and ``max_series`` rings — so a
label-cardinality accident degrades into dropped series (counted in the
window payload), never unbounded growth.

The :class:`Sampler` is a daemon thread snapshotting a
``MetricsRegistry`` into the store every ``interval_s`` (``--ts-interval``;
0 disables). Each pass fires the ``ts_sample`` fault seam and counts into
``dllama_ts_samples_total{outcome}`` — an injected or real sampling
failure is a skipped pass, never a dead sampler and never an exception in
the serving process.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from dllama_tpu_torch import faults
from dllama_tpu_torch.analysis.sanitize import guarded_by


def parse_window(path: str, default_s: float = 300.0) -> float:
    """The ``?window=S`` query of a /metrics/history request (seconds)."""
    _, _, q = path.partition("?")
    for part in q.split("&"):
        k, _, v = part.partition("=")
        if k == "window":
            try:
                return max(0.0, float(v))
            except ValueError:
                return default_s
    return default_s


def series_key(name: str, labels: dict, field: Optional[str] = None) -> str:
    """Canonical series key: ``name[:field]{k="v",...}`` (labels sorted)."""
    head = f"{name}:{field}" if field else name
    if not labels:
        return head
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{head}{{{inner}}}"


def parse_series_key(key: str) -> Tuple[str, Optional[str], dict]:
    """Invert :func:`series_key` -> (family, field, labels)."""
    head, _, rest = key.partition("{")
    name, _, field = head.partition(":")
    labels: Dict[str, str] = {}
    for part in filter(None, rest.rstrip("}").split(",")):
        k, _, v = part.partition("=")
        labels[k] = v.strip('"')
    return name, field or None, labels


@guarded_by("_lock", "_series", "_dropped_series", "_samples")
class TimeSeriesStore:
    """Bounded in-process history of sampled metric values.

    ``capacity`` points per series ring (oldest shed first), at most
    ``max_series`` rings; both are hard bounds, so the store's memory is
    fixed no matter how long the process lives or how hostile the label
    cardinality gets.
    """

    def __init__(self, capacity: int = 720, max_series: int = 4096):
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        self._series: Dict[str, collections.deque] = {}
        self._dropped_series = 0  # keys refused at the max_series bound
        self._samples = 0         # sample passes recorded

    def record(self, key: str, t_s: float, value: float) -> bool:
        """Append one point; False when the series bound refused the key."""
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    return False
                ring = collections.deque(maxlen=self.capacity)
                self._series[key] = ring
            ring.append((t_s, float(value)))
        return True

    def sample_registry(self, registry, t_s: Optional[float] = None) -> int:
        """One sampling pass over ``registry.snapshot()``; returns the
        number of points written. Histogram children fan out into
        percentile + count series; counters/gauges record verbatim."""
        now = time.time() if t_s is None else t_s
        n = 0
        for name, fam in registry.snapshot().items():
            for v in fam["values"]:
                labels = v.get("labels") or {}
                if fam["kind"] == "histogram":
                    for field in ("p50", "p95", "p99"):
                        pv = v.get(field)
                        if pv is not None:
                            n += self.record(
                                series_key(name, labels, field), now, pv)
                    n += self.record(series_key(name, labels, "count"),
                                     now, float(v.get("count", 0)))
                else:
                    n += self.record(series_key(name, labels), now,
                                     float(v.get("value", 0.0)))
        with self._lock:
            self._samples += 1
        return n

    def points(self, key: str, window_s: float,
               now_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """The key's points with ``t >= now - window_s`` (oldest first)."""
        now = time.time() if now_s is None else now_s
        with self._lock:
            ring = self._series.get(key)
            pts = list(ring) if ring is not None else []
        lo = now - max(0.0, window_s)
        return [(t, v) for (t, v) in pts if t >= lo]

    def family_keys(self, family: str) -> List[str]:
        """Every stored series key whose metric family is ``family``."""
        with self._lock:
            keys = list(self._series)
        return [k for k in keys if parse_series_key(k)[0] == family]

    def window(self, window_s: float,
               now_s: Optional[float] = None) -> dict:
        """JSON-ready windowed dump for ``GET /metrics/history``."""
        now = time.time() if now_s is None else now_s
        lo = now - max(0.0, window_s)
        with self._lock:
            items = sorted(self._series.items())
            dropped = self._dropped_series
            samples = self._samples
        series = {}
        for key, ring in items:
            pts = [[round(t, 3), v] for (t, v) in ring if t >= lo]
            if pts:
                series[key] = pts
        return {"now_s": round(now, 3), "window_s": window_s,
                "capacity": self.capacity, "samples": samples,
                "dropped_series": dropped, "series": series}


@guarded_by("_lock", "_thread")
class Sampler:
    """Daemon sampling loop: registry -> store, every ``interval_s``.

    ``hooks`` run after each pass (outside every lock) with the pass
    timestamp — the burn-rate engine rides here so alert evaluation
    shares the sampling cadence. A hook exception is that hook's problem
    (the engine swallows its own); the sampler never dies of one pass.
    """

    def __init__(self, registry, store: TimeSeriesStore,
                 interval_s: float = 1.0, hooks=()):
        self.registry = registry
        self.store = store
        self.interval_s = max(0.0, float(interval_s))
        self.hooks = tuple(hooks)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_samples = registry.counter(
            "dllama_ts_samples_total",
            "Time-series sampler passes, by outcome (fault = the ts_sample "
            "seam fired, error = a real sampling failure; either way the "
            "pass is skipped and the sampler lives)",
            ("outcome",))

    def sample_once(self, now_s: Optional[float] = None) -> bool:
        """One pass; False when the pass was skipped (fault/error)."""
        try:
            faults.fire("ts_sample")
            self.store.sample_registry(self.registry, t_s=now_s)
        except faults.FaultInjected:
            self._m_samples.inc(outcome="fault")
            return False
        except Exception:  # noqa: BLE001 — the sampler is advisory: a
            # torn snapshot must never surface in the serving process
            self._m_samples.inc(outcome="error")
            return False
        self._m_samples.inc(outcome="ok")
        for hook in self.hooks:
            hook(now_s)
        return True

    def start(self) -> None:
        """Start the loop (idempotent; a no-op at ``interval_s`` 0)."""
        if self.interval_s <= 0:
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dllama-ts-sampler")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=timeout_s)
