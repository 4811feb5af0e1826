"""Multi-window SLO burn-rate evaluation over the time-series store.

A *burn rate* of 1.0 means the signal is running exactly at its target;
2.0 means twice the budget is burning. For the latency signals (per-class
TTFT/TPOT p95 against the ``ttft=``/``tpot=`` targets of
``--slo-classes``) the burn is ``mean(p95 over window) / target``, gated
on the lane's request count actually growing inside the window: a
sampled percentile is a lagging snapshot (the reservoir keeps old
samples), so without the gate one bad burst would fire an alert that
could never resolve — an idle lane burns nothing. For the error signal
(``err=`` budget, a fraction) it is the 5xx fraction of
``dllama_http_requests_total`` growth over the window divided by the
budget.

Alerts are multi-window in the SRE sense: an alert FIRES only when both
the short and the long window burn above ``threshold`` (a short spike
alone is noise; a long slow burn alone has no urgency yet), and RESOLVES
only after ``resolve_after`` consecutive healthy short-window
evaluations — the hysteresis that keeps a target-straddling signal from
flapping. Every transition is flight-recorded and counted in
``dllama_alerts_total{slo,state}``; each evaluation pass fires the
``alert_eval`` fault seam, and an injected/real evaluation failure is a
skipped pass counted under ``slo="_engine"``, never a dead engine.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from dllama_tpu_torch import faults
from dllama_tpu_torch.analysis.sanitize import guarded_by
from dllama_tpu_torch.obsv.timeseries import TimeSeriesStore, parse_series_key, series_key

#: (signal, SLOClass attribute carrying the target, sampled series field)
SIGNALS = (("ttft", "ttft_ms", "p95"),
           ("tpot", "tpot_ms", "p95"),
           ("error", "err_rate", None))


def burn_rate_latency(points: List[Tuple[float, float]], target: float,
                      window_s: float, now_s: float) -> float:
    """Mean of the in-window points over the target (0.0 when idle)."""
    if target <= 0:
        return 0.0
    lo = now_s - window_s
    vals = [v for (t, v) in points if t >= lo]
    if not vals:
        return 0.0
    return (sum(vals) / len(vals)) / target


def counter_delta(points: List[Tuple[float, float]], window_s: float,
                  now_s: float) -> float:
    """Growth of a sampled cumulative counter over the window (>= 0;
    a process restart resets the counter — the delta clamps at 0
    instead of going negative and poisoning the rate)."""
    lo = now_s - window_s
    vals = [v for (t, v) in points if t >= lo]
    if len(vals) < 2:
        return 0.0
    return max(0.0, vals[-1] - vals[0])


def burn_rate_errors(store: TimeSeriesStore, window_s: float, now_s: float,
                     budget: float) -> float:
    """5xx fraction of HTTP responses over the window, over the budget."""
    if budget <= 0:
        return 0.0
    total = err = 0.0
    for key in store.family_keys("dllama_http_requests_total"):
        _, _, labels = parse_series_key(key)
        d = counter_delta(store.points(key, window_s, now_s),
                          window_s, now_s)
        total += d
        code = labels.get("code", "")
        if code[:1] == "5":
            err += d
    if total <= 0:
        return 0.0
    return (err / total) / budget


@guarded_by("_lock", "_state", "_healthy", "_since_us", "_last")
class BurnRateEngine:
    """Firing/resolved alert state per (SLO class, signal) with targets."""

    def __init__(self, store: TimeSeriesStore, classes: dict, registry,
                 flight=None, short_s: float = 60.0, long_s: float = 300.0,
                 threshold: float = 1.0, resolve_after: int = 3):
        self.store = store
        self.classes = dict(classes or {})
        self.flight = flight
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.threshold = float(threshold)
        self.resolve_after = max(1, int(resolve_after))
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {}      # slo key -> firing|resolved
        self._healthy: Dict[str, int] = {}    # consecutive healthy evals
        self._since_us: Dict[str, int] = {}   # last transition time
        self._last: Dict[str, tuple] = {}     # slo key -> (short, long, tgt)
        self._m_alerts = registry.counter(
            "dllama_alerts_total",
            "SLO burn-rate alert transitions, by alert and new state "
            "(state=eval_error under slo=_engine counts skipped "
            "evaluation passes — injected via the alert_eval seam or "
            "real)",
            ("slo", "state"))

    def targets(self) -> List[Tuple[str, str, float, Optional[str]]]:
        """Configured (class, signal, target, field) tuples (target > 0)."""
        out = []
        for cname, cls in sorted(self.classes.items()):
            for signal, attr, field in SIGNALS:
                target = float(getattr(cls, attr, 0.0) or 0.0)
                if target > 0:
                    out.append((cname, signal, target, field))
        return out

    def _burn(self, cname: str, signal: str, target: float,
              field: Optional[str], window_s: float, now: float) -> float:
        if signal == "error":
            return burn_rate_errors(self.store, window_s, now, target)
        family = ("dllama_class_ttft_ms" if signal == "ttft"
                  else "dllama_class_tpot_ms")
        labels = {"slo_class": cname}
        # idle-lane gate: the sampled percentile is a lagging snapshot, so
        # only burn while the lane's request count grows inside the window
        # (this is also what lets a fired alert RESOLVE once the bad burst
        # ages past the window)
        count_key = series_key(family, labels, "count")
        if counter_delta(self.store.points(count_key, window_s, now),
                         window_s, now) <= 0:
            return 0.0
        key = series_key(family, labels, field)
        return burn_rate_latency(self.store.points(key, window_s, now),
                                 target, window_s, now)

    def evaluate(self, now_s: Optional[float] = None) -> int:
        """One evaluation pass; returns the number of firing alerts."""
        try:
            faults.fire("alert_eval")
        except faults.FaultInjected:
            self._m_alerts.inc(slo="_engine", state="eval_error")
            with self._lock:
                return sum(1 for s in self._state.values() if s == "firing")
        now = time.time() if now_s is None else now_s
        transitions = []  # (slo, state) minted under the lock, emitted after
        firing = 0
        for cname, signal, target, field in self.targets():
            slo = f"{cname}:{signal}"
            short = self._burn(cname, signal, target, field,
                               self.short_s, now)
            long_ = self._burn(cname, signal, target, field,
                               self.long_s, now)
            breach = short > self.threshold and long_ > self.threshold
            with self._lock:
                self._last[slo] = (short, long_, target)
                state = self._state.get(slo, "resolved")
                if state == "resolved":
                    if breach:
                        state = "firing"
                        self._since_us[slo] = int(now * 1e6)
                        transitions.append((slo, state))
                    self._healthy[slo] = 0
                else:
                    if short > self.threshold:
                        self._healthy[slo] = 0
                    else:
                        self._healthy[slo] = self._healthy.get(slo, 0) + 1
                        if self._healthy[slo] >= self.resolve_after:
                            state = "resolved"
                            self._since_us[slo] = int(now * 1e6)
                            transitions.append((slo, state))
                self._state[slo] = state
                if state == "firing":
                    firing += 1
        for slo, state in transitions:
            self._m_alerts.inc(slo=slo, state=state)
            if self.flight is not None:
                self.flight.record("alert", slo=slo, state=state)
        return firing

    def alerts_payload(self) -> dict:
        """JSON-ready live picture for ``GET /alerts``."""
        alerts = []
        firing = 0
        with self._lock:
            state = dict(self._state)
            since = dict(self._since_us)
            last = dict(self._last)
        for cname, signal, target, _field in self.targets():
            slo = f"{cname}:{signal}"
            st = state.get(slo, "resolved")
            short, long_, tgt = last.get(slo, (0.0, 0.0, target))
            if st == "firing":
                firing += 1
            alerts.append({
                "slo": slo, "slo_class": cname, "signal": signal,
                "state": st, "target": tgt,
                "short_burn": round(short, 4), "long_burn": round(long_, 4),
                "short_window_s": self.short_s, "long_window_s": self.long_s,
                "since_us": since.get(slo),
            })
        return {"alerts": alerts, "firing": firing,
                "threshold": self.threshold,
                "resolve_after": self.resolve_after}
