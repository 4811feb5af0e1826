"""Deterministic autoscaler policy: SLO pressure in, ScaleDecision out.

This module is the *brain* of the elastic fleet and deliberately knows
nothing about processes, sockets or threads: :func:`decide` is a pure
function from a window of :class:`Signals` observations (federated
burn-rate alert state + queue-depth / slot-occupancy / KV-pressure, the
fleet's observability sensors) to a :class:`ScaleDecision`. The fleet supervisor
(serving/fleet.py) owns the actuators — spawn, pre-warm, drain, SIGKILL
escalation — and simply executes whatever this module decides.

Keeping the policy pure buys the property the fleet needs: *alert flap
never becomes replica flap*, and that claim is checkable with a table of
synthetic histories (tests/test_autoscale.py, tests/test_torch_autoscale.py) instead of a fleet of real
processes. Three mechanisms enforce it, all deterministic:

* **hysteresis band** — scale-up needs pressure >= ``up_pressure`` (or a
  firing burn-rate alert), scale-down needs pressure <= ``down_pressure``
  AND zero firing alerts; the band between them always holds.
* **consecutive-observation streaks** — one hot sample never scales up:
  the last ``up_consecutive`` observations must *all* be hot (and all of
  the last ``down_consecutive`` cold for scale-down), so a single flapping
  alert evaluation is absorbed by the window.
* **cooldowns + clamps** — after any scale attempt the policy holds for
  ``cooldown_up_s``/``cooldown_down_s`` (whichever direction it would move
  next), and the target replica count is always clamped to
  ``[min_replicas, max_replicas]``.

Pressure is the *max* of the normalized bottleneck resources (slot
occupancy, queue backlog relative to slots, KV-page consumption): scaling
has to respond to whichever resource saturates first, and a weighted
blend would let a saturated lane hide behind two idle ones.

The port's copy of the JAX package's policy. Stdlib-only: it imports
neither torch nor jax, like the rest of the serving control plane.
"""

from __future__ import annotations

import threading
from collections import deque

from dllama_tpu_torch.analysis.sanitize import guarded_by

#: decision actions
UP, DOWN, HOLD = "up", "down", "hold"


class Signals:
    """One autoscaler observation: the fleet-aggregate sensor sample the
    supervisor gathers each evaluation tick (from ``federate_alerts()``
    and the router's readiness aggregation)."""

    __slots__ = ("firing", "queue_depth", "slots_occupied", "slots_total",
                 "kv_pages_free", "kv_pages_total", "kv_pages_reclaimable")

    def __init__(self, firing: int = 0, queue_depth: int = 0,
                 slots_occupied: int = 0, slots_total: int = 0,
                 kv_pages_free: int = 0, kv_pages_total: int = 0,
                 kv_pages_reclaimable: int = 0):
        self.firing = int(firing)
        self.queue_depth = int(queue_depth)
        self.slots_occupied = int(slots_occupied)
        self.slots_total = int(slots_total)
        self.kv_pages_free = int(kv_pages_free)
        self.kv_pages_total = int(kv_pages_total)
        self.kv_pages_reclaimable = int(kv_pages_reclaimable)

    def pressure(self) -> float:
        """Normalized load in [0, 1]: the max over slot occupancy, queue
        backlog (relative to total slots, capped at 1) and KV-page
        consumption — the bottleneck resource, not an average.

        KV availability counts reclaimable pages: the radix cache
        deliberately retains finished rows' pages until an allocation
        needs them, so on an idle steady-state fleet ``kv_pages_free``
        sits near zero forever. Scoring only truly-free pages would pin
        pressure above every down threshold and starve scale-down — the
        cache-is-not-pressure distinction is what lets the fleet shed a
        replica in a trough."""
        occ = (self.slots_occupied / self.slots_total
               if self.slots_total > 0 else 0.0)
        queue = (min(1.0, self.queue_depth / self.slots_total)
                 if self.slots_total > 0
                 else (1.0 if self.queue_depth > 0 else 0.0))
        avail = self.kv_pages_free + self.kv_pages_reclaimable
        kv = (1.0 - avail / self.kv_pages_total
              if self.kv_pages_total > 0 else 0.0)
        return max(0.0, min(1.0, max(occ, queue, kv)))

    def __repr__(self) -> str:  # policy-table test failure readability
        return (f"Signals(firing={self.firing}, queue={self.queue_depth}, "
                f"occ={self.slots_occupied}/{self.slots_total}, "
                f"kv_free={self.kv_pages_free}"
                f"+{self.kv_pages_reclaimable}r/{self.kv_pages_total})")


class PolicyConfig:
    """Autoscaler knobs. Validated once at construction so a bad flag is
    a startup error, not a silent always-hold policy."""

    __slots__ = ("min_replicas", "max_replicas", "up_pressure",
                 "down_pressure", "up_consecutive", "down_consecutive",
                 "cooldown_up_s", "cooldown_down_s", "alert_up", "window")

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 up_pressure: float = 0.75, down_pressure: float = 0.25,
                 up_consecutive: int = 2, down_consecutive: int = 3,
                 cooldown_up_s: float = 5.0, cooldown_down_s: float = 20.0,
                 alert_up: int = 1, window: int = 0):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < "
                             f"min_replicas {min_replicas}")
        if not (0.0 <= down_pressure < up_pressure <= 1.0):
            raise ValueError(
                f"need 0 <= down_pressure < up_pressure <= 1, got "
                f"down={down_pressure} up={up_pressure}")
        if up_consecutive < 1 or down_consecutive < 1:
            raise ValueError("consecutive streaks must be >= 1")
        if cooldown_up_s < 0 or cooldown_down_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if alert_up < 1:
            raise ValueError(f"alert_up must be >= 1, got {alert_up}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_pressure = up_pressure
        self.down_pressure = down_pressure
        self.up_consecutive = up_consecutive
        self.down_consecutive = down_consecutive
        self.cooldown_up_s = cooldown_up_s
        self.cooldown_down_s = cooldown_down_s
        self.alert_up = alert_up
        # the window must be able to hold the longest streak it judges
        floor = max(up_consecutive, down_consecutive)
        self.window = max(int(window) or floor, floor)


class ScaleDecision:
    """What the policy wants done, and why (the reason strings are part
    of the test contract — the policy tables assert on them)."""

    __slots__ = ("action", "target", "reason", "pressure")

    def __init__(self, action: str, target: int, reason: str,
                 pressure: float):
        self.action = action    # "up" | "down" | "hold"
        self.target = target    # desired replica count, already clamped
        self.reason = reason
        self.pressure = pressure  # latest observation's pressure

    def __repr__(self) -> str:
        return (f"ScaleDecision({self.action}, target={self.target}, "
                f"reason={self.reason!r}, pressure={self.pressure:.2f})")


def _hot(sig: Signals, cfg: PolicyConfig) -> bool:
    """Scale-up evidence: saturated resources OR a firing burn-rate alert
    (the SLO is burning even if raw occupancy looks fine)."""
    return sig.pressure() >= cfg.up_pressure or sig.firing >= cfg.alert_up


def _cold(sig: Signals, cfg: PolicyConfig) -> bool:
    """Scale-down evidence: low pressure AND a completely quiet alert
    feed — we never shed capacity while any SLO window is burning."""
    return sig.pressure() <= cfg.down_pressure and sig.firing == 0


def decide(window, n_replicas: int, cfg: PolicyConfig = None,
           now: float = 0.0, last_scale_at: float = None) -> ScaleDecision:
    """The pure policy function.

    ``window`` is the observation history, oldest first (any sequence of
    :class:`Signals`); ``n_replicas`` the current count of replicas the
    fleet is paying for; ``last_scale_at`` the timestamp (same clock as
    ``now``) of the most recent scale *attempt* in either direction, or
    None if the fleet has never scaled. Deterministic: same arguments,
    same decision — there is no hidden clock or randomness to flake on.
    """
    cfg = cfg or PolicyConfig()
    latest_p = window[-1].pressure() if len(window) else 0.0

    def hold(reason: str) -> ScaleDecision:
        target = max(cfg.min_replicas, min(cfg.max_replicas, n_replicas))
        return ScaleDecision(HOLD, target, reason, latest_p)

    # clamp violations outrank everything: a fleet below min is underwater
    # no matter how quiet the sensors look (and above max, vice versa)
    if n_replicas < cfg.min_replicas:
        return ScaleDecision(UP, n_replicas + 1, "below_min", latest_p)
    if n_replicas > cfg.max_replicas:
        return ScaleDecision(DOWN, n_replicas - 1, "above_max", latest_p)

    if len(window) < min(cfg.up_consecutive, cfg.down_consecutive):
        return hold("warming")

    up_tail = list(window)[-cfg.up_consecutive:]
    up_eligible = (len(window) >= cfg.up_consecutive
                   and all(_hot(s, cfg) for s in up_tail))
    down_tail = list(window)[-cfg.down_consecutive:]
    down_eligible = (len(window) >= cfg.down_consecutive
                     and all(_cold(s, cfg) for s in down_tail))

    if up_eligible:
        if n_replicas >= cfg.max_replicas:
            return hold("at_max")
        if (last_scale_at is not None
                and now - last_scale_at < cfg.cooldown_up_s):
            return hold("cooldown_up")
        reason = ("alerts_firing"
                  if all(s.firing >= cfg.alert_up for s in up_tail)
                  else "pressure_high")
        return ScaleDecision(UP, n_replicas + 1, reason, latest_p)

    if down_eligible:
        if n_replicas <= cfg.min_replicas:
            return hold("at_min")
        if (last_scale_at is not None
                and now - last_scale_at < cfg.cooldown_down_s):
            return hold("cooldown_down")
        return ScaleDecision(DOWN, n_replicas - 1, "pressure_low", latest_p)

    return hold("hysteresis")


@guarded_by("_lock", "_last_scale_at")
class AutoscalePolicy:
    """Thin stateful wrapper: owns the observation window and the
    last-scale timestamp, delegates every judgement to :func:`decide`.
    Thread-safe because the fleet supervisor's periodic tick and a
    drill/operator-forced transition may race on the cooldown clock."""

    def __init__(self, cfg: PolicyConfig = None):
        self.cfg = cfg or PolicyConfig()
        self._lock = threading.Lock()
        self._window = deque(maxlen=self.cfg.window)
        self._last_scale_at: float = None

    def evaluate(self, now: float, n_replicas: int,
                 signals: Signals) -> ScaleDecision:
        """Record one observation and decide. A non-hold decision arms
        the cooldown immediately — the *attempt* counts, even if the
        execution later fails, so a failing spawn can't be retried in a
        tight loop."""
        with self._lock:
            self._window.append(signals)
            d = decide(tuple(self._window), n_replicas, self.cfg, now,
                       self._last_scale_at)
            if d.action != HOLD:
                self._last_scale_at = now
            return d

    def note_scale(self, now: float) -> None:
        """Arm the cooldown for an out-of-band scale event (an operator
        or drill-forced transition must still suppress the policy's next
        move, or the two controllers fight)."""
        with self._lock:
            self._last_scale_at = now

    def window_snapshot(self) -> tuple:
        with self._lock:
            return tuple(self._window)
