"""Deterministic fault injection for the serving/runtime seams.

``DLLAMA_FAULTS`` (or a programmatic :func:`install`) names a plan of fault
points; the Engine/BatchSession/server code calls :func:`fire(site)
<fire>` at its seams and the plan decides — by deterministic per-site call
counters, never randomness — whether that call raises or stalls. Chaos tests
and the ``BENCH_FAULTS`` replay drive every failure path CPU-only, the same
way the CI suite drives the TP paths on a virtual device mesh.

Spec grammar (sites separated by ``;``)::

    DLLAMA_FAULTS="step_chunk:raise:every=3;admit:raise:times=1;stream:slow:delay_ms=50"

    <site>:<action>[:key=val[,key=val...]]

* ``site`` — where the hook fires. The wired seams are ``admit``,
  ``step_chunk``, ``prefix_match`` (the radix prefix-cache walk at paged
  admission) and ``page_alloc`` (every KV page allocation) (BatchSession),
  ``prefill`` / ``prefill_chunk`` (Engine), ``stream`` (the SSE writer),
  ``scheduler`` (top of every server scheduler window — the
  supervisor-restart drill), ``weights_open`` / ``weights_read``
  (WeightFileReader — the artifact-integrity drills), ``logits``
  (every decode dispatch — the numeric-health drill), the fleet
  router's seams ``route_pick`` (every replica-selection decision),
  ``proxy_upstream`` (every upstream hop — injected failures take the
  same retry path as real connect errors), ``probe`` (every /ready
  health probe — injected failures open the circuit like real ones)
  and ``federate_scrape`` (every per-replica /metrics scrape behind the
  router's /metrics/fleet — a faulted scrape drops that replica from
  the merged exposition, never the endpoint), plus ``flight_dump``
  (every flight-recorder ring dump — a faulted dump is swallowed and
  counted, proving the black box cannot crash the process) and
  ``overlap_split`` (every dispatch the Engine routes through a
  microbatch-overlap TP program — an injected failure there flows
  through the same chunk error handling as a real one) and
  ``tp_reduce`` (every dispatch served by the row-parallel
  reduce-direction TP programs, Engine._reduce_dispatch — same chunk
  error path). The
  disaggregation seams are ``kv_export`` (every KV page-stream export on
  a prefill replica), ``kv_import`` (every page-stream import/admit on a
  decode replica — a faulted import is a failed transfer the router's
  fallback matrix handles) and ``migrate`` (every router-orchestrated
  prefill→decode migration — a faulted migration degrades to
  re-prefilling on the decode replica, never a client-visible error).
  The failover seams are ``ckpt_write`` (every periodic mid-stream
  session checkpoint a replica ships to the router — a faulted write is
  a skipped checkpoint, counted, never a stream error) and ``resume``
  (every router-side resume attempt after an upstream died mid-SSE — a
  faulted resume degrades to the clean SSE ``error`` + ``[DONE]``
  termination the fallback matrix guarantees). The SLO-class seam is
  ``preempt`` (every chunk-boundary preemption of a batch-class row to
  make room for queued interactive work — a faulted preemption leaves
  the batch row running untouched and the interactive request waiting,
  never a torn stream). The continuous-observability seams are
  ``ts_sample`` (every time-series sampler pass over the metrics
  registry — a faulted pass is skipped and counted, the history ring
  just misses one point and the sampler thread lives) and ``alert_eval``
  (every SLO burn-rate evaluation pass — a faulted evaluation keeps the
  previous alert states and is counted, never a dead alert engine). The
  elastic-fleet seams are ``policy_eval`` (every autoscaler policy tick —
  a faulted tick is one skipped evaluation, counted, and the supervisor
  loop lives), ``scale_up`` (every replica-add transition — a faulted
  spawn is rolled back and counted, the fleet stays at its old size) and
  ``scale_down`` (every replica-retire transition — a faulted drain
  escalates along the same SIGKILL + mid-stream-failover ladder as a
  real drain timeout, never a client-visible error). The event-loop
  data-plane seams are ``conn_accept`` (the router's admission gate at
  accept time — a faulted gate sheds that connection with the canned
  503 + Retry-After before any per-connection state exists, counted
  under reason="injected"), ``relay_stall`` (every upstream read in the
  SSE relay — a faulted read is a stall verdict: after the grace drain
  the stream checkpoint-resumes on a sibling exactly as if the
  inter-byte budget had expired) and ``client_write`` (every write to a
  client socket — a faulted write is a vanished client: counted, and
  the upstream connection closes within one chunk).
* ``action`` — ``raise`` (throw :class:`FaultInjected`), ``slow`` (sleep
  ``delay_ms``, default 50), or a *data* action the seam itself interprets:
  ``truncate`` (weights_open: pretend the file is ``drop`` bytes short,
  default 1), ``bitflip`` (weights_read: flip one bit of tensor byte
  ``byte``, default 0, before the checksum check), ``nan`` (logits: poison
  decode row ``row``, default 0, with NaN before the watchdog check).
* options — ``every=N`` fire on every Nth call (default every call),
  ``after=N`` skip the first N calls, ``times=N`` fire at most N times,
  ``delay_ms=X`` for ``slow``, ``row=N`` / ``byte=N`` / ``drop=N`` for the
  data actions.

``raise``/``slow`` act inside :func:`fire`; a data action that fires is
*returned* to the caller as ``{"action": ..., "row": ..., "byte": ...,
"drop": ...}`` (first match wins) and the seam applies the corruption.

The hot-path cost when no plan is installed is one global ``is None`` check.
"""

from __future__ import annotations

import os
import threading
import time

SITES = ("admit", "step_chunk", "prefill", "prefill_chunk", "prefix_match",
         "page_alloc", "stream", "scheduler", "weights_open", "weights_read",
         "logits", "route_pick", "proxy_upstream", "probe",
         "federate_scrape", "flight_dump", "overlap_split", "tp_reduce",
         "kv_export", "kv_import", "migrate", "ckpt_write", "resume",
         "preempt", "ts_sample", "alert_eval", "policy_eval", "scale_up",
         "scale_down", "conn_accept", "relay_stall", "client_write")
ACTIONS = ("raise", "slow", "truncate", "bitflip", "nan")

#: site -> the metric family that proves the site's failure is VISIBLE on
#: /metrics. dllama-check (FAULT-003) statically verifies every site has an
#: entry and every entry names a metric registered somewhere in the package;
#: the README site list is likewise generated from SITES (FAULT-002) — the
#: registry here is the single source of truth, so the docs/drill/site sets
#: can never drift apart again.
SITE_METRICS = {
    "admit": "dllama_admission_rejections_total",
    "step_chunk": "dllama_decode_chunk_ms",
    "prefill": "dllama_prefill_ms",
    "prefill_chunk": "dllama_prefill_chunk_ms",
    "prefix_match": "dllama_prefix_cache_misses_total",
    "page_alloc": "dllama_kv_pages",
    "stream": "dllama_sse_disconnects_total",
    "scheduler": "dllama_scheduler_crashes_total",
    "weights_open": "dllama_weights_open_failures_total",
    "weights_read": "dllama_weights_checksum_failures_total",
    "logits": "dllama_numeric_quarantines_total",
    # router seams (serving/router.py): a faulted pick is a 5xx the ingress
    # counter sees, a faulted upstream hop is an upstream error (and a
    # retry), a faulted probe is a probe failure that opens the circuit
    "route_pick": "dllama_router_http_requests_total",
    "proxy_upstream": "dllama_router_upstream_errors_total",
    "probe": "dllama_router_probe_failures_total",
    # fleet observability seams: a faulted per-replica scrape shows up as a
    # federation error; a faulted ring dump is swallowed and counted under
    # reason="error" — the black box itself is fault-drilled
    "federate_scrape": "dllama_router_federate_errors_total",
    "flight_dump": "dllama_flight_dumps_total",
    # every dispatch the Engine routes through a microbatch-overlap TP
    # program (Engine._overlap_engaged) — a faulted split takes the same
    # error path as a real chunk failure
    "overlap_split": "dllama_tp_overlap_chunks_total",
    # every dispatch the row-parallel reduce-direction TP programs serve
    # (Engine._reduce_dispatch) — a faulted dispatch takes the same chunk
    # error path as a real one
    "tp_reduce": "dllama_tp_reduce_chunks_total",
    # disaggregation seams: a faulted export/import is a failed transfer
    # the exporting/importing replica counts; a faulted migration is a
    # router-side fallback to re-prefill on the decode replica
    "kv_export": "dllama_kv_transfer_exports_total",
    "kv_import": "dllama_kv_transfer_imports_total",
    "migrate": "dllama_kv_transfer_migrations_total",
    # mid-stream failover seams: a faulted checkpoint write is a skipped
    # (counted) checkpoint; a faulted resume is one more row of the
    # router's resume fallback matrix, counted by outcome
    "ckpt_write": "dllama_ckpt_writes_total",
    "resume": "dllama_stream_resume_total",
    # SLO-class seam: a faulted preemption is a batch row that keeps
    # decoding (outcome="injected"), never a client-visible error
    "preempt": "dllama_preemptions_total",
    # continuous-observability seams (obsv/): a faulted sampler pass is a
    # skipped history point (outcome="fault"); a faulted burn-rate
    # evaluation keeps the previous alert states (state="eval_error") —
    # the watchers are themselves fault-drilled
    "ts_sample": "dllama_ts_samples_total",
    "alert_eval": "dllama_alerts_total",
    # elastic-fleet seams (serving/fleet.py supervisor): a faulted policy
    # evaluation skips one autoscaler tick (decision="injected") and the
    # loop lives; a faulted scale-up/scale-down degrades along the
    # documented ladder (spawn fails -> retired, pre-warm fails -> cold
    # join, drain timeout -> SIGKILL + stream failover) and every rung is
    # an ``event=...`` row on the scale-events counter
    "policy_eval": "dllama_fleet_policy_evals_total",
    "scale_up": "dllama_fleet_scale_events_total",
    "scale_down": "dllama_fleet_scale_events_total",
    # event-loop data-plane seams (serving/router.py on serving/evloop.py):
    # a faulted accept gate sheds that connection with the canned 503
    # (reason="injected"); a faulted relay read is a stall verdict that
    # takes the checkpoint-resume path (outcome="stall" when the resume
    # lands); a faulted client write is a client that vanished — counted,
    # upstream closed within one chunk
    "conn_accept": "dllama_router_sheds_total",
    "relay_stall": "dllama_stream_resume_total",
    "client_write": "dllama_router_client_disconnects_total",
}


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action fault point. Deliberately a RuntimeError
    subclass: injected faults must flow through the SAME handling as real
    engine failures — that equivalence is what the chaos suite proves."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


class _Point:
    """One ``site:action`` rule with its deterministic firing schedule."""

    __slots__ = ("site", "action", "every", "after", "times", "delay_ms",
                 "row", "byte", "drop", "calls", "fired")

    def __init__(self, site: str, action: str, every: int = 1, after: int = 0,
                 times: int = 0, delay_ms: float = 50.0, row: int = 0,
                 byte: int = 0, drop: int = 1):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (known: {ACTIONS})")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.site, self.action = site, action
        self.every, self.after = every, after
        self.times = times  # 0 = unlimited
        self.delay_ms = delay_ms
        self.row, self.byte, self.drop = row, byte, drop
        self.calls = 0  # calls seen at this site
        self.fired = 0  # times this point actually fired

    def should_fire(self) -> bool:
        """Advance the call counter and decide. Caller holds the plan lock."""
        self.calls += 1
        if self.calls <= self.after:
            return False
        if (self.calls - self.after) % self.every != 0:
            return False
        if self.times and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A parsed set of fault points, counted deterministically per site."""

    def __init__(self, points: list):
        self._points = points
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        points = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(
                    f"bad fault spec {part!r}: want site:action[:k=v,...]")
            site, action = fields[0].strip(), fields[1].strip()
            opts: dict = {}
            if len(fields) > 2:
                for kv in fields[2].split(","):
                    if "=" not in kv:
                        raise ValueError(
                            f"bad fault option {kv!r} in {part!r}")
                    k, v = kv.split("=", 1)
                    k = k.strip()
                    if k not in ("every", "after", "times", "delay_ms",
                                 "row", "byte", "drop"):
                        raise ValueError(f"unknown fault option {k!r}")
                    opts[k] = float(v) if k == "delay_ms" else int(v)
            points.append(_Point(site, action, **opts))
        return cls(points)

    def fire(self, site: str) -> dict | None:
        """Run every matching point's decision for one call at ``site``.

        ``raise`` points raise, ``slow`` points sleep; the first *data* point
        (truncate/bitflip/nan) that fires is returned for the seam to apply.
        """
        sleep_ms = 0.0
        data: dict | None = None
        with self._lock:
            for p in self._points:
                if p.site != site or not p.should_fire():
                    continue
                if p.action == "raise":
                    raise FaultInjected(site)
                if p.action == "slow":
                    sleep_ms = max(sleep_ms, p.delay_ms)
                elif data is None:
                    data = {"action": p.action, "row": p.row,
                            "byte": p.byte, "drop": p.drop}
        if sleep_ms > 0:
            time.sleep(sleep_ms / 1000.0)
        return data

    def counters(self) -> dict:
        """{site: (calls, fired)} — test/bench introspection."""
        with self._lock:
            return {p.site: (p.calls, p.fired) for p in self._points}


#: the active plan. None (the default) makes fire() a single attribute test.
_plan: FaultPlan = None
_env_loaded = False


def install(spec: str) -> FaultPlan:
    """Install ``spec`` as the active plan (replacing any prior one)."""
    global _plan, _env_loaded
    _plan = FaultPlan.parse(spec)
    _env_loaded = True
    return _plan


def clear() -> None:
    """Remove the active plan (fire() returns to its no-op fast path)."""
    global _plan, _env_loaded
    _plan = None
    _env_loaded = True  # an explicit clear() outranks the env var


def active() -> FaultPlan:
    """The active plan, lazily loading ``DLLAMA_FAULTS`` once. None when
    fault injection is off."""
    global _plan, _env_loaded
    if not _env_loaded:
        _env_loaded = True
        spec = os.environ.get("DLLAMA_FAULTS", "")
        if spec:
            _plan = FaultPlan.parse(spec)
    return _plan


def fire(site: str) -> dict | None:
    """The seam hook: no-op unless a plan names ``site``. Returns the first
    matching *data* action's parameters (see :meth:`FaultPlan.fire`)."""
    plan = _plan if _env_loaded else active()
    if plan is not None:
        return plan.fire(site)
    return None
