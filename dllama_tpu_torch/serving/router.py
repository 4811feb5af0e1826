"""Fleet front door: a stateless HTTP router over N ``dllama-api`` replicas.

The port's copy of the JAX package's router, with its imports pointed at
the port's copies of ``faults``, ``observability``, ``obsv`` and the
serving modules; it imports neither ``torch`` nor ``jax``, so a router
starts on a host with no GPU and the fleet supervisor holds no CUDA
context beside its replicas.

The replicas' serving semantics (429/503/504, /health vs /ready, SIGTERM
drain, X-Request-Id, the radix prefix cache) let a fleet of identical
replicas sit behind a load balancer; this module is that balancer,
stdlib-only like the rest of serving/. It proxies the OpenAI
surface (``/v1/chat/completions`` incl. SSE streaming passthrough,
``/v1/models``) and keeps no request state of its own — kill the router,
restart it, and the fleet picture rebuilds from one probe round.

Routing policy, in order:

* **prefix affinity** — multi-turn traffic should land where its KV pages
  are warm. The router has no tokenizer, so affinity keys on the canonical
  *byte* stream of the messages array, hashed in cumulative block-aligned
  prefixes (``--affinity-block`` bytes per block): turn N+1 carries turn N's
  rendered conversation as a byte prefix, so its longest matching block
  hash points at the replica whose radix cache already holds those pages.
  A saturated affinity target (slots full AND queue backed up) falls back
  to least-load — a warm cache never justifies queueing behind it.
* **weighted least-load** — scored from the occupancy/queue-depth/kv-page
  fields each replica publishes on ``/ready`` (one cheap probe carries the
  whole picture), plus the router's own live in-flight count per replica
  (the probe snapshot is up to a probe interval stale; in-flight is not).
* **failover** — connect-phase failures and 503s (a draining or
  mid-restart replica) retry on the next-best replica under
  ``--retry-budget``; 429 (fleet at capacity) and 504 (deadline) pass
  through untouched — retrying those would amplify overload or burn a
  client's remaining deadline. Once bytes have streamed to the client,
  nothing retries.

Replica health is judged twice: an active ``/ready`` probe loop (drain
flips a replica out of rotation within one probe interval) and passive
circuit-breaking on data-path connect errors (exponential backoff, closed
again by the next successful probe). Either alone has a blind spot — the
probe is periodic, the data path only sees replicas it already picked.

The data plane is a stdlib ``selectors`` event loop (:mod:`evloop`): one
thread, non-blocking sockets, one coroutine per client connection — 10k
concurrent SSE streams fit in one process because an idle stream costs a
parked generator, not an OS thread. The loop structure is what makes the
robustness machinery expressible: per-edge deadlines (``--header-timeout``
kills slow-loris clients, connect/first-byte budgets bound each upstream
hop, the ``--stall-timeout`` inter-byte budget turns a GRAY upstream —
accepted socket, then silence mid-SSE — into a checkpoint-resume with
``outcome=stall``), slow-client backpressure (the relay holds one chunk at
a time, so a client that stops draining pauses its upstream read instead
of growing router RSS, and is hard-killed past ``--client-stall-timeout``),
and ``--max-conns`` admission (new connections shed with a canned 503 +
Retry-After at accept time, BEFORE any state is allocated). Control-plane
work that legitimately blocks — probes, federation scrapes — runs on
worker threads, never the loop.

The router serves its own ``/health``, ``/ready``, ``/metrics`` and
``/stats`` (aggregating per-replica state) and generates/propagates
``X-Request-Id`` across the hop so a trace correlates end-to-end. Fault
seams ``route_pick``, ``proxy_upstream``, ``probe``, ``federate_scrape``,
``conn_accept``, ``relay_stall`` and ``client_write`` are wired through
``faults.SITES``; injected failures take the same retry/circuit/shed
paths as real ones.

Fleet observability (this is the stitching half of observability.py):

* every proxied request carries ``X-Dllama-Parent-Span: <pid>:<span>``
  upstream; the replica parents its RequestTrace under it and the router
  emits the matching flow arrow, so one merged Perfetto file shows the
  router's proxy/connect/stream spans and the replica's queue/prefill/
  decode spans on a common timeline. The probe loop doubles as a clock
  sync: the replica stamps ``/ready`` with its monotonic-epoch time, the
  router subtracts half the probe RTT, and the per-replica offset feeds
  ``merge_trace_parts`` at fleet shutdown so spans nest despite skew.
* ``GET /metrics/fleet`` scrapes every in-rotation replica's /metrics and
  merges the expositions under a ``replica`` label (counters sum, gauges
  stay per-replica, histogram buckets merge); a crashed replica's series
  drop out with its circuit, and a failed scrape drops that replica from
  the merge — never the endpoint.
* each replica's ``Server-Timing`` response header splits the router's
  wall time into ``dllama_router_hop_ms{phase=connect|upstream_queue|
  upstream_compute|stream}`` — where a slow request spent its time, per
  hop, without parsing any trace.
* the router keeps its own flight-recorder ring (admits at the replicas,
  upstream errors, replica generation changes) and ``GET /debug/flight``
  returns it together with every replica's ring — the one call a
  postmortem starts from.

Disaggregated serving: when the fleet declares both dedicated ``prefill``
and dedicated ``decode`` replicas (the ``role`` field each publishes on
``/ready``), new chat completions take the migration path instead —
``POST /v1/prefill`` on a prefill replica runs the prompt and the FIRST
decode chunk, then answers with a framed KV page stream
(:mod:`kv_transfer`); the router relays that stream into
``POST /v1/kv/import`` on a decode replica, which admits the row warm and
streams the rest. The ``migrate`` fault seam sits at the decision point,
and EVERY failure along the two hops falls back to normal routing (a full
re-prefill on whatever replica pick() chooses) — a torn transfer is a
performance event, never a client-visible error.

Mid-stream failover: with ``--ckpt-interval`` > 0 every proxied stream
asks its replica (``X-Dllama-Ckpt``) to interleave in-band
``event: dllama-ckpt`` control frames — the row's KV pages + sampler
chain (:mod:`kv_transfer`) plus the SSE writer's exact rendering state,
prefixed with the client-visible byte offset the snapshot describes. The
relay strips those frames into a bounded per-request
:class:`CheckpointStore` (clients never see them) and, when the upstream
dies mid-SSE without ``[DONE]``, picks a sibling, POSTs the checkpoint to
``/v1/kv/resume`` and splices the continued stream into the SAME client
connection, discarding the byte prefix the client already holds — the
bytes are what the dead replica would have written, so the client sees no
repeat and no gap. The ``resume`` fault seam sits at the decision point;
every outcome (ok or any fallback-matrix row) is counted in
``dllama_stream_resume_total{outcome}``, flight-recorded, and closed with
a clean SSE ``error`` event + ``[DONE]`` when resume is exhausted —
never a silent TCP cut.
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import os
import sys
import threading
import time
from collections import OrderedDict

from dllama_tpu_torch import faults, observability
from dllama_tpu_torch.analysis.sanitize import guarded_by, loop_callback
from dllama_tpu_torch.serving import evloop
from dllama_tpu_torch.obsv import Sampler, TimeSeriesStore
from dllama_tpu_torch.obsv.timeseries import parse_window
from dllama_tpu_torch.serving import kv_transfer
from dllama_tpu_torch.serving.lifecycle import LifecycleError, Supervisor
from dllama_tpu_torch.serving.protocol import (HDR_CKPT, HDR_CKPT_WIRE, HDR_CLASS,
                                         HDR_PARENT_SPAN, HDR_REQUEST_ID,
                                         HDR_RESUME_OFFSET,
                                         HDR_SERVER_TIMING, SSE_EVENT_CKPT)

#: the checkpoint control frame's event name as the scanner sees it
_CKPT_EVENT_B = SSE_EVENT_CKPT.encode()

#: longest prompt prefix the affinity index keys on, in blocks — bounds the
#: per-request hashing work and the index growth per conversation
MAX_AFFINITY_BLOCKS = 64

#: least-load score weights: queue depth outranks occupancy (queued work is
#: guaranteed wait; occupied slots may finish any chunk), kv-page pressure
#: is a tiebreaker between equally-busy replicas, and the router's own
#: in-flight count breaks ties between idle replicas *within* one probe
#: interval (it is the only live signal between probes)
W_OCCUPANCY = 1.0
W_QUEUE = 2.0
W_KV = 0.5
W_INFLIGHT = 0.25
#: lane-pressure weight: when the request carries an SLO class, a replica
#: whose matching lane is backed up (lane inflight + lane queue vs the
#: lane's capacity, from /ready's per-class view) scores worse — an
#: interactive turn steers away from the replica drowning in interactive
#: work even when its TOTAL load ties with a sibling's
W_CLASS = 1.5


class NoReplicaAvailable(LifecycleError):
    """No routable replica (all draining, dead, or circuit-open): HTTP 503.

    Carries Retry-After like the in-replica lifecycle rejections — the
    client should back off for roughly one probe interval, after which a
    restarted/undrained replica would be back in rotation."""

    http_status = 503

    def __init__(self, n_replicas: int, n_excluded: int,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"no replica available ({n_replicas} configured, "
            f"{n_excluded} already tried this request)")
        self.retry_after_s = retry_after_s


def canonical_prompt_bytes(messages: list) -> bytes:
    """The affinity hash input: role/content pairs framed with separator
    bytes that cannot appear in JSON string content. Deliberately NOT the
    rendered chat template: the router is template-agnostic, and any stable
    injective encoding works — turn N+1's encoding extends turn N's."""
    parts = []
    for m in messages:
        if not isinstance(m, dict):
            continue
        content = m.get("content", "")
        if not isinstance(content, str):
            # multi-part content arrays hash as their canonical JSON
            content = json.dumps(content, sort_keys=True)
        parts.append(str(m.get("role", "")).encode("utf-8", "replace")
                     + b"\x1f" + content.encode("utf-8", "replace") + b"\x1e")
    return b"".join(parts)


def prefix_hashes(messages: list, block: int) -> list:
    """Cumulative sha256 of each block-aligned prefix of the canonical
    prompt bytes, shortest first. Hash i covers bytes [0, (i+1)*block) —
    cumulative, so two conversations sharing hash i share the whole
    prefix, exactly the property the replica-side radix cache exploits."""
    if block <= 0:
        return []
    data = canonical_prompt_bytes(messages)
    n_blocks = min(len(data) // block, MAX_AFFINITY_BLOCKS)
    h = hashlib.sha256()
    out = []
    for i in range(n_blocks):
        h.update(data[i * block:(i + 1) * block])
        out.append(h.hexdigest())
    return out


def load_score(snap: dict, stale: bool = False,
               slo_class: str = None) -> float:
    """Weighted least-load score for one replica snapshot (lower = better).
    Every term is normalized by the replica's slot count so heterogeneous
    fleets (different --batch-max) compare fairly.

    ``slo_class`` adds the matching lane's pressure (its inflight + queued
    count over its capacity, from the replica's per-class /ready view) so
    classed traffic spreads by LANE load, not just total load. Replicas
    predating the per-class view contribute no lane term — mixed fleets
    keep comparing on the shared terms.

    ``stale`` means the probe snapshot is too old to trust (older than
    twice the probe interval — the probe loop is wedged or the replica is
    slow-walking /ready): score on the router's own live in-flight count
    alone rather than on occupancy/queue/kv numbers frozen at their last
    good values."""
    load = snap.get("load") or {}
    total = load.get("slots_total", 0) or 1
    inflight = snap.get("inflight", 0) / total
    if stale:
        return W_INFLIGHT * inflight
    occ = load.get("slots_occupied", 0) / total
    queue = load.get("queue_depth", 0) / total
    kv_total = load.get("kv_pages_total", 0)
    kv = (1.0 - load.get("kv_pages_free", 0) / kv_total) if kv_total else 0.0
    lane = 0.0
    if slo_class:
        cls = (load.get("classes") or {}).get(slo_class)
        if cls:
            cap = cls.get("capacity", 0) or 1
            lane = (cls.get("inflight", 0) + cls.get("waiting", 0)) / cap
    return (W_OCCUPANCY * occ + W_QUEUE * queue + W_KV * kv
            + W_INFLIGHT * inflight + W_CLASS * lane)


def saturated(snap: dict) -> bool:
    """Is this replica's warm cache worth queueing for? No: a full slot
    pool WITH a backlog means affinity would trade TTFT-queue-time for
    prefill-time — strictly worse once the queue is nonempty."""
    load = snap.get("load") or {}
    total = load.get("slots_total", 0)
    return (total > 0 and load.get("slots_occupied", 0) >= total
            and load.get("queue_depth", 0) > 0)


#: replica lifecycle states (elastic fleet): only ``active`` replicas are
#: pick()-able. A scaled-up replica registers as ``joining`` (probed and
#: pre-warmed, but taking no traffic) until the supervisor activates it;
#: a retiring replica is marked ``draining`` (finishes its in-flight
#: streams, takes no new picks and is never a resume target) and becomes
#: ``gone`` when deregistered. Statically-configured replicas start
#: ``active`` — the classic fixed fleet is the degenerate lifecycle.
LIFECYCLE_JOINING = "joining"
LIFECYCLE_ACTIVE = "active"
LIFECYCLE_DRAINING = "draining"
LIFECYCLE_GONE = "gone"
LIFECYCLES = (LIFECYCLE_JOINING, LIFECYCLE_ACTIVE, LIFECYCLE_DRAINING,
              LIFECYCLE_GONE)


@guarded_by("_lock", "_ready", "_info", "_failures", "_circuit_until",
            "_inflight", "_probed_at", "_clock_offset_us", "_replica_id",
            "_state")
class Replica:
    """One upstream ``dllama-api`` process as the router sees it: the last
    probe verdict + load snapshot, the passive circuit breaker, the
    router-side in-flight count, and the elastic-fleet lifecycle state.
    All mutable state lives behind ``_lock``; readers take
    :meth:`snapshot` — no caller ever holds two replica locks, so the
    lock graph stays acyclic by construction."""

    def __init__(self, host: str, port: int, circuit_base_s: float = 0.25,
                 circuit_max_s: float = 5.0,
                 lifecycle: str = LIFECYCLE_ACTIVE):
        if lifecycle not in LIFECYCLES:
            raise ValueError(f"unknown lifecycle {lifecycle!r} "
                             f"(know {LIFECYCLES})")
        self.host = host
        self.port = port
        self.name = f"{host}:{port}"
        self.circuit_base_s = circuit_base_s
        self.circuit_max_s = circuit_max_s
        self._lock = threading.Lock()
        # optimistic until the first probe: a just-configured replica takes
        # traffic immediately, and a dead one trips the passive breaker on
        # its first connect error anyway
        self._ready = True
        self._info: dict = {}
        self._failures = 0
        self._circuit_until = 0.0
        self._inflight = 0
        self._probed_at = 0.0
        # monotonic-clock skew estimate vs this replica (trace stitching)
        # and the replica's self-reported identity (restart detection)
        self._clock_offset_us = 0
        self._replica_id = None
        self._state = lifecycle

    def set_lifecycle(self, state: str) -> None:
        if state not in LIFECYCLES:
            raise ValueError(f"unknown lifecycle {state!r} "
                             f"(know {LIFECYCLES})")
        with self._lock:
            self._state = state

    def lifecycle(self) -> str:
        with self._lock:
            return self._state

    def mark_probe(self, ready: bool, info: dict | None,
                   offset_us: int | None = None):
        """Record one active-probe verdict. A ready probe also closes the
        passive circuit: the replica answered /ready, so connect errors
        that opened the breaker are behind us.

        Returns the PREVIOUS replica identity when this probe observed a
        generation change (a different process now answers on host:port —
        a crash-restart the caller should log), else None."""
        prev_gen = None
        with self._lock:
            self._ready = ready
            self._probed_at = time.monotonic()
            if info is not None:
                self._info = info
                rid = info.get("replica_id")
                if rid is not None:
                    if self._replica_id is not None and rid != self._replica_id:
                        prev_gen = self._replica_id
                    self._replica_id = rid
            if offset_us is not None:
                self._clock_offset_us = int(offset_us)
            if ready:
                self._failures = 0
                self._circuit_until = 0.0
        return prev_gen

    def probe_age_s(self) -> float:
        """Seconds since the last completed probe (nan = never probed):
        the value behind ``dllama_router_probe_age_seconds`` and the
        staleness test that demotes this replica's load snapshot."""
        with self._lock:
            if not self._probed_at:
                return float("nan")
            return time.monotonic() - self._probed_at

    def clock_offset_us(self) -> int:
        """Estimated ``replica_monotonic_us - router_monotonic_us`` from
        the last probe round trip (skew + RTT/2). Subtracting it from a
        replica's trace timestamps moves them onto the router's timeline —
        exactly what ``merge_trace_parts`` does at fleet shutdown."""
        with self._lock:
            return self._clock_offset_us

    def mark_conn_failure(self) -> None:
        """Passive circuit breaker: a data-path connect failure opens the
        circuit with exponential backoff so one dead replica costs each
        request at most one connect attempt per backoff window."""
        with self._lock:
            self._failures += 1
            backoff = min(self.circuit_max_s,
                          self.circuit_base_s * (2 ** (self._failures - 1)))
            self._circuit_until = time.monotonic() + backoff

    def mark_conn_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._circuit_until = 0.0

    def mark_unready(self) -> None:
        """Passive drain detection: the data path got a 503, so stop
        routing here now instead of waiting out the probe interval."""
        with self._lock:
            self._ready = False

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def end(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                # disaggregation role the replica declared on /ready:
                # "prefill" replicas take new prompts and hand their KV to
                # a "decode" replica at first token; "both" (the default,
                # and every pre-role replica) serves end-to-end
                "role": self._info.get("role") or "both",
                "ready": self._ready,
                "circuit_open": time.monotonic() < self._circuit_until,
                "consecutive_failures": self._failures,
                "inflight": self._inflight,
                "probed_age_s": (round(time.monotonic() - self._probed_at, 3)
                                 if self._probed_at else None),
                "replica_id": self._replica_id,
                "clock_offset_us": self._clock_offset_us,
                "load": dict(self._info),
            }


@guarded_by("_lock", "_map")
class AffinityIndex:
    """Bounded LRU map from cumulative prefix hash -> replica name. One
    entry per block of every routed conversation, evicted least-recently
    -used; capacity bounds router memory regardless of traffic shape."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()

    def lookup(self, hashes: list):
        """The replica that served the LONGEST matching block prefix (the
        most warm pages), or None. Touches the hit for LRU recency."""
        with self._lock:
            for h in reversed(hashes):
                name = self._map.get(h)
                if name is not None:
                    self._map.move_to_end(h)
                    return name
        return None

    def record(self, hashes: list, name: str) -> None:
        """Point every block prefix of a successfully routed conversation
        at the replica that now holds its pages (last writer wins: after a
        failover the NEW replica is the warm one)."""
        with self._lock:
            for h in hashes:
                self._map[h] = name
                self._map.move_to_end(h)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


@guarded_by("_lock", "_map")
class CheckpointStore:
    """Bounded LRU of the latest mid-stream checkpoint per request id.

    One live stream keeps at most ONE entry (each ``dllama-ckpt`` frame
    replaces the last — only the newest snapshot can splice without
    re-generating already-forwarded tokens for nothing), and the relay
    pops the entry the moment its stream ends, so steady-state occupancy
    is the number of in-flight checkpointing streams. Capacity eviction
    drops the least-recently-touched stream, which degrades THAT stream's
    failover to the fallback matrix's ``no_ckpt`` row — a bounded store
    costs coverage under pressure, never correctness or memory.

    An entry orphaned by ABNORMAL teardown (the relay thread died before
    its ``finally`` pop — a killed router worker, an OS-level socket
    reset during the pop path) has no stream left to resume; with
    ``ttl_s`` > 0 the periodic :meth:`sweep` (the probe loop drives it)
    reclaims such entries instead of letting them squat until LRU
    pressure evicts a LIVE stream's checkpoint to make room."""

    def __init__(self, capacity: int = 256, ttl_s: float = 0.0):
        self.capacity = max(1, int(capacity))
        self.ttl_s = max(0.0, float(ttl_s))
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()

    def put(self, rid: str, payload: bytes, offset: int,
            replica: str) -> None:
        """Store/replace ``rid``'s checkpoint: the kv_transfer payload and
        the client-visible byte offset its rendering state describes."""
        with self._lock:
            self._map[rid] = {"payload": payload, "offset": int(offset),
                              "replica": replica,
                              "stored_at": time.monotonic()}
            self._map.move_to_end(rid)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def get(self, rid: str):
        """The latest entry for ``rid`` (LRU-touched), or None."""
        with self._lock:
            e = self._map.get(rid)
            if e is not None:
                self._map.move_to_end(rid)
            return e

    def pop(self, rid: str) -> None:
        with self._lock:
            self._map.pop(rid, None)

    def sweep(self, now: float = None) -> int:
        """Drop every entry older than ``ttl_s`` (0 disables); returns the
        count reclaimed. A LIVE stream's entry is refreshed by every
        checkpoint frame (put() restamps ``stored_at``), so only streams
        that stopped checkpointing TTL out — and a stream that went that
        long without a frame has nothing fresher to resume from anyway."""
        if self.ttl_s <= 0:
            return 0
        if now is None:
            now = time.monotonic()
        cutoff = now - self.ttl_s
        with self._lock:
            dead = [rid for rid, e in self._map.items()
                    if e["stored_at"] < cutoff]
            for rid in dead:
                del self._map[rid]
        return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


@guarded_by("_lock", "_map")
class HotPrompts:
    """Bounded LRU of recently-routed prompt bodies, keyed by first-block
    affinity hash: the scale-up pre-warm source. A freshly spawned
    replica replays the hottest of these through a warm sibling's
    ``/v1/prefill`` -> its own ``/v1/kv/import`` before taking traffic,
    so its radix cache holds the fleet's hot prefixes from minute zero.
    Oversized bodies are skipped (pre-warm is for hot SHORT prefixes;
    shipping a near-window prompt would serialize the join on one
    transfer) and capacity eviction drops the least-recently-seen
    conversation — a best-effort warmth hint, never request state."""

    def __init__(self, capacity: int = 32, max_bytes: int = 16384):
        self.capacity = max(1, int(capacity))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._map: OrderedDict = OrderedDict()  # key -> (hits, body_json)

    def record(self, hashes: list, req: dict) -> None:
        try:
            body = json.dumps(req, sort_keys=True)
        except (TypeError, ValueError):
            return
        if len(body) > self.max_bytes:
            return
        key = (hashes[0] if hashes
               else hashlib.sha256(body.encode()).hexdigest())
        with self._lock:
            hits, _ = self._map.get(key, (0, None))
            self._map[key] = (hits + 1, body)
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def top(self, n: int) -> list:
        """The ``n`` hottest recorded request bodies (dicts), most-hit
        first, recency breaking ties (the LRU order is recency)."""
        with self._lock:
            items = list(self._map.values())
        items.reverse()  # LRU order is oldest-first; stable sort then
        items.sort(key=lambda hv: hv[0], reverse=True)  # keeps recent first
        return [json.loads(body) for _, body in items[:n]]

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


def merge_expositions(parts: list) -> str:
    """Merge per-replica Prometheus text expositions into one fleet view.

    ``parts`` is ``[(replica_name, exposition_text), ...]``. Every sample
    line gains a ``replica`` label, which IS the merge semantics the text
    format can express: the per-replica series stay disjoint, so counters
    sum, gauges stay attributable, and histogram buckets merge under any
    downstream ``sum by (le)`` — while each family's HELP/TYPE pair
    dedupes to one occurrence (first replica wins) so the output is still
    a valid exposition with every family's samples contiguous."""
    helps: dict = {}
    types: dict = {}
    samples: OrderedDict = OrderedDict()  # family -> relabeled sample lines
    for replica, text in parts:
        lab = 'replica="%s"' % str(replica).replace("\\", "\\\\").replace(
            '"', '\\"')
        family = None
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                fields = line.split(" ", 3)
                if len(fields) < 3:
                    continue
                family = fields[2]
                target = helps if fields[1] == "HELP" else types
                target.setdefault(family, line)
                samples.setdefault(family, [])
            elif not line or line.startswith("#"):
                continue
            else:
                # sample line: name[{labels}] value — _bucket/_sum/_count
                # suffixes group under the family that declared them
                name = line.split("{", 1)[0].split(" ", 1)[0]
                key = (family if family is not None
                       and name.startswith(family) else name)
                if "{" in line:
                    head, rest = line.split("{", 1)
                    relabeled = f"{head}{{{lab},{rest}"
                else:
                    head, _, value = line.partition(" ")
                    relabeled = f"{head}{{{lab}}} {value}"
                samples.setdefault(key, []).append(relabeled)
    out = []
    for family, lines in samples.items():
        if family in helps:
            out.append(helps[family])
        if family in types:
            out.append(types[family])
        out.extend(lines)
    return "\n".join(out) + "\n" if out else ""


@guarded_by("_replicas_lock", "_replicas")
class RouterState:
    """Config + fleet picture + metrics for one router process. The
    replica set is a dynamic registry (the elastic fleet registers and
    deregisters replicas live): :attr:`replicas` snapshots it as a tuple
    under ``_replicas_lock``, so readers still iterate a stable sequence
    while :meth:`register_replica`/:meth:`deregister_replica` edit the
    underlying list. Each Replica's mutable state (including its
    joining/active/draining/gone lifecycle) lives behind its own lock."""

    def __init__(self, replicas: list, retry_budget: int = 2,
                 probe_interval_s: float = 1.0,
                 connect_timeout_s: float = 2.0,
                 upstream_timeout_s: float = 0.0,
                 affinity_block: int = 256,
                 affinity_capacity: int = 4096,
                 kv_wire: str = "f32",
                 ckpt_interval: int = 32,
                 ckpt_capacity: int = 256,
                 ckpt_ttl_s: float = 600.0,
                 metrics=None, enable_flight: bool = True,
                 ts_interval: float = 1.0,
                 max_conns: int = 0,
                 header_timeout_s: float = 10.0,
                 first_byte_timeout_s: float = 0.0,
                 stall_timeout_s: float = 0.0,
                 client_stall_timeout_s: float = 30.0,
                 probe_read_timeout_s: float = 2.0):
        self._replicas_lock = threading.Lock()
        self._replicas = list(replicas)
        self.retry_budget = retry_budget
        self.probe_interval_s = probe_interval_s
        self.connect_timeout_s = connect_timeout_s
        self.upstream_timeout_s = upstream_timeout_s
        # event-loop data-plane budgets, one per edge (0 = that edge is
        # unbounded). header: the slow-loris kill — a client must land a
        # full request head within this. first_byte: connect-to-status-line
        # on the upstream hop (falls back to upstream_timeout). stall: the
        # inter-byte budget on SSE relay — an upstream silent past it is
        # treated as DEAD and checkpoint-resumed on a sibling
        # (outcome=stall). client_stall: the slow-client hard kill — a
        # client not draining its socket past this loses the connection.
        self.max_conns = max(0, int(max_conns))
        self.header_timeout_s = header_timeout_s
        self.first_byte_timeout_s = first_byte_timeout_s
        self.stall_timeout_s = stall_timeout_s
        self.client_stall_timeout_s = client_stall_timeout_s
        # probes get their own short READ deadline, distinct from connect:
        # a gray replica (accepts, then silence) costs one read timeout,
        # never a wedged probe pass
        self.probe_read_timeout_s = probe_read_timeout_s
        self.affinity_block = affinity_block
        if kv_wire not in kv_transfer.WIRE_MODES:
            raise ValueError(f"unknown --kv-wire {kv_wire!r} "
                             f"(know {kv_transfer.WIRE_MODES})")
        # wire mode the prefill replica is asked to encode migrating rows
        # in: "f32" is bit-exact, "q80" ~3.76x smaller but error-bounded,
        # "q80+f32" q80 for full pages with a bit-exact f32 tail page
        self.kv_wire = kv_wire
        # mid-stream failover: ask every streamed request's replica for a
        # checkpoint each ckpt_interval emitted tokens (0 disables both
        # the checkpoint frames and the resume orchestration)
        self.ckpt_interval = max(0, int(ckpt_interval))
        self.ckpt_store = CheckpointStore(ckpt_capacity, ttl_s=ckpt_ttl_s)
        self.affinity = AffinityIndex(affinity_capacity)
        # pre-warm source material for scaled-up replicas (see HotPrompts)
        self.hot_prompts = HotPrompts()
        self.started_at = time.time()
        # a fresh registry per router (not the process default): in-process
        # tests run several routers side by side, and the router's series
        # must never mix with an in-process replica's engine series
        self.metrics = (metrics if metrics is not None
                        else observability.MetricsRegistry())
        reg = self.metrics
        self._m_http = reg.counter(
            "dllama_router_http_requests_total",
            "Router HTTP responses written, by route and status code",
            ("route", "code"))
        self._m_picks = reg.counter(
            "dllama_router_picks_total",
            "Replica-selection decisions, by policy that made the call",
            ("reason",))
        self._m_retries = reg.counter(
            "dllama_router_retries_total",
            "Requests re-dispatched to another replica after a retriable "
            "upstream failure (connect error or 503)")
        self._m_upstream_errors = reg.counter(
            "dllama_router_upstream_errors_total",
            "Upstream hops that failed before a usable response",
            ("replica",))
        self._m_probe_failures = reg.counter(
            "dllama_router_probe_failures_total",
            "Active /ready probes that errored (connect/parse/injected)",
            ("replica",))
        self._m_probe_errors = reg.counter(
            "dllama_router_probe_errors_total",
            "Active /ready probes that errored, by failure mode: connect "
            "(refused/unreachable), stall (the GRAY failure — the replica "
            "accepted the socket then went silent past the probe read "
            "deadline; marked circuit-open immediately), parse (garbled "
            "body), injected",
            ("replica", "reason"))
        self._m_sheds = reg.counter(
            "dllama_router_sheds_total",
            "Connections refused at accept time, before any per-connection "
            "state was allocated (max_conns = the --max-conns admission "
            "gate answered 503 + Retry-After; injected = the conn_accept "
            "fault seam fired)",
            ("reason",))
        self._m_conns = reg.gauge(
            "dllama_router_open_conns",
            "Client connections currently open on the event loop (the "
            "number --max-conns admission-controls)")
        self._m_client_disconnects = reg.counter(
            "dllama_router_client_disconnects_total",
            "Streaming clients that vanished mid-SSE (the upstream replica "
            "connection is closed immediately so its cancel-on-disconnect "
            "fires within one chunk)")
        self._m_replicas_ready = reg.gauge(
            "dllama_router_replicas_ready",
            "Replicas currently in rotation (ready and circuit closed)")
        self._m_ttfb = reg.histogram(
            "dllama_router_upstream_ttfb_ms",
            "Upstream time-to-first-byte (connect + status line) per hop")
        self._m_hop = reg.histogram(
            "dllama_router_hop_ms",
            "Per-hop latency attribution: the router's wall time split into "
            "connect (to upstream first byte), the replica's own "
            "Server-Timing queue/compute phases, and the relay stream",
            ("phase",))
        self._m_federate_errors = reg.counter(
            "dllama_router_federate_errors_total",
            "Per-replica /metrics scrapes behind /metrics/fleet that failed "
            "(connect/parse/injected); the replica drops out of that merged "
            "exposition, never the endpoint",
            ("replica",))
        self._m_federate_skipped = reg.counter(
            "dllama_router_federate_skipped_total",
            "Replicas left out of a /metrics/fleet, /metrics/history or "
            "/alerts federation pass, by reason (not_ready/circuit_open: "
            "the probe verdict excluded them; unreachable: the scrape "
            "itself failed) — a hole in the federated picture is counted, "
            "never silent",
            ("reason",))
        self._m_migrations = reg.counter(
            "dllama_kv_transfer_migrations_total",
            "Disaggregated prefill->decode migration attempts the router "
            "orchestrated, by outcome (ok = handoff relayed end-to-end; "
            "prefill_done = the row finished during prefill so nothing "
            "migrated; every *_fallback/injected/no_* outcome degraded to "
            "normal routing, i.e. a full re-prefill, never a client error)",
            ("outcome",))
        self._m_resumes = reg.counter(
            "dllama_stream_resume_total",
            "Mid-stream failover resume attempts after an upstream died "
            "mid-SSE, by outcome (ok = the stream continued bit-identically "
            "on a sibling replica after a clean death; stall = same, but "
            "the death verdict came from the inter-byte --stall-timeout "
            "budget on a silent upstream; every other outcome — no_ckpt, "
            "stale_ckpt, admit_failed, no_replica, injected, exhausted — "
            "ended the stream with a clean SSE error event + [DONE], never "
            "a silent TCP cut)",
            ("outcome",))
        self._m_ckpt_entries = reg.gauge(
            "dllama_router_ckpt_entries",
            "Live checkpoints in the router's bounded resume store (one "
            "per in-flight checkpointing stream; popped at stream end)")
        self._m_ckpt_entries.set_function(self.ckpt_store.__len__)
        self._m_ckpt_expired = reg.counter(
            "dllama_router_ckpt_expired_total",
            "Checkpoint-store entries reclaimed by the TTL sweep (orphaned "
            "by abnormal stream teardown — no relay was left to pop them); "
            "LRU capacity eviction is NOT counted here")
        self._m_fleet_replicas = reg.gauge(
            "dllama_fleet_replicas",
            "Replicas currently registered with the router (every "
            "lifecycle state but gone: joining and draining replicas are "
            "paid-for capacity even while they take no new picks)")
        self._m_fleet_replicas.set_function(self._count_registered)
        self._m_scale_events = reg.counter(
            "dllama_fleet_scale_events_total",
            "Elastic-fleet scale transitions, by event (joined/draining/"
            "retired are the normal lifecycle edges; spawn_failed/"
            "prewarm_fallback/drain_killed/injected count the degraded "
            "paths — every failure mode is a row here, never a silent "
            "retry loop)",
            ("event",))
        self._m_policy_evals = reg.counter(
            "dllama_fleet_policy_evals_total",
            "Autoscaler policy-engine evaluations, by decision (up/down/"
            "hold, or injected when the policy_eval fault seam fired and "
            "the tick was skipped)",
            ("decision",))
        self._m_probe_age = reg.gauge(
            "dllama_router_probe_age_seconds",
            "Seconds since each replica's last completed /ready probe "
            "(absent until one completes); pick() stops trusting a load "
            "snapshot older than twice the probe interval",
            ("replica",))
        for r in self._replicas:
            self._m_probe_age.set_function(r.probe_age_s, replica=r.name)
        # the router's own flight recorder — like its registry, never the
        # process default: in-process fleet tests run replicas beside it
        # and the rings must not mix
        self.flight = (observability.FlightRecorder(process="router")
                       if enable_flight else None)
        # the router's own bounded metric history (GET /metrics/history
        # answers it under "router", next to the federated replica views);
        # the sampler thread starts/stops with the probe loop
        self.ts_store = TimeSeriesStore()
        self.sampler = Sampler(reg, self.ts_store, interval_s=ts_interval)
        self._probe_supervisor = None
        self._probe_stop = threading.Event()

    # -- the dynamic replica registry -------------------------------------

    @property
    def replicas(self) -> tuple:
        """A point-in-time snapshot of the registered replica set. Every
        reader iterates this tuple (never the underlying list), so a
        concurrent register/deregister changes what the NEXT reader sees,
        never what the current one is iterating."""
        with self._replicas_lock:
            return tuple(self._replicas)

    def _count_registered(self) -> int:
        with self._replicas_lock:
            return len(self._replicas)

    def register_replica(self, host: str, port: int,
                         lifecycle: str = LIFECYCLE_JOINING):
        """Add a replica to the routing set (idempotent by host:port —
        re-registering an existing name returns the existing Replica).
        New elastic replicas join as ``joining``: probed, federated into
        the fleet picture, but invisible to pick() until
        :meth:`activate_replica`."""
        name = f"{host}:{port}"
        with self._replicas_lock:
            for r in self._replicas:
                if r.name == name:
                    return r
            r = Replica(host, port, lifecycle=lifecycle)
            self._replicas = self._replicas + [r]
        self._m_probe_age.set_function(r.probe_age_s, replica=r.name)
        if self.flight is not None:
            self.flight.record("replica_register", replica=name,
                               lifecycle=lifecycle)
        return r

    def activate_replica(self, name: str) -> bool:
        """joining -> active: the replica starts taking picks. Counted as
        the ``joined`` scale event (the marker `cli top` renders)."""
        for r in self.replicas:
            if r.name == name:
                r.set_lifecycle(LIFECYCLE_ACTIVE)
                self._m_scale_events.inc(event="joined")
                return True
        return False

    def drain_replica(self, name: str) -> bool:
        """active -> draining: no new picks, no resume targeting, but the
        replica keeps its in-flight streams (and stays federated) until
        the supervisor finishes the drain."""
        for r in self.replicas:
            if r.name == name:
                r.set_lifecycle(LIFECYCLE_DRAINING)
                self._m_scale_events.inc(event="draining")
                return True
        return False

    def deregister_replica(self, name: str) -> bool:
        """Remove a replica from the routing set (the ``retired`` scale
        event). Its probe-age gauge series is retired with it — the
        callback is swapped for NaN, which the gauge renderer skips."""
        gone = None
        with self._replicas_lock:
            for r in self._replicas:
                if r.name == name:
                    gone = r
                    break
            if gone is None:
                return False
            self._replicas = [r for r in self._replicas if r.name != name]
        gone.set_lifecycle(LIFECYCLE_GONE)
        self._m_probe_age.set_function(lambda: float("nan"), replica=name)
        self._m_scale_events.inc(event="retired")
        if self.flight is not None:
            self.flight.record("replica_deregister", replica=name)
        return True

    # -- routing ----------------------------------------------------------

    def pick(self, hashes: list, exclude=frozenset(), role: str = None,
             slo_class: str = None):
        """Choose the replica for one dispatch attempt: (replica, reason).

        Fires the ``route_pick`` seam (an injected fault here surfaces as
        a 5xx the ingress counter sees). Affinity wins when its target is
        routable and unsaturated; otherwise weighted least-load over every
        routable replica not already tried this request, with the
        request's SLO-class lane pressure folded into the score
        (``slo_class`` — see :func:`load_score`).

        ``role`` narrows the candidate set to replicas that DECLARED that
        disaggregation role (the migration hops). Normal picks
        (``role=None``) exclude dedicated-prefill replicas — their slots
        exist to turn prompts around fast, not to hold whole decodes —
        unless they are the only routable capacity left (availability
        beats placement policy)."""
        faults.fire("route_pick")
        candidates = []
        spares = []  # dedicated-prefill replicas, normal traffic's last resort
        for r in self.replicas:
            if r.name in exclude:
                continue
            s = r.snapshot()
            if s["state"] != LIFECYCLE_ACTIVE:
                continue  # joining replicas are still pre-warming;
                #            draining ones must never gain NEW streams
                #            (that includes resume targeting — a resumed
                #            stream would just need a second failover)
            if not (s["ready"] and not s["circuit_open"]):
                continue
            if role is not None:
                if s["role"] == role:
                    candidates.append((r, s))
            elif s["role"] == "prefill":
                spares.append((r, s))
            else:
                candidates.append((r, s))
        if role is None and not candidates:
            candidates = spares
        if not candidates:
            raise NoReplicaAvailable(len(self.replicas), len(exclude),
                                     retry_after_s=max(
                                         1.0, self.probe_interval_s))
        reason = "least_load"
        if hashes:
            target = self.affinity.lookup(hashes)
            if target is not None:
                for r, s in candidates:
                    if r.name != target:
                        continue
                    if not saturated(s):
                        self._m_picks.inc(reason="affinity")
                        return r, "affinity"
                    reason = "affinity_fallback"
                    break
        # probe-staleness fallback: a snapshot older than 2x the probe
        # interval no longer describes the replica (wedged probe loop,
        # slow-walking /ready) — weight those candidates by the router's
        # own live in-flight count only
        stale_after_s = 2.0 * self.probe_interval_s
        r, _ = min(candidates,
                   key=lambda rs: load_score(
                       rs[1],
                       stale=(rs[1]["probed_age_s"] is not None
                              and rs[1]["probed_age_s"] > stale_after_s),
                       slo_class=slo_class))
        self._m_picks.inc(reason=reason)
        return r, reason

    def disagg_ready(self) -> bool:
        """Is the migration path open RIGHT NOW? Requires at least one
        routable dedicated-prefill AND one routable dedicated-decode
        replica. "both" replicas don't count toward either side — they
        serve end-to-end, and a fleet of only those never migrates."""
        roles = set()
        for r in self.replicas:
            s = r.snapshot()
            if (s["state"] == LIFECYCLE_ACTIVE
                    and s["ready"] and not s["circuit_open"]):
                roles.add(s["role"])
        return "prefill" in roles and "decode" in roles

    # -- probing ----------------------------------------------------------

    def probe_replica(self, r: Replica) -> bool:
        """One active /ready probe. Fires the ``probe`` seam; any failure
        (connect, stall, unparseable body, injected) is a DOWN verdict
        that takes the replica out of rotation until a probe succeeds.

        Two deadlines, one per edge: ``connect_timeout_s`` covers the TCP
        connect, then the socket is re-armed with the (short)
        ``probe_read_timeout_s`` for the response read. A GRAY replica —
        one that accepts the socket and then never answers — used to cost
        the whole connect timeout per probe pass AND read as merely
        not-ready; now it costs one read deadline, is counted under
        ``dllama_router_probe_errors_total{reason=stall}``, and is marked
        circuit-open immediately (accepting-but-silent is worse than
        refusing: the data path would hang there too)."""
        connected = False
        try:
            faults.fire("probe")
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=self.connect_timeout_s)
            try:
                conn.connect()
                connected = True
                if conn.sock is not None:
                    conn.sock.settimeout(
                        self.probe_read_timeout_s or self.connect_timeout_s)
                t_send = time.monotonic()
                conn.request("GET", "/ready",
                             headers={HDR_REQUEST_ID:
                                      observability.new_request_id()})
                resp = conn.getresponse()
                body = resp.read()
                t_recv = time.monotonic()
            finally:
                conn.close()
            info = json.loads(body) if body else {}
            if not isinstance(info, dict):
                raise ValueError("non-object /ready body")
            ready = resp.status == 200
            # clock-offset estimate for trace stitching: the replica stamps
            # /ready with its monotonic-epoch time_us; assuming the reply
            # was stamped mid-round-trip, the difference to our own
            # mid-point is skew (error bounded by RTT/2 — microseconds on
            # loopback, where fleets under one router live)
            offset_us = None
            t_us = info.get("time_us")
            if isinstance(t_us, (int, float)):
                mid_us = observability.mono_to_us((t_send + t_recv) / 2.0)
                offset_us = int(t_us) - mid_us
            prev_gen = r.mark_probe(ready, info, offset_us=offset_us)
            if prev_gen is not None:
                new_gen = info.get("replica_id")
                print(f"🔁 router: replica {r.name} restarted "
                      f"(generation {prev_gen} -> {new_gen})",
                      file=sys.stderr)
                if self.flight is not None:
                    self.flight.record("replica_generation",
                                       replica=r.name, prev=prev_gen,
                                       new=new_gen)
            return ready
        except (OSError, ValueError, faults.FaultInjected) as e:
            # an unreachable/garbled probe IS the health signal, not an
            # error to propagate: record DOWN and keep the loop alive
            r.mark_probe(False, None)
            if isinstance(e, faults.FaultInjected):
                reason = "injected"
            elif isinstance(e, TimeoutError) and connected:
                reason = "stall"
                r.mark_conn_failure()  # gray: circuit-open NOW, not just
                #                        not-ready — the data path would
                #                        hang on this replica too
            elif isinstance(e, ValueError):
                reason = "parse"
            else:
                reason = "connect"
            self._m_probe_failures.inc(replica=r.name)
            self._m_probe_errors.inc(replica=r.name, reason=reason)
            return False

    def probe_once(self) -> int:
        """Probe the whole fleet; returns (and gauges) the in-rotation
        count."""
        n_ready = 0
        for r in self.replicas:
            if self.probe_replica(r):
                n_ready += 1
        self._m_replicas_ready.set(float(n_ready))
        # the probe cadence doubles as the checkpoint-store TTL sweep:
        # entries orphaned by abnormal stream teardown are reclaimed here
        # instead of squatting until LRU pressure evicts a live stream's
        expired = self.ckpt_store.sweep()
        if expired:
            self._m_ckpt_expired.inc(expired)
        return n_ready

    def _probe_loop(self) -> None:
        while not self._probe_stop.is_set():
            self.probe_once()
            self._probe_stop.wait(self.probe_interval_s)

    def start_probes(self) -> None:
        """Start the background probe loop (idempotent), supervised the
        same way the replica scheduler is: a crashed loop restarts rather
        than silently freezing the fleet picture at its last snapshot."""
        if self._probe_supervisor is not None:
            return
        self._probe_supervisor = Supervisor(
            self._probe_loop,
            on_crash=lambda exc: None,  # state is probe-local; next round
            name="dllama-router-probe")  # rebuilds it from scratch
        self._probe_supervisor.start()
        self.sampler.start()  # history rides the probe loop's lifetime

    def stop_probes(self) -> None:
        self._probe_stop.set()
        self.sampler.stop()
        if self._probe_supervisor is not None:
            self._probe_supervisor.stop()

    # -- views ------------------------------------------------------------

    def readiness(self) -> tuple:
        """(ready, info) for the router's own /ready: ready iff at least
        one replica is in rotation. The info aggregates the fleet load
        picture so one curl answers 'can you take traffic, and how much'."""
        snaps = [r.snapshot() for r in self.replicas]
        routable = [s for s in snaps
                    if s["state"] == LIFECYCLE_ACTIVE
                    and s["ready"] and not s["circuit_open"]]
        agg = {
            "slots_occupied": 0, "slots_total": 0, "queue_depth": 0,
            "kv_pages_free": 0, "kv_pages_total": 0,
            "kv_pages_reclaimable": 0,
        }
        for s in routable:
            load = s.get("load") or {}
            for k in agg:
                agg[k] += load.get(k, 0)
            # radix-cached pages are evictable on demand: capacity the
            # autoscaler must see as available, or a warmed-up idle
            # fleet reads as saturated forever and never scales down
            agg["kv_pages_reclaimable"] += (
                (load.get("kv_pages") or {}).get("pages_cached", 0))
        return len(routable) > 0, {
            "status": "ready" if routable else "not_ready",
            "replicas_total": len(snaps),
            "replicas_ready": len(routable),
            "fleet": agg,
            "replicas": snaps,
        }

    def stats(self) -> dict:
        ready, info = self.readiness()
        return {
            "role": "router",
            "uptime_s": round(time.time() - self.started_at, 1),
            "ready": ready,
            "affinity_entries": len(self.affinity),
            "load": info,
            "metrics": self.metrics.snapshot(),
        }

    # -- fleet observability ----------------------------------------------

    def _scrape(self, r: Replica, path: str) -> bytes:
        """One GET against a replica's local surface (metrics/flight)."""
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.connect_timeout_s)
        try:
            conn.request("GET", path, headers={
                HDR_REQUEST_ID: observability.new_request_id()})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ValueError(f"{path} -> {resp.status}")
            return body
        finally:
            conn.close()

    def federate(self) -> str:
        """The /metrics/fleet body: every in-rotation replica's /metrics,
        merged under a ``replica`` label. Crashed/draining replicas fall
        out of the merge with their circuit/ready verdict, so a restarted
        replica never leaves stale series behind; a failed scrape (fires
        the ``federate_scrape`` seam) is counted and skipped — the
        endpoint itself always answers."""
        parts = []
        for r in self.replicas:
            body = self._federated_scrape(r, "/metrics")
            if body is not None:
                parts.append((r.name, body.decode("utf-8", "replace")))
        return merge_expositions(parts)

    def _federated_scrape(self, r: Replica, path: str):
        """One replica's contribution to a federation pass, or None —
        every skip is counted by reason in
        ``dllama_router_federate_skipped_total`` (a hole in the federated
        picture must be machine-visible, not a silent absence)."""
        s = r.snapshot()
        if not s["ready"]:
            self._m_federate_skipped.inc(reason="not_ready")
            return None
        if s["circuit_open"]:
            self._m_federate_skipped.inc(reason="circuit_open")
            return None
        try:
            faults.fire("federate_scrape")
            return self._scrape(r, path)
        except (OSError, ValueError, faults.FaultInjected):
            self._m_federate_errors.inc(replica=r.name)
            self._m_federate_skipped.inc(reason="unreachable")
            return None

    def federate_history(self, window_s: float) -> dict:
        """The /metrics/history federation: the router's own window plus
        every in-rotation replica's, keyed per replica."""
        out = {"window_s": window_s,
               "router": self.ts_store.window(window_s), "replicas": {}}
        for r in self.replicas:
            body = self._federated_scrape(
                r, f"/metrics/history?window={window_s:g}")
            if body is None:
                continue
            try:
                out["replicas"][r.name] = json.loads(body)
            except ValueError:
                self._m_federate_errors.inc(replica=r.name)
        return out

    def federate_alerts(self) -> dict:
        """The /alerts federation: every in-rotation replica's burn-rate
        alert picture, with a fleet-wide firing count on top."""
        out = {"replicas": {}, "firing": 0}
        for r in self.replicas:
            body = self._federated_scrape(r, "/alerts")
            if body is None:
                continue
            try:
                payload = json.loads(body)
            except ValueError:
                self._m_federate_errors.inc(replica=r.name)
                continue
            out["replicas"][r.name] = payload
            out["firing"] += int(payload.get("firing") or 0)
        return out

    def flight_report(self) -> dict:
        """The router's own flight ring plus every replica's /debug/flight
        — the aggregate a postmortem starts from after an upstream
        failure. Unreachable replicas (usually exactly the interesting
        ones) report their routing verdict in place of a ring; their
        on-crash dump lives in $DLLAMA_FLIGHT on disk."""
        out = {
            "router": (self.flight.snapshot()
                       if self.flight is not None else None),
            "replicas": {},
        }
        for r in self.replicas:
            s = r.snapshot()
            try:
                out["replicas"][r.name] = json.loads(
                    self._scrape(r, "/debug/flight"))
            except (OSError, ValueError):
                out["replicas"][r.name] = {
                    "error": "unreachable",
                    "ready": s["ready"],
                    "circuit_open": s["circuit_open"],
                }
        return out


class ClientGone(OSError):
    """The client vanished mid-response: EOF/reset on its socket, a write
    stalled past the client-stall budget, or an injected ``client_write``
    fault. Raised (once counted) so every relay unwinds through its
    ``finally`` blocks — the upstream socket closes within one chunk and
    the replica's cancel-on-disconnect frees the decode slot."""


class RouterConnection:
    """One client connection on the event loop — the front-door HTTP
    surface. Local routes (/health /ready /metrics /stats) answer from
    RouterState; everything else on the OpenAI surface proxies to a
    picked replica with failover. Every response — local, proxied, or
    error — echoes X-Request-Id, and the same id travels on the upstream
    hop so one grep correlates router and replica traces.

    The connection is a single coroutine (:meth:`run`) driven by the
    server's :class:`~dllama_tpu_torch.serving.evloop.Loop`: requests are read
    under the header deadline (keep-alive between them), responses are
    written under the client-stall deadline, and the relay loops hold at
    most one chunk in hand — a slow client pauses its upstream read
    instead of growing router RSS. Every method here runs ON the loop
    thread: no blocking calls allowed (LOOP-001 enforces the shortlist);
    control-plane work that legitimately blocks (federation scrapes over
    http.client) is shipped to a worker via ``evloop.run_in_thread``."""

    _KNOWN_ROUTES = ("/v1/chat/completions", "/chat/completions",
                     "/v1/models", "/health", "/healthz", "/ready",
                     "/metrics", "/metrics/fleet", "/metrics/history",
                     "/alerts", "/stats", "/debug/flight")

    def __init__(self, server, state: RouterState, sock, addr):
        self.server = server
        self.state = state
        self.sock = sock
        self.addr = addr
        self.buf = bytearray()  # client bytes carried across requests
        self.req = None
        self.path = "/"
        self.close_after = False
        self._client_counted = False  # one disconnect count per connection

    # -- the connection loop ----------------------------------------------

    @loop_callback
    def run(self):
        st = self.state
        try:
            while True:
                deadline = (time.monotonic() + st.header_timeout_s
                            if st.header_timeout_s else None)
                try:
                    req = yield from evloop.read_request(
                        self.sock, self.buf, deadline)
                except evloop.HttpError as e:
                    self._begin_request(None)
                    self.close_after = True
                    yield from self._error(e.status, str(e))
                    return
                if req is None:
                    return  # clean keep-alive close
                self.req = req
                self.path = req.path
                self.close_after = not req.keep_alive
                self._begin_request(req)
                if req.method == "GET":
                    yield from self._do_GET()
                elif req.method == "POST":
                    yield from self._do_POST()
                else:
                    yield from self._error(
                        405, f"method {req.method} not allowed")
                if self.close_after:
                    return
        except (evloop.ProtocolError, evloop.LoopTimeout, ClientGone):
            # garbled head, slow-loris past the header budget, or a client
            # that vanished/stalled mid-response: nothing left to answer
            return

    def _begin_request(self, req) -> None:
        self._rid = observability.sanitize_request_id(
            req.header(HDR_REQUEST_ID) if req is not None else None)
        self._t_begin = time.monotonic()
        # one router span per request: its pid:span value is BOTH the
        # X-Dllama-Parent-Span the replica parents its trace under and the
        # flow-arrow id tying the two process tracks together
        self._span_id = observability.next_span_id()
        self._parent_value = observability.parent_span_value(self._span_id)

    def _route(self) -> str:
        p = self.path.split("?", 1)[0]
        return p if p in self._KNOWN_ROUTES else "other"

    def _count(self, code: int) -> None:
        self.state._m_http.inc(route=self._route(), code=str(code))

    def _server_timing(self) -> str:
        return f"total;dur={(time.monotonic() - self._t_begin) * 1e3:.3f}"

    def _client_deadline(self):
        t = self.state.client_stall_timeout_s
        return time.monotonic() + t if t else None

    # -- writing to the client --------------------------------------------

    @loop_callback
    def _send(self, data: bytes):
        """One client write under the client-stall budget. A failed or
        stalled write (or an injected ``client_write`` fault) counts the
        disconnect ONCE for the connection and raises ClientGone."""
        try:
            faults.fire("client_write")
            yield from evloop.send_all(self.sock, data,
                                       self._client_deadline())
        except (OSError, faults.FaultInjected) as e:
            if not self._client_counted:
                self._client_counted = True
                self.state._m_client_disconnects.inc()
            raise ClientGone(f"client write failed: {e}")

    @loop_callback
    def _respond(self, code: int, headers: list, body: bytes):
        """One complete framed response (the common, non-SSE shape):
        Content-Length so keep-alive survives, standard response headers,
        a single send."""
        hs = list(headers)
        hs.append(("Content-Length", str(len(body))))
        hs.append((HDR_REQUEST_ID, self._rid))
        hs.append((HDR_SERVER_TIMING, self._server_timing()))
        if self.close_after:
            hs.append(("Connection", "close"))
        self._count(code)
        yield from self._send(evloop.response_bytes(code, hs, body))

    @loop_callback
    def _json(self, code: int, obj: dict, headers: dict = None):
        hs = [("Content-Type", "application/json")]
        for k, v in (headers or {}).items():
            hs.append((k, v))
        yield from self._respond(code, hs, json.dumps(obj).encode())

    @loop_callback
    def _text(self, code: int, body: bytes):
        yield from self._respond(
            code,
            [("Content-Type", "text/plain; version=0.0.4; charset=utf-8")],
            body)

    @loop_callback
    def _error(self, code: int, message: str):
        yield from self._json(code, {"error": {"message": message,
                                               "type": "router_error",
                                               "request_id": self._rid}})

    @loop_callback
    def _lifecycle_error(self, e: LifecycleError):
        headers = {}
        if e.retry_after_s is not None:
            headers["Retry-After"] = str(max(1, int(round(e.retry_after_s))))
        yield from self._json(
            e.http_status,
            {"error": {"message": str(e), "type": "server_error",
                       "request_id": self._rid}},
            headers=headers)

    # -- upstream deadlines -----------------------------------------------

    def _deadline(self, seconds: float):
        return time.monotonic() + seconds if seconds else None

    def _first_byte_deadline(self):
        st = self.state
        return self._deadline(st.first_byte_timeout_s
                              or st.upstream_timeout_s)

    def _body_deadline(self):
        return self._deadline(self.state.upstream_timeout_s)

    def _stall_deadline(self):
        st = self.state
        return self._deadline(st.stall_timeout_s or st.upstream_timeout_s)

    # -- local routes -----------------------------------------------------

    @loop_callback
    def _do_GET(self):
        st = self.state
        bare = self.path.split("?", 1)[0]
        if bare in ("/health", "/healthz"):
            # LIVENESS of the router process itself: 200 whenever it can
            # answer, even with zero routable replicas (readiness's job)
            _, info = st.readiness()
            yield from self._json(
                200, {"status": "ok", "role": "router",
                      "replicas_total": info["replicas_total"],
                      "replicas_ready": info["replicas_ready"]})
        elif bare == "/ready":
            ready, info = st.readiness()
            yield from self._json(200 if ready else 503, info)
        elif bare == "/metrics":
            yield from self._text(200, st.metrics.render().encode())
        elif bare == "/metrics/fleet":
            # federation scrapes the fleet over blocking http.client: a
            # worker thread's job, never the loop's
            body = yield from evloop.run_in_thread(st.federate)
            yield from self._text(200, body.encode())
        elif bare == "/metrics/history":
            # federated time-series history: the router's own window plus
            # every in-rotation replica's, per-replica keyed
            window = parse_window(self.path)
            obj = yield from evloop.run_in_thread(
                lambda: st.federate_history(window))
            yield from self._json(200, obj)
        elif bare == "/alerts":
            # the fleet's live SLO burn-rate picture (replica-evaluated;
            # the router only federates)
            obj = yield from evloop.run_in_thread(st.federate_alerts)
            yield from self._json(200, obj)
        elif bare == "/stats":
            yield from self._json(200, st.stats())
        elif bare == "/debug/flight":
            obj = yield from evloop.run_in_thread(st.flight_report)
            yield from self._json(200, obj)
        elif bare == "/v1/models":
            # model identity is fleet-wide (one model per fleet): proxy to
            # any routable replica
            yield from self._proxy("GET", b"", affinity_hashes=[])
        else:
            yield from self._error(404, f"unknown path {self.path}")

    @loop_callback
    def _do_POST(self):
        bare = self.path.split("?", 1)[0]
        if bare not in ("/v1/chat/completions", "/chat/completions"):
            yield from self._error(404, f"unknown path {self.path}")
            return
        body = self.req.body or b"{}"
        try:
            req = json.loads(body or b"{}")
        except ValueError:
            req = None  # let the replica speak the 400; neither affinity
            #             nor migration applies to an unparseable body
        hashes = []
        if self.state.affinity_block > 0 and isinstance(req, dict):
            try:
                hashes = prefix_hashes(req.get("messages") or [],
                                       self.state.affinity_block)
            except (ValueError, AttributeError):
                pass  # malformed messages: no affinity hint, routing
                #       still proceeds (the replica owns the 400)
        if isinstance(req, dict) and req.get("messages"):
            # remember the conversation as pre-warm material: a scaled-up
            # replica replays the hottest of these before taking traffic
            self.state.hot_prompts.record(hashes, req)
        if isinstance(req, dict):
            migrated = yield from self._try_disagg(req, hashes)
            if migrated:
                return  # migrated (or finished at the prefill replica)
        yield from self._proxy(
            "POST", body, affinity_hashes=hashes,
            slo_class=(self.req.header(HDR_CLASS)
                       or "").strip().lower() or None)

    # -- disaggregated migration ------------------------------------------

    @loop_callback
    def _try_disagg(self, req: dict, hashes: list):
        """One migration attempt: prefill hop -> KV relay -> decode hop.

        Returns True iff the request was fully answered here — either the
        decode replica took the handoff and streamed the rest of the row,
        or the row finished during prefill and the prefill replica's
        client-shape answer was relayed verbatim. EVERY failure path
        returns False so _do_POST falls back to normal routing (a full
        re-prefill on whatever replica pick() chooses): a dead decode
        replica or torn transfer costs latency, never a client error.

        Fires the ``migrate`` seam at the decision point (an injected
        fault here exercises exactly that fallback); the hops fire the
        same ``route_pick``/``proxy_upstream`` seams as normal traffic."""
        st = self.state
        if not st.disagg_ready():
            return False
        if int(req.get("n") or 1) != 1:
            # the prefill endpoint rejects n>1 (it fans out) — route
            # normally. Stop strings migrate fine since the detector's
            # scanback travels in the v2 transfer header.
            return False
        outcome = "prefill_fallback"
        detail: dict = {}
        t0 = time.monotonic()
        try:
            try:
                faults.fire("migrate")
            except faults.FaultInjected:
                outcome = "injected"
                return False
            # -- hop 1: prefill -------------------------------------------
            try:
                prefill, _ = st.pick(hashes, role="prefill")
            except (NoReplicaAvailable, faults.FaultInjected):
                outcome = "no_prefill"
                return False
            detail["prefill"] = prefill.name
            body = json.dumps(dict(req, kv_wire=st.kv_wire)).encode()
            prefill.begin()
            up = None
            try:
                try:
                    faults.fire("proxy_upstream")
                    up = yield from evloop.open_upstream(
                        self.server.pool, prefill.host, prefill.port,
                        self._deadline(st.connect_timeout_s))
                    yield from up.request(
                        "POST", "/v1/prefill", self._upstream_headers(),
                        body, self._deadline(st.connect_timeout_s))
                    resp = yield from up.get_response(
                        self._first_byte_deadline())
                except (OSError, faults.FaultInjected) as e:
                    prefill.mark_conn_failure()
                    st._m_upstream_errors.inc(replica=prefill.name)
                    detail["error"] = repr(e)[:200]
                    return False
                if resp.status != 200:
                    if resp.status == 503:
                        prefill.mark_unready()  # draining: out of rotation
                    st._m_upstream_errors.inc(replica=prefill.name)
                    detail["status"] = resp.status
                    return False
                prefill.mark_conn_success()
                ctype = resp.getheader("Content-Type") or ""
                if kv_transfer.CONTENT_TYPE not in ctype:
                    # the row finished during prefill: the reply already
                    # IS the client-shape answer — relay it verbatim
                    outcome = "prefill_done"
                    if "text/event-stream" in ctype:
                        yield from self._relay_sse(resp, up, prefill)
                    else:
                        payload = yield from resp.read_all(
                            self._body_deadline())
                        yield from self._relay_buffered(
                            resp.status, payload, self._relay_headers(resp))
                    if hashes:
                        st.affinity.record(hashes, prefill.name)
                    return True
                # the framed KV page stream, whole
                stream = yield from resp.read_all(self._body_deadline())
            finally:
                prefill.end()
                if up is not None:
                    up.close()
            # -- hop 2: decode import -------------------------------------
            tried: set = set()
            for _ in range(1 + st.retry_budget):
                try:
                    decode, _ = st.pick(hashes, role="decode",
                                        exclude=tried)
                except (NoReplicaAvailable, faults.FaultInjected):
                    break
                tried.add(decode.name)
                detail["decode"] = decode.name
                decode.begin()
                up = None
                try:
                    try:
                        faults.fire("proxy_upstream")
                        up = yield from evloop.open_upstream(
                            self.server.pool, decode.host, decode.port,
                            self._deadline(st.connect_timeout_s))
                        headers = self._upstream_headers()
                        headers["Content-Type"] = kv_transfer.CONTENT_TYPE
                        yield from up.request(
                            "POST", "/v1/kv/import", headers, stream,
                            self._deadline(st.connect_timeout_s))
                        resp = yield from up.get_response(
                            self._first_byte_deadline())
                    except (OSError, faults.FaultInjected) as e:
                        decode.mark_conn_failure()
                        st._m_upstream_errors.inc(replica=decode.name)
                        detail["error"] = repr(e)[:200]
                        continue
                    if resp.status != 200:
                        # 503 = draining, 422 = torn stream, 5xx = import
                        # blew up: none did decode work, try the next one
                        if resp.status == 503:
                            decode.mark_unready()
                        st._m_upstream_errors.inc(replica=decode.name)
                        detail["status"] = resp.status
                        continue
                    decode.mark_conn_success()
                    outcome = "ok"
                    if "text/event-stream" in (resp.getheader("Content-Type")
                                               or ""):
                        yield from self._relay_sse(resp, up, decode)
                    else:
                        payload = yield from resp.read_all(
                            self._body_deadline())
                        yield from self._relay_buffered(
                            resp.status, payload, self._relay_headers(resp))
                    # affinity points at the PREFILL replica: the next
                    # turn's prompt prefix is warm THERE (published at
                    # admit), and warm prefill is where affinity saves
                    # compute — the wire ships every block regardless of
                    # decode-side warmth
                    if hashes:
                        st.affinity.record(hashes, prefill.name)
                    return True
                finally:
                    decode.end()
                    if up is not None:
                        up.close()
            outcome = "import_fallback"
            return False
        finally:
            st._m_migrations.inc(outcome=outcome)
            if st.flight is not None:
                st.flight.record("migrate", request_id=self._rid,
                                 outcome=outcome, **detail)
            if observability.trace_path() is not None:
                us = observability.mono_to_us
                observability.emit_trace_events([
                    {"name": "router_migrate", "ph": "X",
                     "pid": os.getpid(), "tid": self._span_id,
                     "ts": us(t0),
                     "dur": max(1, us(time.monotonic()) - us(t0)),
                     "cat": "router",
                     "args": dict(detail, request_id=self._rid,
                                  outcome=outcome)},
                ])

    # -- the proxy core ---------------------------------------------------

    def _upstream_headers(self) -> dict:
        req = self.req
        h = {HDR_REQUEST_ID: self._rid,
             HDR_PARENT_SPAN: self._parent_value,
             "Content-Type": (req.header("Content-Type")
                              if req is not None else None)
             or "application/json",
             "Accept": (req.header("Accept") if req is not None else None)
             or "*/*"}
        st = self.state
        if st.ckpt_interval > 0:
            # opt every upstream stream into mid-stream checkpointing (the
            # replica ignores this for anything that can't checkpoint);
            # the checkpoint rides the same wire mode as migrations
            h[HDR_CKPT] = str(st.ckpt_interval)
            h[HDR_CKPT_WIRE] = st.kv_wire
        # the SLO class rides every upstream hop untouched: the REPLICA
        # owns validation (unknown class -> its 400 passes straight
        # through), the router only scores by it
        cls = ((req.header(HDR_CLASS) if req is not None else None)
               or "").strip()
        if cls:
            h[HDR_CLASS] = cls
        return h

    @loop_callback
    def _proxy(self, method: str, body: bytes, affinity_hashes: list,
               slo_class: str = None):
        """Dispatch one request with failover.

        Retriable = the hop died before the client received anything — a
        connect error, an injected proxy_upstream fault, a replica killed
        mid-BUFFERED-body (nothing was forwarded yet, so re-dispatch is
        safe) — or a 503 (draining / scheduler mid-restart, no decode work
        done). 429/504 and every other status pass through untouched: a
        429 means the fleet is at capacity (retrying amplifies the
        overload — the client owns the backoff) and a 504 already burned
        the request's deadline. Nothing retries once response bytes have
        been forwarded, which for SSE means once the stream began."""
        st = self.state
        tried: set = set()
        last_503 = None  # pass the FINAL 503 through on budget exhaustion
        attempts = 0
        # the hop record _finish_proxy turns into attribution histograms,
        # router trace spans and (on failure) the error verdict — filled
        # in as the dispatch progresses, reflecting the LAST attempt
        hop = {"replica": None, "status": None, "error": None,
               "t_conn": None, "t_ttfb": None, "timing": {}}
        try:
            while True:
                try:
                    replica, _reason = st.pick(affinity_hashes,
                                               exclude=tried,
                                               slo_class=slo_class)
                except NoReplicaAvailable as e:
                    if last_503 is not None:
                        hop["status"] = last_503[0]
                        yield from self._relay_buffered(*last_503)
                        return
                    hop["error"] = "no_replica"
                    hop["status"] = e.http_status
                    yield from self._lifecycle_error(e)
                    return
                except faults.FaultInjected as e:
                    # an injected route_pick fault is a router bug
                    # stand-in: surfaces as a 500 the ingress counter sees
                    hop["error"] = "route_pick"
                    hop["status"] = 500
                    yield from self._error(500, str(e))
                    return
                tried.add(replica.name)
                replica.begin()
                up = None
                handed_off = False  # up's socket pooled or owned by a relay
                t0 = time.monotonic()
                hop["replica"] = replica.name
                hop["t_conn"], hop["t_ttfb"] = t0, None
                try:
                    try:
                        faults.fire("proxy_upstream")
                        up = yield from evloop.open_upstream(
                            self.server.pool, replica.host, replica.port,
                            self._deadline(st.connect_timeout_s))
                        yield from up.request(
                            method, self.path, self._upstream_headers(),
                            body, self._deadline(st.connect_timeout_s))
                        # two-phase deadline: strict on connect/send, then
                        # the first-byte budget for the status line, then
                        # unlimited (or --upstream-timeout) for the body —
                        # a long decode must not trip the connect timeout
                        resp = yield from up.get_response(
                            self._first_byte_deadline())
                        st._m_ttfb.observe((time.monotonic() - t0) * 1000.0)
                        hop["t_ttfb"] = time.monotonic()
                        hop["status"] = resp.status
                        hop["timing"] = observability.parse_server_timing(
                            resp.getheader(HDR_SERVER_TIMING) or "")
                        streaming = (resp.status == 200
                                     and "text/event-stream"
                                     in (resp.getheader("Content-Type")
                                         or ""))
                        if not streaming:
                            payload = (resp.status,
                                       (yield from resp.read_all(
                                           self._body_deadline())),
                                       self._relay_headers(resp))
                    except (OSError, faults.FaultInjected) as e:
                        replica.mark_conn_failure()
                        st._m_upstream_errors.inc(replica=replica.name)
                        if st.flight is not None:
                            st.flight.record("upstream_error",
                                             replica=replica.name,
                                             request_id=self._rid,
                                             error=repr(e)[:200])
                        if attempts < st.retry_budget:
                            attempts += 1
                            st._m_retries.inc()
                            continue
                        hop["error"] = "upstream"
                        hop["status"] = 502
                        yield from self._error(
                            502, f"upstream {replica.name} failed: {e}")
                        return
                    if resp.status == 503:
                        # draining or scheduler-crashed: out of rotation
                        # NOW (don't wait for the probe), retry elsewhere
                        replica.mark_unready()
                        st._m_upstream_errors.inc(replica=replica.name)
                        if st.flight is not None:
                            st.flight.record("upstream_503",
                                             replica=replica.name,
                                             request_id=self._rid)
                        if attempts < st.retry_budget:
                            attempts += 1
                            st._m_retries.inc()
                            last_503 = payload
                            continue
                        yield from self._relay_buffered(*payload)
                        return
                    # a usable response (200/429/504/4xx/...): this hop is
                    # done retrying — forward it verbatim
                    replica.mark_conn_success()
                    if streaming:
                        handed_off = True  # the relay closes the socket
                        yield from self._relay_sse(resp, up, replica)
                    else:
                        if resp.reusable and not up.buf:
                            # fully-drained framed body on a keep-alive
                            # socket: back to the pool for the next hop
                            self.server.pool.put(replica.host, replica.port,
                                                 up.sock)
                            handed_off = True
                        yield from self._relay_buffered(*payload)
                    if resp.status == 200 and affinity_hashes:
                        st.affinity.record(affinity_hashes, replica.name)
                    return
                finally:
                    # runs on every exit AND every retry `continue`: the
                    # in-flight count and the upstream socket never leak
                    replica.end()
                    if up is not None and not handed_off:
                        up.close()
        finally:
            self._finish_proxy(hop)

    def _finish_proxy(self, hop: dict) -> None:
        """Close out one proxied request: per-hop attribution histograms
        (the router's wall time minus the phases the replica claimed via
        Server-Timing) and the router-side trace spans, flow-arrowed to
        the replica's track. A hop that never produced a usable response
        — including a replica killed mid-request — closes its span with
        ``error=true`` so the orphan is visible, not silently absent."""
        st = self.state
        t_end = time.monotonic()
        timing = hop["timing"]
        if hop["t_conn"] is not None and hop["t_ttfb"] is not None:
            st._m_hop.observe((hop["t_ttfb"] - hop["t_conn"]) * 1e3,
                              phase="connect")
            if "queue" in timing:
                st._m_hop.observe(timing["queue"], phase="upstream_queue")
            if "prefill" in timing or "decode" in timing:
                st._m_hop.observe(timing.get("prefill", 0.0)
                                  + timing.get("decode", 0.0),
                                  phase="upstream_compute")
            st._m_hop.observe((t_end - hop["t_ttfb"]) * 1e3, phase="stream")
        if observability.trace_path() is None:
            return
        pid = os.getpid()
        tid = self._span_id
        us = observability.mono_to_us
        span_args = {"request_id": self._rid, "replica": hop["replica"],
                     "status": hop["status"]}
        if hop["error"] is not None:
            span_args["error"] = True
            span_args["error_kind"] = hop["error"]
        events = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": f"router {self._rid}"}},
            {"name": "router_proxy", "ph": "X", "pid": pid, "tid": tid,
             "ts": us(self._t_begin),
             "dur": max(1, us(t_end) - us(self._t_begin)),
             "cat": "router", "args": span_args},
        ]
        if hop["t_conn"] is not None:
            t_fb = hop["t_ttfb"] if hop["t_ttfb"] is not None else t_end
            events.append(
                {"name": "connect", "ph": "X", "pid": pid, "tid": tid,
                 "ts": us(hop["t_conn"]),
                 "dur": max(1, us(t_fb) - us(hop["t_conn"])),
                 "cat": "router"})
            events.append(observability.flow_start_event(
                self._parent_value, tid, hop["t_conn"]))
            if hop["t_ttfb"] is not None:
                events.append(
                    {"name": "stream", "ph": "X", "pid": pid, "tid": tid,
                     "ts": us(hop["t_ttfb"]),
                     "dur": max(1, us(t_end) - us(hop["t_ttfb"])),
                     "cat": "router"})
        observability.emit_trace_events(events)

    @staticmethod
    def _relay_headers(resp) -> dict:
        """Upstream headers worth forwarding verbatim. Retry-After carries
        the replica's backoff hint on 429/503; Server-Timing carries the
        replica's phase split (the router appends its own total as a
        second header — HTTP merges repeats); X-Request-Id is OURS (the
        replica echoes the same id we sent, so no conflict)."""
        out = {}
        for k in ("Content-Type", "Retry-After", HDR_SERVER_TIMING):
            v = resp.getheader(k)
            if v is not None:
                out[k] = v
        return out

    @loop_callback
    def _relay_buffered(self, status: int, body: bytes, headers: dict):
        # client vanishing before the (already complete) body lands counts
        # in _send and unwinds run(): nothing upstream to cancel or retry
        yield from self._respond(status, list(headers.items()), body)

    @loop_callback
    def _relay_sse(self, resp, up, replica):
        """SSE passthrough: relay upstream bytes to the client as they
        arrive (one chunk in hand at a time — the client write completes
        before the next upstream read, which IS the backpressure: a slow
        client pauses its upstream instead of growing router RSS) —
        byte-identical bodies.

        The one stateful obligation: when the CLIENT disconnects
        mid-stream, close the UPSTREAM connection immediately — the
        replica's cancel-on-disconnect frees the decode slot within one
        chunk. Closing at generator GC instead would keep the dead
        stream decoding for its full completion.

        With ``--ckpt-interval`` > 0 the relay is RESUMABLE instead:
        event-aligned forwarding that strips ``dllama-ckpt`` control
        frames into the checkpoint store and, on upstream death without
        ``[DONE]`` — including a SILENT upstream past the inter-byte
        stall budget — splices a sibling's /v1/kv/resume stream into
        this same client connection (:meth:`_relay_sse_resumable`)."""
        self.close_after = True  # SSE is EOF-delimited toward the client
        try:
            hs = [("Content-Type",
                   resp.getheader("Content-Type") or "text/event-stream"),
                  ("Cache-Control", "no-cache"),
                  ("Connection", "close"),
                  (HDR_REQUEST_ID, self._rid)]
            upstream_timing = resp.getheader(HDR_SERVER_TIMING)
            if upstream_timing:
                hs.append((HDR_SERVER_TIMING, upstream_timing))
            hs.append((HDR_SERVER_TIMING, self._server_timing()))
            self._count(200)
            yield from self._send(evloop.response_bytes(200, hs))
            if self.state.ckpt_interval > 0:
                yield from self._relay_sse_resumable(resp, up, replica)
                return
            while True:
                try:
                    chunk = yield from resp.read_some(self._stall_deadline())
                except OSError:
                    break  # upstream died/stalled mid-stream: the partial
                    #        body and missing [DONE] are the client's
                    #        truncation signal (no resume without ckpts)
                if not chunk:
                    break
                try:
                    yield from self._send(chunk)
                except ClientGone:
                    break
        finally:
            # the immediacy guarantee: upstream socket down NOW, on every
            # exit path (client gone, upstream EOF, relay error)
            up.close()

    @loop_callback
    def _relay_sse_resumable(self, resp, up, replica):
        """The failover relay (client headers already sent): forward the
        upstream stream EVENT-aligned, stripping ``dllama-ckpt`` control
        frames into the checkpoint store, and treat an upstream end
        without ``[DONE]`` as a mid-stream death — clean EOF/torn read
        (cause ``eof``) and an upstream SILENT past the inter-byte
        ``--stall-timeout`` budget (cause ``stall``) take the same resume
        path, distinguished only in the outcome label. One death resumes
        on a sibling via :meth:`_resume_stream` — the continued stream's
        first ``forwarded - offset`` bytes are what the client already
        holds (bit-identical regeneration from the checkpoint), so they
        are discarded and the splice leaves no repeat and no gap. A
        SECOND death, or any fallback-matrix row, terminates cleanly: a
        typed SSE ``error`` event + ``[DONE]`` instead of a bare TCP cut.

        The stall verdict gets one grace read (STALL_DRAIN_GRACE_S):
        bytes already in flight at the expiry instant — including a
        ``[DONE]`` that arrived in the same read as the budget ran out —
        are delivered and FORGIVE the stall; only true silence fails
        over. Without the grace, that race would fail over a stream the
        client was one event away from completing."""
        st = self.state
        rid = self._rid
        forwarded = 0  # client-visible bytes forwarded (event-aligned —
        #                exactly the replica writer's bytes_emitted count)
        skip = 0  # resumed-stream prefix the client already holds
        saw_done = False
        client_gone = False
        owned = False  # True once `replica` was begin()-ed by a resume
        #                (the original caller begin/ends the FIRST hop)
        try:
            while True:
                scanner = observability.SSEScanner()
                cause = "eof"
                while True:  # one upstream's lifetime
                    try:
                        faults.fire("relay_stall")
                        chunk = yield from resp.read_some(
                            self._stall_deadline())
                    except (evloop.LoopTimeout, faults.FaultInjected):
                        # stall verdict — grace drain first: bytes already
                        # in flight beat the expired budget
                        chunk = resp.try_read_now()
                        if not chunk:
                            try:
                                chunk = yield from resp.read_some(
                                    time.monotonic()
                                    + evloop.STALL_DRAIN_GRACE_S)
                            except OSError:
                                chunk = b""
                        if not chunk:
                            cause = "stall"
                            break
                        # data surfaced: forgive the stall and continue
                        # with a fresh inter-byte budget
                    except OSError:
                        chunk = b""  # a torn read is a death, same as EOF
                    if not chunk:
                        break
                    for ev in scanner.feed(chunk):
                        fields = observability.sse_event_fields(ev)
                        if fields.get("event") == _CKPT_EVENT_B:
                            off, _, b64 = fields.get(
                                "data", b"").partition(b" ")
                            try:
                                st.ckpt_store.put(rid, base64.b64decode(b64),
                                                  int(off), replica.name)
                            except ValueError:
                                pass  # malformed frame: keep the last
                                #       good checkpoint
                            continue
                        if skip:  # resumed prefix the client already holds
                            if skip >= len(ev):
                                skip -= len(ev)
                                continue
                            ev = ev[skip:]
                            skip = 0
                        if fields.get("data", b"").strip() == b"[DONE]":
                            saw_done = True
                        if not client_gone:
                            try:
                                yield from self._send(ev)
                            except ClientGone:
                                client_gone = True
                            else:
                                forwarded += len(ev)
                    if client_gone or saw_done:
                        break
                if saw_done or client_gone:
                    return
                # upstream ended without [DONE]: a mid-stream death
                replica.mark_conn_failure()
                st._m_upstream_errors.inc(replica=replica.name)
                if st.flight is not None:
                    st.flight.record("upstream_stream_death",
                                     replica=replica.name, request_id=rid,
                                     forwarded=forwarded, cause=cause)
                if owned:
                    # second death during resume: the fallback matrix says
                    # terminate cleanly, don't chase replicas forever
                    self._account_resume(
                        "exhausted", {"dead": replica.name,
                                      "forwarded": forwarded},
                        time.monotonic())
                    yield from self._fail_stream(
                        "upstream replica died again after a "
                        "resume; stream incomplete")
                    return
                got = yield from self._resume_stream(rid, replica,
                                                     forwarded, cause)
                if isinstance(got, str):
                    yield from self._fail_stream(got)  # already accounted
                    return
                up.close()  # the dead upstream's socket
                resp, up, replica, offset = got
                skip = forwarded - offset
                owned = True
        finally:
            up.close()
            if owned:
                replica.end()
            st.ckpt_store.pop(rid)

    @loop_callback
    def _fail_stream(self, message: str):
        # the torn-stream obligation: resume exhausted -> the client gets
        # a typed terminal error event and a [DONE], so "torn" is
        # distinguishable from "complete" without timeout heuristics
        try:
            yield from self._send(
                b"data: " + json.dumps(
                    {"error": {"message": message, "type": "upstream_error",
                               "code": 502}}).encode()
                + b"\n\ndata: [DONE]\n\n")
        except ClientGone:
            pass  # the client is gone; there is no one left to tell

    @loop_callback
    def _resume_stream(self, rid: str, dead, forwarded: int,
                       cause: str = "eof"):
        """One resume orchestration after ``dead`` died mid-SSE at byte
        ``forwarded``. Fires the ``resume`` seam at the decision point.

        Returns ``(resp, up, replica, offset)`` on success — outcome
        "ok" (or "stall" when the death verdict came from the inter-byte
        stall budget), the sibling's in-flight count held (begin without
        end) until the relay finishes — or a client-facing failure
        message string with the fallback-matrix outcome (no_ckpt /
        stale_ckpt / no_replica / admit_failed / injected) already
        accounted."""
        st = self.state
        outcome = "no_ckpt"
        detail: dict = {"dead": dead.name, "forwarded": forwarded,
                        "cause": cause}
        t0 = time.monotonic()
        try:
            try:
                faults.fire("resume")
            except faults.FaultInjected:
                outcome = "injected"
                return "resume fault injected; stream incomplete"
            entry = st.ckpt_store.get(rid)
            if entry is None:
                outcome = "no_ckpt"
                return ("upstream replica died mid-stream and no "
                        "checkpoint exists; stream incomplete")
            offset = int(entry["offset"])
            detail["offset"] = offset
            if offset > forwarded:
                # the snapshot claims MORE bytes than the client holds:
                # splicing would leave a gap — refuse rather than corrupt
                outcome = "stale_ckpt"
                return ("checkpoint is ahead of the forwarded stream; "
                        "stream incomplete")
            tried = {dead.name}
            attempted = 0
            for _ in range(1 + st.retry_budget):
                try:
                    sibling, _ = st.pick([], exclude=tried)
                except (NoReplicaAvailable, faults.FaultInjected):
                    break
                tried.add(sibling.name)
                attempted += 1
                detail["sibling"] = sibling.name
                sibling.begin()
                ok = False
                up = None
                try:
                    try:
                        faults.fire("proxy_upstream")
                        up = yield from evloop.open_upstream(
                            self.server.pool, sibling.host, sibling.port,
                            self._deadline(st.connect_timeout_s))
                        headers = self._upstream_headers()
                        headers["Content-Type"] = kv_transfer.CONTENT_TYPE
                        yield from up.request(
                            "POST", "/v1/kv/resume", headers,
                            entry["payload"],
                            self._deadline(st.connect_timeout_s))
                        resp = yield from up.get_response(
                            self._first_byte_deadline())
                    except (OSError, faults.FaultInjected) as e:
                        sibling.mark_conn_failure()
                        st._m_upstream_errors.inc(replica=sibling.name)
                        detail["error"] = repr(e)[:200]
                        continue
                    if (resp.status != 200 or resp.getheader(
                            HDR_RESUME_OFFSET) is None):
                        # 503 = draining/full pool, 422 = the checkpoint
                        # itself was rejected; either way THIS sibling did
                        # no decode work — try the next one
                        if resp.status == 503:
                            sibling.mark_unready()
                        st._m_upstream_errors.inc(replica=sibling.name)
                        detail["status"] = resp.status
                        continue
                    sibling.mark_conn_success()
                    # a successful resume after a STALL death is the stall
                    # outcome — the row a shedding benchmark asserts on
                    outcome = "stall" if cause == "stall" else "ok"
                    ok = True
                    return resp, up, sibling, offset
                finally:
                    if not ok:
                        sibling.end()
                        if up is not None:
                            up.close()
            outcome = "admit_failed" if attempted else "no_replica"
            return ("no sibling replica accepted the checkpoint; "
                    "stream incomplete" if attempted else
                    "no sibling replica available for resume; "
                    "stream incomplete")
        finally:
            self._account_resume(outcome, detail, t0)

    def _account_resume(self, outcome: str, detail: dict, t0: float) -> None:
        """Every resume decision — ok or any fallback-matrix row — lands
        in the counter, the flight ring, and (when tracing) a
        ``router_resume`` hop span, mirroring the migrate accounting."""
        st = self.state
        st._m_resumes.inc(outcome=outcome)
        if st.flight is not None:
            st.flight.record("resume", request_id=self._rid,
                             outcome=outcome, **detail)
        if observability.trace_path() is not None:
            us = observability.mono_to_us
            observability.emit_trace_events([
                {"name": "router_resume", "ph": "X",
                 "pid": os.getpid(), "tid": self._span_id,
                 "ts": us(t0),
                 "dur": max(1, us(time.monotonic()) - us(t0)),
                 "cat": "router",
                 "args": dict(detail, request_id=self._rid,
                              outcome=outcome)},
            ])


def create_router_server(state: RouterState, host: str = "0.0.0.0",
                         port: int = 9900):
    """The router's event-loop front door: one selectors loop carrying
    every client connection as a coroutine (same server_address /
    serve_forever / shutdown / server_close surface the threaded server
    had). Admission runs at accept time, BEFORE any per-connection state
    exists: the ``conn_accept`` seam fires first (injectable shed), then
    ``--max-conns`` sheds with a canned 503 + Retry-After — an overloaded
    router refuses cheaply instead of degrading every live stream."""
    shed_body = json.dumps(
        {"error": {"message": "router at connection capacity",
                   "type": "server_error"}}).encode()
    retry_after = str(max(1, int(round(max(1.0, state.probe_interval_s)))))
    shed_response = evloop.response_bytes(503, [
        ("Content-Type", "application/json"),
        ("Retry-After", retry_after),
        ("Content-Length", str(len(shed_body))),
        ("Connection", "close"),
    ], shed_body)

    def gate(server):
        try:
            faults.fire("conn_accept")
        except faults.FaultInjected:
            return "injected"
        if state.max_conns and server.open_conns >= state.max_conns:
            return "max_conns"
        return None

    def conn_handler(server, sock, addr):
        return RouterConnection(server, state, sock, addr).run()

    srv = evloop.EventLoopServer(
        (host, port), conn_handler, gate=gate,
        shed_response=shed_response,
        on_shed=lambda reason: state._m_sheds.inc(reason=reason))
    srv.pool = evloop.UpstreamPool()
    state._m_conns.set_function(lambda: float(srv.open_conns))
    return srv


def state_from_args(args, replica_addrs: list) -> RouterState:
    """RouterState from parsed `cli router`/`cli fleet` flags + a list of
    "host:port" strings."""
    replicas = []
    for addr in replica_addrs:
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"bad --replica {addr!r}: want HOST:PORT")
        replicas.append(Replica(host, int(port)))
    if not replicas:
        raise SystemExit("router needs at least one --replica HOST:PORT")
    return RouterState(
        replicas,
        retry_budget=getattr(args, "retry_budget", 2),
        probe_interval_s=getattr(args, "probe_interval", 1.0),
        connect_timeout_s=getattr(args, "connect_timeout", 2.0),
        upstream_timeout_s=getattr(args, "upstream_timeout", 0.0),
        affinity_block=getattr(args, "affinity_block", 256),
        kv_wire=getattr(args, "kv_wire", "f32") or "f32",
        ckpt_interval=getattr(args, "ckpt_interval", 32),
        ckpt_ttl_s=getattr(args, "ckpt_ttl", 600.0),
        ts_interval=getattr(args, "ts_interval", 1.0),
        max_conns=getattr(args, "max_conns", 0),
        header_timeout_s=getattr(args, "header_timeout", 10.0),
        first_byte_timeout_s=getattr(args, "first_byte_timeout", 0.0),
        stall_timeout_s=getattr(args, "stall_timeout", 0.0),
        client_stall_timeout_s=getattr(args, "client_stall_timeout", 30.0),
        probe_read_timeout_s=getattr(args, "probe_read_timeout", 2.0),
    )


def run_router(args) -> None:
    """``cli router``: front a fleet of already-running replicas. No torch,
    no model artifacts — the router is pure stdlib networking and starts
    in milliseconds."""
    state = state_from_args(args, args.replica)
    observability.emit_process_name("router")
    state.probe_once()  # synchronous first round: start with a real picture
    state.start_probes()
    srv = create_router_server(state, host=args.host, port=args.port)
    print(f"🛰️  router on {args.host}:{args.port} -> "
          f"{', '.join(r.name for r in state.replicas)} "
          f"(affinity block {state.affinity_block}B, "
          f"retry budget {state.retry_budget})")
    try:
        srv.serve_forever()
    finally:
        state.stop_probes()
