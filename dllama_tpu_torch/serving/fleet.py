"""Local fleet supervisor: N ``dllama-api`` replicas + the router, one
command — and, with ``--autoscale``, the closed loop that makes fleet
size a control variable.

``cli fleet`` spawns N ``cli serve`` subprocesses sharing one model
artifact on consecutive ports, supervises them (a crashed replica restarts
under a per-replica budget, with a capped + jittered exponential backoff
so a crash-looping replica can't thundering-herd the supervisor; the
router's probe loop routes around it in the meantime), fronts them with
the in-process router, and on SIGTERM drains the whole topology in order:
stop restarting, SIGTERM every replica (each drains itself — finishes
in-flight work while its /ready flips 503 and the router stops sending
traffic), then stop the router.

The elastic loop (:class:`ElasticSupervisor`) closes sensors to
actuators: each tick it gathers the federated burn-rate alert state and
the fleet load aggregate, asks the pure policy engine
(:mod:`dllama_tpu_torch.serving.autoscale`) for a :class:`ScaleDecision`, and
executes it live. Scale-up spawns a replica, registers it with the
router as ``joining``, pre-warms the fleet's hot prompt prefixes into it
over the existing ``kv_transfer`` page-stream (sibling ``/v1/prefill``
-> new replica ``/v1/kv/import``) and only then activates it for
traffic; a pre-warm failure (source dies mid-transfer) degrades to a
cold join, counted. Scale-down picks the least-loaded replica, marks it
``draining`` (no new picks, never a resume target), SIGTERMs it so it
finishes its in-flight streams itself, and escalates to SIGKILL at the
drain deadline — at which point the router's CheckpointStore +
``/v1/kv/resume`` machinery migrates any still-open stream to a sibling
byte-identically. Every transition is a ``policy_eval`` / ``scale_up`` /
``scale_down`` fault seam and a row on
``dllama_fleet_scale_events_total``.

This is the test/bench topology — real deployments run ``cli serve`` per
machine under an orchestrator and ``cli router`` in front — but it is the
SAME code path: the router cannot tell fleet-spawned replicas from remote
ones, which is exactly what makes the fleet e2e tests meaningful.

The port's copy of the JAX package's supervisor. Each replica is
``python -m dllama_tpu_torch.cli serve``, which runs on the card
(``cuda:0``: every replica of one supervisor shares it, each with its own
CUDA context, weights, graphs and KV) unless ``--replica-arg "--device
cpu ..."`` asks for the CPU; the supervisor adds no device flag of its
own, so a replica that cannot reach the card fails and stays down rather
than coming back on the CPU. Stdlib-only: the supervisor imports neither
torch nor jax and holds no CUDA context — it is pure process + socket
plumbing.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

from dllama_tpu_torch import faults, observability
from dllama_tpu_torch.analysis.sanitize import guarded_by
from dllama_tpu_torch.serving import autoscale
from dllama_tpu_torch.serving import kv_transfer
from dllama_tpu_torch.serving import router as router_mod


def restart_backoff_s(restarts: int, base_s: float = 0.5,
                      cap_s: float = 8.0, jitter_frac: float = 0.25,
                      salt: int = 0) -> float:
    """Crash-restart delay before restart number ``restarts + 1``.

    The first restart is immediate (a one-off crash should heal at once);
    after that the delay doubles from ``base_s`` and is CAPPED at
    ``cap_s`` — an uncapped exponential turns a persistently-failing
    replica into an effectively-retired one, hiding the crash loop.
    Deterministic jitter (hashed from ``salt``, normally the replica's
    port, and the restart count — never a PRNG, so drills replay exactly)
    spreads up to ``jitter_frac`` of the delay on top, so N replicas all
    killed by one cause don't restart in lockstep and reload weights
    against the same disk at the same instant."""
    if restarts <= 0:
        return 0.0
    delay = min(cap_s, base_s * (2 ** (restarts - 1)))
    spread = ((salt * 2654435761 + restarts * 40503) % 1024) / 1024.0
    return delay * (1.0 + jitter_frac * spread)


class ReplicaProc:
    """Bookkeeping for one replica subprocess (mutated only by Fleet under
    Fleet's lock)."""

    def __init__(self, index: int, host: str, port: int, argv: list):
        self.index = index
        self.host = host
        self.port = port
        self.argv = argv
        self.proc: subprocess.Popen = None
        self.restarts = 0
        self.next_restart_at = None  # backoff deadline; None = no crash seen
        self.retiring = False  # scale-down in progress: exits are expected
        self.env: dict = None  # per-replica overrides (trace part file)

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"


@guarded_by("_lock", "_draining", "_stopped", "replicas")
class Fleet:
    """Spawn + supervise + drain replica subprocesses.

    The replica tuple is rebound only under ``_lock`` (the elastic
    supervisor adds and removes replicas live); readers snapshot
    ``self.replicas`` once and iterate that. Each ReplicaProc's
    ``proc``/``restarts``/``retiring`` fields are only touched by
    :meth:`_spawn`/:meth:`poll_restart`/:meth:`drain` and the scale
    transitions, all serialized by ``_lock`` — the supervision thread,
    the elastic supervisor and the signal-initiated drain thread race on
    exactly those."""

    def __init__(self, model: str, tokenizer: str, n_replicas: int = 2,
                 base_port: int = 9990, host: str = "127.0.0.1",
                 replica_args: list = (), max_restarts: int = 3,
                 log_dir: str = None, env: dict = None,
                 roles: list = None,
                 restart_backoff_base_s: float = 0.5,
                 restart_backoff_cap_s: float = 8.0):
        self.model = model
        self.tokenizer = tokenizer
        self.host = host
        self.max_restarts = max_restarts
        self.log_dir = log_dir
        self.env = dict(env if env is not None else os.environ)
        self.replica_args = list(replica_args)
        self.restart_backoff_base_s = restart_backoff_base_s
        self.restart_backoff_cap_s = restart_backoff_cap_s
        self._lock = threading.Lock()
        self._draining = False
        self._stopped = threading.Event()
        self._supervision: threading.Thread = None
        # scaled-up replicas take fresh ports/indices after the static set
        self._next_port = base_port + n_replicas
        self._next_index = n_replicas
        # per-replica disaggregation role ("prefill"/"decode"/"both"),
        # aligned by index; a role rides the replica's argv so a restart
        # comes back with the same role it crashed with
        roles = list(roles or [])
        self.replicas = tuple(
            ReplicaProc(i, host, base_port + i, self._replica_argv(
                base_port + i,
                roles[i] if i < len(roles) else "both"))
            for i in range(n_replicas))
        # each replica writes its own trace PART file next to the
        # supervisor's: N processes appending to one file would interleave
        # mid-line; run_fleet stitches the parts (skew-corrected) at drain
        if self.env.get("DLLAMA_TRACE"):
            for r in self.replicas:
                r.env = dict(self.env, DLLAMA_TRACE=self.trace_part(r))

    def _replica_argv(self, port: int, role: str = "both") -> list:
        return ([sys.executable, "-m", "dllama_tpu_torch.cli", "serve",
                 "--model", self.model, "--tokenizer", self.tokenizer,
                 "--host", self.host, "--port", str(port)]
                + (["--role", role] if role and role != "both" else [])
                + list(self.replica_args))

    def trace_part(self, r: ReplicaProc):
        """The per-replica trace part file path (None: tracing off)."""
        base = self.env.get("DLLAMA_TRACE")
        return f"{base}.replica-{r.port}" if base else None

    def addresses(self) -> list:
        return [r.name for r in self.replicas]

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def _open_log(self, r: ReplicaProc):
        if not self.log_dir:
            return None  # inherit the supervisor's stderr
        os.makedirs(self.log_dir, exist_ok=True)
        return open(os.path.join(self.log_dir,
                                 f"replica-{r.index}.log"), "ab")

    def _spawn(self, r: ReplicaProc) -> None:
        """Start (or restart) one replica. Caller holds ``_lock``."""
        log = self._open_log(r)
        r.proc = subprocess.Popen(
            r.argv, env=r.env if r.env is not None else self.env,
            stdout=log, stderr=subprocess.STDOUT if log else None,
            start_new_session=True)  # own process group: a ^C at the
        #   supervisor's terminal must not SIGINT replicas mid-drain
        if log is not None:
            log.close()  # Popen holds its own fd

    def start(self) -> None:
        with self._lock:
            for r in self.replicas:
                self._spawn(r)

    # -- elastic scale transitions ---------------------------------------

    def add_replica(self, role: str = "both"):
        """Spawn one more replica on the next free port and add it to the
        supervised set. Returns its ReplicaProc, or None while draining
        (the shutdown path must never race a scale-up)."""
        with self._lock:
            if self._draining:
                return None
            port = self._next_port
            self._next_port += 1
            r = ReplicaProc(self._next_index, self.host, port,
                            self._replica_argv(port, role))
            self._next_index += 1
            if self.env.get("DLLAMA_TRACE"):
                r.env = dict(self.env, DLLAMA_TRACE=self.trace_part(r))
            self._spawn(r)
            self.replicas = self.replicas + (r,)
        return r

    def mark_retiring(self, r: ReplicaProc) -> None:
        """Flag a replica as intentionally going away: poll_restart stops
        resurrecting it (its exit is the drain completing, not a crash)."""
        with self._lock:
            r.retiring = True

    def remove_replica(self, r: ReplicaProc) -> None:
        with self._lock:
            self.replicas = tuple(x for x in self.replicas if x is not r)

    def drain_one(self, r: ReplicaProc, timeout_s: float = 30.0) -> bool:
        """SIGTERM one (already ``retiring``) replica and wait for its
        graceful exit; escalate to SIGKILL at the deadline. Returns True
        for a graceful drain — False means the process had to be killed
        (by us at the deadline, or by out-of-band chaos mid-drain) and
        any in-flight stream it held is now the router's resume problem."""
        p = r.proc
        if p is None:
            return True
        if p.poll() is None:
            p.terminate()
        try:
            p.wait(timeout=max(0.1, timeout_s))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            return False
        return p.returncode != -signal.SIGKILL

    def kill_replica(self, r: ReplicaProc) -> None:
        """Hard-stop a replica that never became ready (failed spawn)."""
        p = r.proc
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()

    # -- readiness --------------------------------------------------------

    @staticmethod
    def _probe_ready(host: str, port: int, timeout_s: float = 1.0) -> bool:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
            try:
                conn.request("GET", "/ready")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False  # not up yet — the caller polls

    def wait_ready(self, timeout_s: float = 180.0) -> bool:
        """Block until EVERY replica answers /ready 200 (model loaded,
        scheduler up). A replica process that already exited fails fast —
        waiting out the full timeout on a crashed replica helps nobody."""
        deadline = time.monotonic() + timeout_s
        pending = list(self.replicas)
        while pending and time.monotonic() < deadline:
            still = []
            for r in pending:
                if r.proc is not None and r.proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {r.name} exited with "
                        f"{r.proc.returncode} before becoming ready")
                if not self._probe_ready(r.host, r.port):
                    still.append(r)
            pending = still
            if pending:
                time.sleep(0.25)
        return not pending

    def wait_ready_one(self, r: ReplicaProc,
                       timeout_s: float = 180.0) -> bool:
        """Like :meth:`wait_ready` for a single (scaled-up) replica, but
        a pre-ready exit returns False instead of raising — a failed
        spawn is a counted scale-up outcome, not a fleet-fatal error."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if r.proc is not None and r.proc.poll() is not None:
                return False
            if self._probe_ready(r.host, r.port):
                return True
            time.sleep(0.25)
        return False

    # -- crash supervision ------------------------------------------------

    def poll_restart(self) -> int:
        """One supervision pass: restart every exited replica still under
        its restart budget whose backoff window has elapsed. Returns the
        number restarted. The router keeps routing around the hole while
        the restart loads weights."""
        n = 0
        now = time.monotonic()
        with self._lock:
            if self._draining:
                return 0  # exits during drain are the POINT, not crashes
            for r in self.replicas:
                if r.retiring:
                    continue  # scale-down exits are the point too
                if r.proc is None or r.proc.poll() is None:
                    r.next_restart_at = None  # alive: clear any pending
                    continue
                if r.restarts >= self.max_restarts:
                    continue  # crash-looping: leave it down, the probe
                    #            loop keeps it out of rotation
                if r.next_restart_at is None:
                    # first pass to observe THIS exit: arm the backoff
                    r.next_restart_at = now + restart_backoff_s(
                        r.restarts, self.restart_backoff_base_s,
                        self.restart_backoff_cap_s, salt=r.port)
                if now < r.next_restart_at:
                    continue  # still backing off
                r.restarts += 1
                r.next_restart_at = None
                print(f"🔁 replica {r.name} exited "
                      f"({r.proc.returncode}); restart "
                      f"{r.restarts}/{self.max_restarts}", file=sys.stderr)
                self._spawn(r)
                n += 1
        return n

    def _supervision_loop(self, interval_s: float) -> None:
        while not self._stopped.is_set():
            self.poll_restart()
            self._stopped.wait(interval_s)

    def start_supervision(self, interval_s: float = 1.0) -> None:
        if self._supervision is not None:
            return
        self._supervision = threading.Thread(
            target=self._supervision_loop, args=(interval_s,),
            daemon=True, name="dllama-fleet-supervise")
        self._supervision.start()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """SIGTERM every replica (each runs its own graceful drain: /ready
        flips 503, in-flight requests finish) and wait; SIGKILL stragglers
        at the deadline. Returns True when every replica exited in time."""
        with self._lock:
            self._draining = True
        self._stopped.set()
        procs = [r.proc for r in self.replicas if r.proc is not None]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + timeout_s
        clean = True
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(0.1, left))
            except subprocess.TimeoutExpired:
                clean = False
                p.kill()
                p.wait()
        return clean


def _post_json(host: str, port: int, path: str, obj: dict,
               connect_timeout_s: float = 2.0,
               read_timeout_s: float = None) -> tuple:
    """One JSON POST: (status, content_type, body). Raises OSError-family
    on transport failure (the caller owns the degradation)."""
    body = json.dumps(obj).encode()
    conn = http.client.HTTPConnection(host, port,
                                      timeout=connect_timeout_s)
    try:
        conn.request("POST", path, body,
                     headers={"Content-Type": "application/json"})
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout_s)
        resp = conn.getresponse()
        return resp.status, (resp.getheader("Content-Type") or ""), \
            resp.read()
    finally:
        conn.close()


def _post_kv(host: str, port: int, path: str, payload: bytes,
             connect_timeout_s: float = 2.0,
             read_timeout_s: float = None) -> tuple:
    """One framed-KV POST: (status, body)."""
    conn = http.client.HTTPConnection(host, port,
                                      timeout=connect_timeout_s)
    try:
        conn.request("POST", path, payload,
                     headers={"Content-Type": kv_transfer.CONTENT_TYPE})
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout_s)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@guarded_by("_lock", "_stopped")
class ElasticSupervisor:
    """The closed loop: sensors -> pure policy -> actuators.

    Each tick (:meth:`step`) gathers one :class:`autoscale.Signals`
    observation from the router's federated alert feed and fleet load
    aggregate, lets the policy decide, and executes. ``_lock`` serializes
    the scale transitions themselves — the periodic tick and an
    operator/drill-forced :meth:`scale_down` may race, and two concurrent
    transitions (or a transition racing the shutdown drain) must never
    interleave their spawn/drain/deregister sequences."""

    def __init__(self, fleet: Fleet, state, policy, interval_s: float = 1.0,
                 ready_timeout_s: float = 180.0,
                 drain_timeout_s: float = 30.0,
                 prewarm_prompts: int = 4, prewarm_tokens: int = 16):
        self.fleet = fleet
        self.state = state  # RouterState (same process — run_fleet wiring)
        self.policy = policy
        self.interval_s = interval_s
        self.ready_timeout_s = ready_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.prewarm_prompts = prewarm_prompts
        self.prewarm_tokens = prewarm_tokens
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: threading.Thread = None

    # -- loop plumbing ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dllama-fleet-autoscale")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=self.drain_timeout_s + 5.0)

    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the loop must live
                print(f"⚠️ autoscale tick failed: {e!r}", file=sys.stderr)
            self._stopped.wait(self.interval_s)

    # -- sensors ----------------------------------------------------------

    def signals(self) -> autoscale.Signals:
        """One observation: the federated burn-rate firing count plus the
        router's aggregate of every ACTIVE replica's load snapshot."""
        alerts = self.state.federate_alerts()
        _, info = self.state.readiness()
        agg = info.get("fleet") or {}
        return autoscale.Signals(
            firing=int(alerts.get("firing") or 0),
            queue_depth=agg.get("queue_depth", 0),
            slots_occupied=agg.get("slots_occupied", 0),
            slots_total=agg.get("slots_total", 0),
            kv_pages_free=agg.get("kv_pages_free", 0),
            kv_pages_total=agg.get("kv_pages_total", 0),
            kv_pages_reclaimable=agg.get("kv_pages_reclaimable", 0))

    def n_replicas(self) -> int:
        return len([r for r in self.fleet.replicas if not r.retiring])

    # -- the tick ---------------------------------------------------------

    def step(self):
        """One policy evaluation + execution. Fires the ``policy_eval``
        seam — an injected fault skips exactly one tick (counted as
        decision="injected"); the loop and the window survive."""
        if self.fleet.draining or self._stopped.is_set():
            return None
        try:
            faults.fire("policy_eval")
        except faults.FaultInjected:
            self.state._m_policy_evals.inc(decision="injected")
            return None
        decision = self.policy.evaluate(time.monotonic(),
                                        self.n_replicas(), self.signals())
        self.state._m_policy_evals.inc(decision=decision.action)
        if decision.action == autoscale.UP:
            self.scale_up()
        elif decision.action == autoscale.DOWN:
            self.scale_down()
        return decision

    # -- actuators --------------------------------------------------------

    def scale_up(self) -> bool:
        """Spawn -> register joining -> wait ready -> pre-warm ->
        activate. Every failure path is counted and leaves the fleet in
        the pre-attempt state (a spawned-but-never-ready process is
        killed and deregistered, not leaked)."""
        st = self.state
        with self._lock:
            try:
                faults.fire("scale_up")
            except faults.FaultInjected:
                st._m_scale_events.inc(event="injected")
                return False
            r = self.fleet.add_replica()
            if r is None:
                return False  # shutting down
            rep = st.register_replica(r.host, r.port)
            print(f"📈 scale-up: spawning replica {r.name}",
                  file=sys.stderr)
            if not self.fleet.wait_ready_one(r, self.ready_timeout_s):
                st._m_scale_events.inc(event="spawn_failed")
                print(f"📈 scale-up: replica {r.name} never became ready; "
                      f"rolling back", file=sys.stderr)
                self.fleet.kill_replica(r)
                self.fleet.remove_replica(r)
                st.deregister_replica(r.name)
                return False
            st.probe_replica(rep)  # a real load picture before traffic
            if not self._prewarm(r):
                st._m_scale_events.inc(event="prewarm_fallback")
                print(f"📈 scale-up: pre-warm failed; {r.name} joins cold",
                      file=sys.stderr)
            st.activate_replica(r.name)  # counts the "joined" event
            print(f"📈 scale-up: replica {r.name} active", file=sys.stderr)
            return True

    def _prewarm(self, r) -> bool:
        """Warm the new replica's radix cache with the fleet's hot prompt
        prefixes before it takes traffic: replay each recorded prompt
        through a warm sibling's ``/v1/prefill`` (nearly free there — the
        sibling's radix cache already holds the prefix pages) and relay
        the framed KV page-stream into the NEW replica's
        ``/v1/kv/import``, which publishes the prompt's pages into its
        radix tree. True = warm join (vacuously, when there is nothing to
        warm); False = cold join (source died mid-transfer or no sibling
        — the caller counts it, traffic starts cold, correctness is
        untouched)."""
        st = self.state
        prompts = st.hot_prompts.top(self.prewarm_prompts)
        if not prompts:
            return True
        try:
            sibling, _ = st.pick([], exclude=frozenset({r.name}))
        except (router_mod.NoReplicaAvailable, faults.FaultInjected):
            return False
        warmed = 0
        for body in prompts:
            req = dict(body, stream=False, kv_wire=st.kv_wire,
                       max_tokens=self.prewarm_tokens)
            req.pop("n", None)
            try:
                status, ctype, payload = _post_json(
                    sibling.host, sibling.port, "/v1/prefill", req,
                    connect_timeout_s=st.connect_timeout_s,
                    read_timeout_s=self.ready_timeout_s)
                if status != 200:
                    continue  # this prompt won't warm; try the others
                if kv_transfer.CONTENT_TYPE not in ctype:
                    continue  # finished inside the first chunk: no pages
                status, _ = _post_kv(
                    r.host, r.port, "/v1/kv/import", payload,
                    connect_timeout_s=st.connect_timeout_s,
                    read_timeout_s=self.ready_timeout_s)
                if status == 200:
                    warmed += 1
            except OSError:
                # the transfer tore mid-flight (source died, new replica
                # hiccuped): cold join, never a blocked scale-up
                return False
        return warmed > 0

    def scale_down(self, target: str = None) -> bool:
        """Retire one replica with zero client-visible errors: mark it
        ``draining`` router-side (no new picks, no resume targeting),
        SIGTERM it so it finishes its own in-flight streams, escalate to
        SIGKILL at the drain deadline (the router's checkpoint/resume
        machinery then migrates any still-open stream to a sibling), and
        deregister. ``target`` pins the victim by name (drills and
        operators); the policy path picks the least-loaded active
        replica."""
        st = self.state
        with self._lock:
            try:
                faults.fire("scale_down")
            except faults.FaultInjected:
                st._m_scale_events.inc(event="injected")
                return False
            procs = [p for p in self.fleet.replicas if not p.retiring]
            if target is None and len(procs) <= 1:
                return False  # never retire the last replica
            victim = None
            if target is not None:
                for p in procs:
                    if p.name == target:
                        victim = p
                        break
                if victim is None:
                    return False
            else:
                # least-loaded ACTIVE replica by the router's own scoring
                # (the same load_score that routes traffic ranks who has
                # the least to drain)
                scores = {}
                for rep in st.replicas:
                    s = rep.snapshot()
                    if s["state"] == router_mod.LIFECYCLE_ACTIVE:
                        scores[s["name"]] = router_mod.load_score(s)
                scored = [p for p in procs if p.name in scores]
                if not scored:
                    return False
                victim = min(scored, key=lambda p: scores[p.name])
            print(f"📉 scale-down: draining replica {victim.name}",
                  file=sys.stderr)
            self.fleet.mark_retiring(victim)
            st.drain_replica(victim.name)  # counts the "draining" event
            graceful = self.fleet.drain_one(victim, self.drain_timeout_s)
            if not graceful:
                # deadline escalation or out-of-band SIGKILL mid-drain:
                # the replica's in-flight streams are now failing over
                # through the checkpoint store — counted, not hidden
                st._m_scale_events.inc(event="drain_killed")
                print(f"📉 scale-down: {victim.name} needed SIGKILL; "
                      f"streams failing over", file=sys.stderr)
            self.fleet.remove_replica(victim)
            st.deregister_replica(victim.name)  # counts "retired"
            print(f"📉 scale-down: replica {victim.name} retired "
                  f"({'graceful' if graceful else 'killed'})",
                  file=sys.stderr)
            return True


def merge_fleet_trace(fleet: Fleet, state) -> int:
    """Stitch the per-replica trace part files into the supervisor's own
    (router) trace file, each shifted by the negated clock offset the
    probe loop estimated for that replica — this is what makes a replica's
    queue/prefill/decode spans nest under the router's proxy spans on one
    timeline despite monotonic-clock skew. Consumes the part files and
    returns the number of events merged; no-op when tracing is off."""
    base = observability.trace_path()
    if base is None:
        return 0
    offsets = {}
    if state is not None:
        offsets = {rep.name: rep.clock_offset_us()
                   for rep in state.replicas}
    parts = []
    for r in fleet.replicas:
        part = fleet.trace_part(r)
        if part and os.path.exists(part):
            # merge_trace_parts ADDS its delta to each ts: subtracting the
            # replica's offset moves its stamps onto the router's clock
            parts.append((part, -offsets.get(r.name, 0)))
    if not parts:
        return 0
    n = observability.merge_trace_parts(base, parts)
    for part, _ in parts:
        try:
            os.remove(part)
        except OSError:
            pass  # the events are already merged; a leftover part file
            #       is clutter, not a failure
    print(f"🧵 merged {n} replica trace event(s) from {len(parts)} part "
          f"file(s) into {base}", file=sys.stderr)
    return n


def supervisor_from_args(args, fleet: Fleet, state) -> ElasticSupervisor:
    """Build the elastic loop from ``cli fleet --autoscale`` flags."""
    cfg = autoscale.PolicyConfig(
        min_replicas=getattr(args, "min_replicas", 1) or 1,
        max_replicas=getattr(args, "max_replicas", 0) or args.replicas,
        up_pressure=getattr(args, "scale_up_pressure", 0.75),
        down_pressure=getattr(args, "scale_down_pressure", 0.25),
        cooldown_up_s=getattr(args, "scale_cooldown_up", 5.0),
        cooldown_down_s=getattr(args, "scale_cooldown_down", 20.0))
    return ElasticSupervisor(
        fleet, state, autoscale.AutoscalePolicy(cfg),
        interval_s=getattr(args, "scale_interval", 1.0),
        ready_timeout_s=args.ready_timeout,
        drain_timeout_s=args.drain_timeout,
        prewarm_tokens=getattr(args, "prewarm_tokens", 16))


def run_fleet(args) -> None:
    """``cli fleet``: the whole local topology — N replicas + router —
    supervised until SIGTERM/SIGINT, then drained in order."""
    replica_args = []
    for extra in getattr(args, "replica_arg", None) or []:
        replica_args.extend(extra.split())
    # the router's --ckpt-interval rides every replica's argv as the
    # serve-side default cadence, so fleet-wide checkpointing is one flag;
    # an explicit --replica-arg '--ckpt-interval ...' later in the argv
    # wins (argparse keeps the last occurrence)
    if "--ckpt-interval" not in replica_args:
        replica_args = (["--ckpt-interval",
                         str(getattr(args, "ckpt_interval", 32))]
                        + replica_args)
    # --slo-classes rides every replica's argv the same way: one fleet
    # flag configures every lane, --replica-arg still overrides
    slo_spec = getattr(args, "slo_classes", None)
    if slo_spec and "--slo-classes" not in replica_args:
        replica_args = ["--slo-classes", slo_spec] + replica_args
    # --ts-interval too: one flag sets the whole fleet's history cadence
    # (router + every replica sampler), --replica-arg still overrides
    if "--ts-interval" not in replica_args:
        replica_args = (["--ts-interval",
                         str(getattr(args, "ts_interval", 1.0))]
                        + replica_args)
    # --prefill N --decode M carve the first N+M replicas into dedicated
    # disaggregation roles (the rest stay "both"); the router migrates
    # only when it can see at least one routable replica of EACH
    n_pre = getattr(args, "prefill", 0) or 0
    n_dec = getattr(args, "decode", 0) or 0
    if bool(n_pre) != bool(n_dec):
        raise SystemExit("--prefill and --decode go together: migration "
                         "needs at least one replica of each role")
    if n_pre + n_dec > args.replicas:
        raise SystemExit(f"--prefill {n_pre} + --decode {n_dec} exceeds "
                         f"--replicas {args.replicas}")
    autoscaling = getattr(args, "autoscale", False)
    if autoscaling and n_pre:
        raise SystemExit("--autoscale and --prefill/--decode are mutually "
                         "exclusive: scaled replicas join as role 'both'")
    roles = (["prefill"] * n_pre + ["decode"] * n_dec
             + ["both"] * (args.replicas - n_pre - n_dec))
    fleet = Fleet(
        args.model, args.tokenizer,
        n_replicas=args.replicas, base_port=args.base_port,
        host=args.replica_host, replica_args=replica_args,
        max_restarts=args.max_restarts, log_dir=args.log_dir,
        roles=roles)
    print(f"🚀 spawning {args.replicas} replicas on "
          f"{args.replica_host}:{args.base_port}..."
          f"{args.base_port + args.replicas - 1}"
          + (f" ({n_pre} prefill + {n_dec} decode + "
             f"{args.replicas - n_pre - n_dec} both)" if n_pre else ""))
    fleet.start()
    state = None
    supervisor = None
    try:
        if not fleet.wait_ready(args.ready_timeout):
            raise RuntimeError(
                f"fleet not ready within {args.ready_timeout:.0f}s")
        fleet.start_supervision()
        state = router_mod.state_from_args(args, fleet.addresses())
        observability.emit_process_name("router")
        state.probe_once()
        state.start_probes()
        if autoscaling:
            supervisor = supervisor_from_args(args, fleet, state)
            supervisor.start()
            print(f"🪜 autoscale on: "
                  f"{supervisor.policy.cfg.min_replicas}..."
                  f"{supervisor.policy.cfg.max_replicas} replicas, "
                  f"eval every {supervisor.interval_s:g}s")
        srv = router_mod.create_router_server(
            state, host=args.host, port=args.port)

        def _drain(_signum=None, _frame=None):
            # off the signal frame: drain blocks up to --drain-timeout and
            # srv.shutdown blocks until serve_forever returns
            print(f"⛔ draining fleet (up to {args.drain_timeout:.0f}s) ...",
                  file=sys.stderr)

            def _run():
                if supervisor is not None:
                    supervisor.stop()
                fleet.drain(args.drain_timeout)
                state.stop_probes()
                srv.shutdown()

            threading.Thread(target=_run, daemon=True,
                             name="dllama-fleet-drain").start()

        try:
            signal.signal(signal.SIGTERM, _drain)
            signal.signal(signal.SIGINT, _drain)
        except ValueError:
            pass  # not the main thread (embedded/test use): no signal hook
        print(f"🛰️  fleet front door on {args.host}:{args.port} -> "
              f"{', '.join(fleet.addresses())}")
        srv.serve_forever()
    finally:
        # belt over braces: serve_forever exits via drain in the normal
        # path, but a startup failure must never orphan replica processes
        if supervisor is not None:
            supervisor.stop()
        fleet.drain(timeout_s=min(5.0, args.drain_timeout))
        # replicas are down (their trace files are final): stitch the
        # parts into the one merged fleet trace
        merge_fleet_trace(fleet, state)
