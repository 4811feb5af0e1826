"""The port's copies of the JAX package's jax-free serving modules, held
against the originals: the same inputs through both copies give the same
outputs. One parametrised test runs one scenario per module: fault-plan
parsing and firing, the metrics exposition, the lock-order sanitizer, the
admission gate / KV budget / SLO classes, the time-series store and burn
rates, the page allocator and radix cache, the protocol constants and the
KV-transfer codec.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _faults(pkg):
    faults = _mod(pkg, "faults")
    out = {"sites": faults.SITES, "metrics": faults.SITE_METRICS}
    plan = faults.FaultPlan.parse(
        "step_chunk:raise:every=3;admit:raise:after=2,times=2;"
        "logits:nan:row=3,every=2;weights_read:bitflip:byte=5;stream:slow:delay_ms=0")
    seq = []
    for site in ("step_chunk", "admit", "logits", "weights_read", "stream") * 6:
        try:
            seq.append((site, plan.fire(site)))
        except faults.FaultInjected as e:
            seq.append((site, "raised", e.site))
    out["fired"] = seq
    out["counters"] = plan.counters()
    for bad in ("nosite:raise", "admit:explode", "admit:raise:every=0", "admit:raise:x=1",
                "admit"):
        try:
            faults.FaultPlan.parse(bad)
            out[bad] = "parsed"
        except ValueError as e:
            out[bad] = str(e)
    return out


def _observability(pkg):
    obs = _mod(pkg, "observability")
    reg = obs.MetricsRegistry()
    c = reg.counter("dllama_x_total", "things", ("kind",))
    g = reg.gauge("dllama_y", "level")
    h = reg.histogram("dllama_z_ms", "latency", buckets=(1.0, 10.0, 100.0))
    for i, v in enumerate([0.5, 3.0, 7.5, 42.0, 250.0, 9.0]):
        c.inc(kind="a" if i % 2 else "b")
        h.observe(v)
    g.set(3.5)
    c.inc(2.5, kind='quo"te')
    return {"text": reg.render(), "p50": h.percentile(50), "p99": h.percentile(99),
            "digest": obs.prompt_digest("hello"),
            "timing": obs.parse_server_timing("queue;dur=1.5, prefill;dur=20")}


_INVERSION = """
import threading, sys
from {pkg}.analysis import sanitize

@sanitize.guarded_by("_la", "_x")
class A:
    def __init__(self):
        self._la = threading.Lock()
        self._x = 0

@sanitize.guarded_by("_lb", "_y")
class B:
    def __init__(self):
        self._lb = threading.Lock()
        self._y = 0

a, b = A(), B()
print(type(a._la).__name__)
with a._la:
    with b._lb:
        pass
try:
    with b._lb:
        with a._la:
            pass
except sanitize.LockOrderError as e:
    print("LockOrderError:", e)
"""


def _sanitize(pkg):
    proc = subprocess.run([sys.executable, "-c", _INVERSION.format(pkg=pkg)], cwd=ROOT,
                          capture_output=True, text=True, timeout=60,
                          env={"DLLAMA_SANITIZE": "1", "PATH": "/usr/bin:/bin",
                               "JAX_PLATFORMS": "cpu"})
    return proc.returncode, proc.stdout


def _lifecycle(pkg):
    lc = _mod(pkg, "serving.lifecycle")
    out = {}
    classes = lc.parse_slo_classes("interactive:depth=3,deadline=30,ttft=100;"
                                   "batch:depth=2,resident=1,tpot=50,err=0.01")
    out["classes"] = {k: v.to_dict() for k, v in sorted(classes.items())}
    gate = lc.AdmissionGate(4, classes=classes)
    events = []
    held = []
    for cls in ("interactive", "batch", "batch", "interactive", "interactive",
                "interactive", "batch"):
        try:
            held.append((gate.acquire(cls), cls))
            events.append(("ok", cls, gate.depth, gate.class_depths()))
        except lc.LifecycleError as e:
            events.append((type(e).__name__, cls, str(e)))
    gate.release(*held.pop(0))
    events.append(("released", gate.depth, gate.class_capacity("batch"),
                   gate.deadline_for("interactive")))
    gate.begin_drain()
    try:
        gate.acquire("interactive")
    except lc.LifecycleError as e:
        events.append((type(e).__name__, e.http_status, str(e)))
    out["gate"] = events
    kv = lc.KVBudget(4 * 64)
    steps = []
    for op, n in (("reserve", 64), ("place", 64), ("reserve", 64), ("place", 64),
                  ("can_fit", 128), ("can_fit", 129), ("release", 64), ("unplace", 64),
                  ("can_fit", 192)):
        r = getattr(kv, op)(n)
        steps.append((op, n, r, kv.reserved, kv.rows_by_bucket()))
    out["kv"] = steps
    for bad in ("interactive:depth=x", "nope:depth=1", "batch:frob=1"):
        try:
            lc.parse_slo_classes(bad)
            out[bad] = "parsed"
        except ValueError as e:
            out[bad] = str(e)
    return out


def _obsv(pkg):
    obsv = _mod(pkg, "obsv")
    ts = _mod(pkg, "obsv.timeseries")
    lc = _mod(pkg, "serving.lifecycle")
    obs = _mod(pkg, "observability")
    store = obsv.TimeSeriesStore(capacity=64)
    count = ts.series_key("dllama_class_ttft_ms", {"slo_class": "interactive"}, "count")
    p95 = ts.series_key("dllama_class_ttft_ms", {"slo_class": "interactive"}, "p95")
    for t in range(40):
        store.record(count, float(t), float(t))
        store.record(p95, float(t), 300.0 if t < 25 else 20.0)
        for code, per in (("200", 9.0), ("500", 1.0)):
            store.record(ts.series_key("dllama_http_requests_total", {"code": code}),
                         float(t), per * t)
    eng = obsv.BurnRateEngine(store, lc.parse_slo_classes("interactive:ttft=100,err=0.05"),
                              obs.MetricsRegistry(), short_s=10.0, long_s=30.0)
    firing = [eng.evaluate(now_s=float(t)) for t in (20, 30, 36, 37, 38, 39)]
    return {"window": store.window(15.0, now_s=39.0), "firing": firing,
            "alerts": eng.alerts_payload()}


def _paged_kv(pkg):
    pk = _mod(pkg, "runtime.paged_kv")
    alloc = pk.PageAllocator(9, 4)
    radix = pk.RadixPrefixCache(4)
    log = [pk.pages_for(13, 4), alloc.can_reserve(8)]
    alloc.reserve(3)
    pages = [alloc.alloc() for _ in range(3)]
    prompt = list(range(11))
    created = radix.insert(prompt, pages[:2])
    for p in created:
        alloc.hold(p)
    log.append(("insert", created))
    log.append(("match", [n.page for n in radix.match(prompt + [99])]))
    for p in pages:
        alloc.unref(p)
    log.append(("stats", alloc.stats()))
    log.append(("evict", radix.evict(1, alloc), alloc.stats(), radix.cached_pages()))
    alloc.check()
    return log


def _protocol(pkg):
    proto = _mod(pkg, "serving.protocol")
    return {k: v for k, v in vars(proto).items() if k.isupper()}


def _kv_transfer(pkg):
    kt = _mod(pkg, "serving.kv_transfer")
    rng = np.random.default_rng(0)
    leaves = [np.asarray(rng.standard_normal((2, 3, 8, 4, 8)) * 3.0, np.float32)
              for _ in range(2)]
    snap = {"page_tokens": 8, "n_blocks": 3, "plen": 10, "pos": 20, "token": 7,
            "keys": [123, 456], "temp": 0.8, "topp": 0.9, "room": 32, "budget": 12,
            "offered": 3, "emitted": 2, "stop_tokens": [2], "leaves": leaves}
    wires = [kt.encode_snapshot(snap, list(range(10)), mode=m, extra={"rid": "x"})
             for m in ("f32", "q80")]
    wires.append(kt.encode_snapshot(snap, list(range(10)), mode="q80",
                                    stop_state={"stops": ["END"], "hold": "EN",
                                                "stopped": False}))
    back = kt.decode_snapshot(wires[1])
    return wires, [leaf.tobytes() for leaf in back["leaves"]], kt.q80_error_bound(leaves[0])


SCENARIOS = {"faults": _faults, "observability": _observability, "sanitize": _sanitize,
             "lifecycle": _lifecycle, "obsv": _obsv, "paged_kv": _paged_kv,
             "protocol": _protocol, "kv_transfer": _kv_transfer}


@pytest.mark.parametrize("module", sorted(SCENARIOS))
def test_port_copy_matches_the_jax_package(module):
    want = SCENARIOS[module]("dllama_tpu")
    got = SCENARIOS[module]("dllama_tpu_torch")
    assert got == want
    if module == "sanitize":  # the inversion really was caught, in both copies
        rc, out = got
        assert rc == 0 and "LockWitness" in out and "LockOrderError:" in out, out
