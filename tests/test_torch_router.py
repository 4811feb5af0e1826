"""The port's fleet router (``dllama_tpu_torch.serving.router``) against the
JAX package's.

* Every case of ``tests/test_router.py`` but the ``cli fleet`` smoke (its
  port version is ``tests/test_torch_cli_fleet.py``) runs again on the
  port's router, against the same in-process ``FakeReplica`` servers
  (``tests/torch_mirror.py`` rebinds the cases).
* The pure functions give the JAX originals' outputs on hypothesis-made
  inputs: ``canonical_prompt_bytes``, ``prefix_hashes``, ``load_score``,
  ``saturated``, ``merge_expositions``, and the bounded ``AffinityIndex``,
  ``CheckpointStore`` and ``HotPrompts`` under one sequence of operations.
* Each client-visible scenario goes through both routers in front of the
  same fakes: the status, the body bytes, the ``X-Request-Id`` and every
  ``/metrics`` counter the scenario moved agree.
"""

import json
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_router as jt
from dllama_tpu import faults as jfaults
from dllama_tpu.serving import router as jrt
from dllama_tpu_torch import faults
from dllama_tpu_torch.serving import router as trt
from tests.test_fleet_obs import EXPO_A, EXPO_B
from tests.torch_mirror import mirror, rebound

globals().update(mirror(jt, skip=("test_fleet_of_two_e2e_chat_smoke",)))

PortRouter = rebound(jt, "RouterUnderTest")
HYP = settings(max_examples=60, deadline=None)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# pure functions: the same outputs on the same inputs
# ---------------------------------------------------------------------------

_content = st.one_of(st.text(max_size=700),
                     st.lists(st.dictionaries(st.sampled_from(["type", "text"]),
                                              st.text(max_size=20), max_size=2),
                              max_size=2))
_messages = st.lists(st.one_of(
    st.fixed_dictionaries({"role": st.sampled_from(["system", "user", "assistant"]),
                           "content": _content}),
    st.integers()), max_size=5)


@HYP
@given(_messages, st.sampled_from([0, 1, 16, 256]))
def test_prompt_bytes_and_prefix_hashes_match_jax(messages, block):
    assert trt.canonical_prompt_bytes(messages) == jrt.canonical_prompt_bytes(messages)
    assert trt.prefix_hashes(messages, block) == jrt.prefix_hashes(messages, block)


_n = st.integers(0, 40)
_load = st.fixed_dictionaries(
    {"slots_occupied": _n, "slots_total": _n, "queue_depth": _n,
     "kv_pages_free": _n, "kv_pages_total": _n},
    optional={"classes": st.dictionaries(
        st.sampled_from(["interactive", "batch"]),
        st.fixed_dictionaries({"capacity": _n, "inflight": _n, "waiting": _n}))})
_snap = st.fixed_dictionaries({"inflight": _n}, optional={"load": _load})


@HYP
@given(_snap, st.booleans(), st.sampled_from([None, "interactive", "batch"]))
def test_load_score_and_saturated_match_jax(snap, stale, slo_class):
    assert (trt.load_score(snap, stale, slo_class)
            == jrt.load_score(snap, stale, slo_class))
    assert trt.saturated(snap) == jrt.saturated(snap)


_sample = st.tuples(st.sampled_from(["dllama_x_total", "dllama_y_ms_bucket",
                                     "dllama_y_ms_sum", "other"]),
                    st.sampled_from(["", '{code="200"}', '{le="+Inf"}']),
                    st.integers(0, 99))
_expo = st.lists(st.one_of(
    _sample.map(lambda s: f"{s[0]}{s[1]} {s[2]}"),
    st.sampled_from(["# HELP dllama_x_total x", "# TYPE dllama_x_total counter",
                     "# TYPE dllama_y_ms histogram", "# HELP", "# note", ""])),
    max_size=8).map("\n".join)


@HYP
@given(st.lists(st.tuples(st.sampled_from(['a:1', 'b"2', "c\\3"]), _expo), max_size=3))
def test_merge_expositions_matches_jax(parts):
    assert trt.merge_expositions(parts) == jrt.merge_expositions(parts)


def test_merge_expositions_of_replica_expositions_matches_jax():
    parts = [("127.0.0.1:1", EXPO_A), ("127.0.0.1:2", EXPO_B)]
    assert trt.merge_expositions(parts) == jrt.merge_expositions(parts)


_hashes = st.lists(st.sampled_from([f"h{i}" for i in range(8)]), max_size=5)
_ops = st.lists(st.one_of(
    st.tuples(st.just("record"), _hashes, st.sampled_from(["r1", "r2", "r3"])),
    st.tuples(st.just("lookup"), _hashes)), max_size=30)


@HYP
@given(_ops, st.integers(1, 6))
def test_affinity_index_matches_jax(ops, capacity):
    t, j = trt.AffinityIndex(capacity), jrt.AffinityIndex(capacity)
    for op in ops:
        if op[0] == "record":
            t.record(op[1], op[2])
            j.record(op[1], op[2])
        else:
            assert t.lookup(op[1]) == j.lookup(op[1])
        assert len(t) == len(j)
    assert list(t._map.items()) == list(j._map.items())


_rid = st.sampled_from([f"req-{i}" for i in range(6)])
_store_ops = st.lists(st.one_of(
    st.tuples(st.just("put"), _rid, st.binary(max_size=8), st.integers(0, 999)),
    st.tuples(st.just("get"), _rid), st.tuples(st.just("pop"), _rid)), max_size=30)


def _entry(e):
    return None if e is None else (e["payload"], e["offset"], e["replica"])


@HYP
@given(_store_ops, st.integers(1, 5), st.sampled_from([0.0, 5.0]))
def test_checkpoint_store_matches_jax(ops, capacity, ttl_s):
    t = trt.CheckpointStore(capacity=capacity, ttl_s=ttl_s)
    j = jrt.CheckpointStore(capacity=capacity, ttl_s=ttl_s)
    for op in ops:
        if op[0] == "put":
            t.put(op[1], op[2], op[3], "rep")
            j.put(op[1], op[2], op[3], "rep")
        elif op[0] == "get":
            assert _entry(t.get(op[1])) == _entry(j.get(op[1]))
        else:
            t.pop(op[1])
            j.pop(op[1])
        assert len(t) == len(j)
    assert t.sweep() == j.sweep() == 0  # nothing is older than the TTL yet
    later = 1e12  # a monotonic time past every entry's TTL
    assert t.sweep(later) == j.sweep(later)
    assert len(t) == len(j)


_reqs = st.lists(st.tuples(
    _hashes, st.fixed_dictionaries({"messages": st.text(max_size=60),
                                    "max_tokens": st.integers(1, 9)})), max_size=20)


@HYP
@given(_reqs, st.integers(1, 5), st.sampled_from([40, 16384]), st.integers(0, 6))
def test_hot_prompts_match_jax(reqs, capacity, max_bytes, n):
    t = trt.HotPrompts(capacity=capacity, max_bytes=max_bytes)
    j = jrt.HotPrompts(capacity=capacity, max_bytes=max_bytes)
    for hashes, req in reqs:
        t.record(hashes, req)
        j.record(hashes, req)
    assert len(t) == len(j) and t.top(n) == j.top(n)


# ---------------------------------------------------------------------------
# client-visible scenarios through both routers
# ---------------------------------------------------------------------------

def _counters(port) -> dict:
    """Every counter sample of a router's /metrics, by its line's name and
    labels."""
    _, body, _ = jt.request(port, "GET", "/metrics")
    counters, out = set(), {}
    for line in body.decode().splitlines():
        if line.startswith("# TYPE ") and line.endswith(" counter"):
            counters.add(line.split()[2])
        elif line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            if head.split("{", 1)[0] in counters:
                out[head] = float(value)
    return out


def _setup(name, a, b):
    """Put the fakes in the scenario's state: (router kwargs, replicas to
    route to, probe first, request)."""
    post = ("POST", "/v1/chat/completions", jt.CHAT)
    both, kw = [a.addr, b.addr], {"retry_budget": 2}
    if name == "json":
        return kw, [a.addr], False, post
    if name == "sse":
        a.mode = "sse"
        return kw, [a.addr], False, post
    if name in ("429", "504"):
        a.mode = name
        b.load.update(slots_occupied=7, queue_depth=5)
        return kw, both, True, post
    if name == "503_retry":
        a.mode = "503"
        b.load.update(slots_occupied=7, queue_depth=5)
        return kw, both, True, post
    if name == "503_everywhere":
        a.mode = b.mode = "503"
        return {"retry_budget": 3}, both, False, post
    if name == "no_replica":
        a.ready = False
        return kw, [a.addr], True, post
    if name == "models":
        return kw, [a.addr], False, ("GET", "/v1/models", None)
    if name == "ready":
        return kw, both, True, ("GET", "/ready", None)
    if name == "health":
        return kw, [a.addr], False, ("GET", "/health", None)
    assert name == "not_found"
    return kw, [a.addr], False, ("GET", "/definitely-not-a-route", None)


def _close_all(*servers):
    """Close servers at once: each ``shutdown`` waits out its poll tick."""
    threads = [threading.Thread(target=x.close) for x in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _client_view(router_cls, name, addrs, kw, probe, method, path, body):
    r = router_cls(addrs, **kw)
    try:
        if probe:
            r.state.probe_once()
        code, raw, headers = jt.request(r.port, method, path, body,
                                        headers={"X-Request-Id": "req-compare-1"})
        if name == "ready":  # probe ages differ run to run
            info = json.loads(raw)
            raw = json.dumps({k: info[k] for k in ("status", "replicas_ready")}).encode()
        return code, raw, headers.get("X-Request-Id"), headers.get("Retry-After"), _counters(r.port)
    finally:
        _close_all(r)


@pytest.mark.parametrize("name", ["json", "sse", "429", "504", "503_retry", "503_everywhere",
                                  "no_replica", "models", "ready", "health", "not_found"])
def test_scenario_gives_the_jax_routers_client_view(name):
    a, b = jt.FakeReplica("a"), jt.FakeReplica("b")
    try:
        kw, addrs, probe, (method, path, body) = _setup(name, a, b)
        views = []
        for router_cls in (jt.RouterUnderTest, PortRouter):
            a.requests.clear(), b.requests.clear()
            views.append(_client_view(router_cls, name, addrs, kw, probe, method, path, body)
                         + ([len(a.requests), len(b.requests)],))
        assert views[1] == views[0]
    finally:
        _close_all(a, b)
