"""The port's fleet observability (the router's federation, hop attribution,
stitched trace spans and flight aggregation) and request forensics
(``dllama_tpu_torch.obsv.forensics``, the data behind ``cli explain``)
against the JAX package's.

* Every case of ``tests/test_fleet_obs.py`` runs again on the port's
  router and ``observability``, against the same ``ObsReplica`` fakes
  (``tests/torch_mirror.py`` rebinds the cases).
* ``load_trace_events``, ``load_flight_events``, ``build_waterfall``,
  ``render_waterfall`` and ``newest_trace_part`` give the JAX originals'
  outputs on the same files: the canned proxied request of
  ``tests/test_timeseries.py`` and hypothesis-made span and flight sets.
"""

import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_fleet_obs as jt
from dllama_tpu import faults as jfaults
from dllama_tpu.obsv import forensics as jfor
from dllama_tpu_torch import faults
from dllama_tpu_torch.obsv import forensics as tfor
from tests.test_timeseries import _canned_trace
from tests.torch_mirror import mirror

globals().update(mirror(jt))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _write_inputs(d, events, flight_docs):
    """Trace events as a line-per-event Chrome JSON Array (with a torn
    tail line and a non-dict line) in a directory of their own, and each
    flight document as its own file; returns (trace paths, flight paths)."""
    trace_dir = os.path.join(d, "trace")
    os.makedirs(trace_dir)
    half = len(events) // 2
    for name, part in (("trace.json", events[:half]), ("trace.json.replica-9991", events[half:])):
        with open(os.path.join(trace_dir, name), "w") as fh:
            fh.write("[\n" + "".join(json.dumps(e) + ",\n" for e in part) + '7,\n{"name": "torn')
    flights = []
    for i, doc in enumerate(flight_docs):
        flights.append(os.path.join(d, f"flight-{i}.json"))
        with open(flights[-1], "w") as fh:
            fh.write(doc if isinstance(doc, str) else json.dumps(doc))
    return [trace_dir, os.path.join(d, "missing.json")], flights


def _both(d, request_id, events, flight_docs):
    traces, flights = _write_inputs(d, events, flight_docs)
    out = []
    for mod in (jfor, tfor):
        tre, fle = mod.load_trace_events(traces), mod.load_flight_events(flights)
        wf = mod.build_waterfall(request_id, tre, fle)
        out.append((tre, fle, wf, [mod.render_waterfall(wf, width=w) for w in (1, 16, 48)]))
    return out


def test_canned_request_waterfall_matches_jax(tmp_path):
    rid, events = _canned_trace()
    flight = [
        {"router": {"process": "router", "events": [
            {"kind": "proxy_retry", "request_id": rid, "t_us": 2_000}]},
         "replicas": {"127.0.0.1:9991": {"process": "server", "events": [
             {"kind": "preempt", "request_id": rid, "t_us": 40_000, "row": 3}]}}},
        [{"kind": "admit", "request_id": rid, "t_us": 4_000}, "not an event"],
        {"process": "replica", "events": [{"kind": "resume", "request_id": rid, "t_us": 50}]},
        "not json at all"]
    jax_view, port_view = _both(str(tmp_path), rid, events, flight)
    assert port_view == jax_view
    assert port_view[2]["wall_ms"] == 100.0 and port_view[2]["phase_sum_ms"] == 90.0
    assert [e["kind"] for e in port_view[2]["events"]] == ["resume", "proxy_retry", "admit", "preempt"]


_span = st.fixed_dictionaries({
    "name": st.sampled_from(["request", "queue_wait", "prefill", "prefill_chunk", "decode",
                             "router_proxy", "connect", "stream", "other"]),
    "ph": st.sampled_from(["X", "X", "X", "i"]),
    "pid": st.sampled_from(["router", "replica", 11]), "tid": st.integers(1, 3),
    "ts": st.integers(0, 10**6), "dur": st.integers(0, 10**5),
    "args": st.fixed_dictionaries({}, optional={
        "request_id": st.sampled_from(["req-a", "req-b"]),
        "replica": st.sampled_from(["127.0.0.1:9990", "127.0.0.1:9991"]),
        "status": st.sampled_from([200, 503])})})
_mark = st.fixed_dictionaries(
    {"kind": st.sampled_from(["admit", "preempt", "resume", "migrate"]),
     "t_us": st.integers(0, 10**6)},
    optional={"request_id": st.sampled_from(["req-a", "req-b"]), "row": st.integers(0, 7)})


@settings(max_examples=40, deadline=None)
@given(st.lists(_span, max_size=14), st.lists(_mark, max_size=5), st.lists(_mark, max_size=3))
def test_any_request_waterfall_matches_jax(tmp_path_factory, events, ring, bare):
    d = str(tmp_path_factory.mktemp("wf"))
    flight = [{"process": "server", "events": ring}, bare]
    jax_view, port_view = _both(d, "req-a", events, flight)
    assert port_view == jax_view


def test_newest_trace_part_matches_jax(tmp_path):
    names = ["trace.json", "trace.json.replica-9990", "trace.json.replica-9991"]
    for i, name in enumerate(names):
        p = tmp_path / name
        p.write_text("[\n")
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    (tmp_path / "subdir").mkdir()
    for hint in (None, "9990", "9991", "9999"):
        assert (tfor.newest_trace_part(str(tmp_path), hint)
                == jfor.newest_trace_part(str(tmp_path), hint))
    assert tfor.newest_trace_part(str(tmp_path / "absent")) is None
    assert tfor.iter_trace_files([str(tmp_path), ""]) == jfor.iter_trace_files([str(tmp_path), ""])
