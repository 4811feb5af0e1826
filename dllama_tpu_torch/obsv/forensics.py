"""Per-request latency forensics: join the artifacts into one waterfall.

``cli explain <request-id>`` answers "why was this request slow" from
evidence the fleet already emits — nothing new is recorded for it:

* the replica's trace spans (``request`` / ``queue_wait`` / ``prefill`` /
  ``prefill_chunk`` / ``decode``, one track per request),
* the router's hop spans (``router_proxy`` / ``connect`` / ``stream``,
  carrying the replica's Server-Timing attribution in the hop
  histograms), and
* flight-recorder events naming the request (admission, preemption,
  resume, migration, 5xx) inlined as point markers.

Trace input is the line-per-event Chrome JSON Array files DLLAMA_TRACE
writes (solo files, per-process part files, or the stitched fleet merge —
the parser accepts any of them); flight input is ``/debug/flight``
snapshots or the on-disk ``$DLLAMA_FLIGHT`` dump JSONs.

The port's copy of the JAX package's module: stdlib-only, no torch, no
jax.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

#: replica child-phase span names, in waterfall order
_PHASES = ("queue_wait", "prefill", "prefill_chunk", "decode")
#: router-side span names (a hop per router process that proxied the id)
_ROUTER_SPANS = ("router_proxy", "connect", "stream")


def iter_trace_files(paths) -> List[str]:
    """Expand files/directories into trace-file paths (dirs: every
    ``*.json``/``*.trace``/part file inside, non-recursive)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                fp = os.path.join(p, name)
                if os.path.isfile(fp):
                    out.append(fp)
        elif p:
            out.append(p)
    return out


def load_trace_events(paths) -> List[dict]:
    """Parse line-per-event Chrome JSON Array files (torn lines skipped)."""
    events = []
    for path in iter_trace_files(paths):
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError:
            continue  # a part file rotated/merged away between listdir
            #           and open: forensics reads what still exists
        with fh:
            for line in fh:
                line = line.strip().rstrip(",")
                if not line or line in ("[", "]"):
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue  # a torn tail line (process died mid-append)
                    #           is expected in crash forensics: skip it
                if isinstance(e, dict):
                    events.append(e)
    return events


def load_flight_events(paths) -> List[dict]:
    """Flight events from ``/debug/flight`` snapshots / on-disk dumps.

    Accepts the plain ring snapshot, the router's aggregate
    ``{"router": snap, "replicas": {name: snap}}`` report, or a bare
    event list; each event gains a ``process`` field from its ring."""
    events = []

    def _take(snap, fallback: str) -> None:
        if not isinstance(snap, dict):
            return
        proc = snap.get("process") or fallback
        for e in snap.get("events") or []:
            if isinstance(e, dict):
                e = dict(e)
                e.setdefault("process", proc)
                events.append(e)

    for path in iter_trace_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue  # an unreadable/non-JSON input is not flight data;
            #           the join proceeds on whatever evidence parses
        if isinstance(doc, list):
            events.extend(e for e in doc if isinstance(e, dict))
            continue
        if not isinstance(doc, dict):
            continue
        _take(doc, os.path.basename(path))
        _take(doc.get("router"), "router")
        for name, snap in (doc.get("replicas") or {}).items():
            _take(snap, str(name))
    return events


def build_waterfall(request_id: str, trace_events: List[dict],
                    flight_events: List[dict]) -> dict:
    """Join trace spans + flight events for one request id.

    Returns ``{request_id, wall_ms, phase_sum_ms, t0_us, rows, events,
    hops}`` — ``rows`` is the waterfall (sorted by start), ``phase_sum_ms``
    sums the replica's non-overlapping child phases (queue_wait + prefill
    pieces + decode), the number the acceptance gate compares against
    ``wall_ms``; ``events`` are the request's flight markers."""
    # request tracks: (pid, tid) of every "request" span carrying the id
    req_spans = [e for e in trace_events
                 if e.get("name") == "request" and e.get("ph") == "X"
                 and (e.get("args") or {}).get("request_id") == request_id]
    router_spans = [e for e in trace_events
                    if e.get("name") == "router_proxy"
                    and (e.get("args") or {}).get("request_id") == request_id]
    tracks = {(e.get("pid"), e.get("tid")) for e in req_spans}
    router_tracks = {(e.get("pid"), e.get("tid")) for e in router_spans}

    rows: List[dict] = []

    def row(e: dict, source: str) -> dict:
        return {"phase": e.get("name"), "source": source,
                "start_us": int(e.get("ts", 0)),
                "dur_ms": round(e.get("dur", 0) / 1e3, 3),
                "args": e.get("args") or {}}

    for e in trace_events:
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        if key in router_tracks and e.get("name") in _ROUTER_SPANS:
            rows.append(row(e, "router"))
        elif key in tracks and e.get("name") in ("request",) + _PHASES:
            rows.append(row(e, "replica"))
    rows.sort(key=lambda r: (r["start_us"], -r["dur_ms"]))

    # the outermost span anchors wall time: the router hop when the id went
    # through a front door, else the replica's own request span
    anchor = (max(router_spans, key=lambda e: e.get("dur", 0))
              if router_spans else
              max(req_spans, key=lambda e: e.get("dur", 0))
              if req_spans else None)
    wall_ms = round(anchor.get("dur", 0) / 1e3, 3) if anchor else 0.0
    t0_us = int(anchor.get("ts", 0)) if anchor else 0
    phase_sum_ms = round(sum(
        r["dur_ms"] for r in rows
        if r["source"] == "replica" and r["phase"] != "request"), 3)

    marks = [e for e in flight_events
             if e.get("request_id") == request_id]
    marks.sort(key=lambda e: e.get("t_us", 0))
    return {"request_id": request_id, "wall_ms": wall_ms,
            "phase_sum_ms": phase_sum_ms, "t0_us": t0_us,
            "hops": [{"replica": (e.get("args") or {}).get("replica"),
                      "status": (e.get("args") or {}).get("status"),
                      "dur_ms": round(e.get("dur", 0) / 1e3, 3)}
                     for e in router_spans],
            "rows": rows, "events": marks}


def render_waterfall(wf: dict, width: int = 48) -> str:
    """The human view: one bar-chart line per span, flight marks inline."""
    out = [f"request {wf['request_id']}  wall {wf['wall_ms']:.1f}ms  "
           f"phase sum {wf['phase_sum_ms']:.1f}ms"]
    if not wf["rows"]:
        return "\n".join(out + ["  (no trace spans found for this id)"])
    t0 = wf["t0_us"]
    span_us = max(1, max(int(r["start_us"] - t0 + r["dur_ms"] * 1e3)
                         for r in wf["rows"]))
    lines: List[tuple] = [(r["start_us"], (
        f"  {r['source'][:7]:<8}{r['phase']:<14}"
        f"{_bar(r['start_us'] - t0, r['dur_ms'] * 1e3, span_us, width)}"
        f" {r['dur_ms']:>9.1f}ms")) for r in wf["rows"]]
    for e in wf["events"]:
        t_us = e.get("t_us", t0)
        lines.append((t_us, (
            f"  flight  {e.get('kind', '?'):<14}"
            f"{_mark(t_us - t0, span_us, width)} "
            f"@{max(0, (t_us - t0)) / 1e3:>8.1f}ms"
            + _fields(e))))
    lines.sort(key=lambda kv: kv[0])
    out.extend(s for _, s in lines)
    return "\n".join(out)


def _bar(off_us: float, dur_us: float, span_us: int, width: int) -> str:
    a = int(max(0.0, off_us) / span_us * width)
    b = int(max(0.0, off_us + dur_us) / span_us * width)
    b = min(width, max(b, a + 1))
    return "|" + " " * a + "▇" * (b - a) + " " * (width - b) + "|"


def _mark(off_us: float, span_us: int, width: int) -> str:
    a = min(width - 1, int(max(0.0, off_us) / span_us * width))
    return "|" + " " * a + "●" + " " * (width - a - 1) + "|"


def _fields(e: dict) -> str:
    skip = {"kind", "t_us", "seq", "request_id", "process"}
    kept = {k: v for k, v in e.items() if k not in skip}
    return f"  {kept}" if kept else ""


def newest_trace_part(trace_dir: str,
                      hint: Optional[str] = None) -> Optional[str]:
    """The most recently modified trace file in ``trace_dir`` (filtered to
    names containing ``hint`` when one matches anything) — the "newest
    trace part per replica" a support snapshot bundles."""
    try:
        names = os.listdir(trace_dir)
    except OSError:
        return None
    paths = [os.path.join(trace_dir, n) for n in names]
    paths = [p for p in paths if os.path.isfile(p)]
    if hint:
        hinted = [p for p in paths if hint in os.path.basename(p)]
        paths = hinted or paths
    if not paths:
        return None
    return max(paths, key=lambda p: os.path.getmtime(p))
