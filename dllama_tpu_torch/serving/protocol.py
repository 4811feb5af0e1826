"""Shared wire-contract constants for the dllama fleet.

Every string that crosses a process boundary — hop headers, SSE event
names, DKV1 snapshot header fields, the KV content type — lives HERE
and only here.  Writers and readers both import from this module, so a
one-sided rename is an ImportError / NameError instead of a silent
fleet-wide desync.  dllama-check's PROTO-00x passes enforce the rest:

* PROTO-001 — DKV1 fields written by ``encode_snapshot`` vs parsed by
  ``decode_snapshot`` vs the ``DKV1_HEADER_FIELDS`` registry below.
* PROTO-002 — SSE event names emitted vs scanned; raw event literals
  outside this module are findings.
* PROTO-003 — hop header strings minted vs read; raw ``X-Dllama-*`` /
  ``X-Request-Id`` literals outside this module are findings.
* PROTO-004 — metric names consumed somewhere in the package must be
  registered via ``counter()``/``gauge()``/``histogram()``; and
  ``cli.py`` (the `top`/`explain`/`snapshot` consumers, which scrape the
  wire rather than share a registry) may not spell a raw ``dllama_*``
  literal at all — it imports the ``MET_*`` constants below, so the
  dashboards can never silently desync from the registry.

Keep every value a plain string literal (the analyzer reads this file
with ``ast``, it never imports it).  Derive bytes at the use site with
``.encode()``.
"""

# --------------------------------------------------------------------------
# Hop headers (router <-> replica <-> client).
# --------------------------------------------------------------------------

HDR_REQUEST_ID = "X-Request-Id"
HDR_PARENT_SPAN = "X-Dllama-Parent-Span"
HDR_CKPT = "X-Dllama-Ckpt"
HDR_CKPT_WIRE = "X-Dllama-Ckpt-Wire"
HDR_CLASS = "X-Dllama-Class"
HDR_RESUME_OFFSET = "X-Dllama-Resume-Offset"
HDR_SERVER_TIMING = "Server-Timing"

#: Every header the fleet mints or reads on a hop.  PROTO-003 checks this
#: tuple against the HDR_* constants above and against actual use.
HOP_HEADERS = (
    HDR_REQUEST_ID,
    HDR_PARENT_SPAN,
    HDR_CKPT,
    HDR_CKPT_WIRE,
    HDR_CLASS,
    HDR_RESUME_OFFSET,
    HDR_SERVER_TIMING,
)

# --------------------------------------------------------------------------
# SSE control frames (in-band on /v1/completions streams).
# --------------------------------------------------------------------------

SSE_EVENT_CKPT = "dllama-ckpt"

#: Every named SSE event the fleet emits or scans for.  PROTO-002 checks
#: each one has both an emitter and a scanner module.
SSE_EVENTS = (
    SSE_EVENT_CKPT,
)

# --------------------------------------------------------------------------
# DKV1 snapshot codec (serving/kv_transfer.py).
# --------------------------------------------------------------------------

DKV1_MAGIC = b"DKV1"
KV_CONTENT_TYPE = "application/x-dllama-kv"
WIRE_MODES = ("f32", "q80", "q80+f32")

#: Scalar header fields written/parsed in one loop on both sides.
DKV1_SCALARS = (
    "page_tokens",
    "n_blocks",
    "plen",
    "pos",
    "token",
    "room",
    "budget",
    "offered",
    "emitted",
)

#: Structural fields always present in a DKV1 JSON header.
DKV1_BASE_FIELDS = (
    "v",
    "mode",
    "tokens",
    "prompt",
    "keys",
    "temp",
    "topp",
    "stop_tokens",
    "n_leaves",
    "leaf_shapes",
    "extra",
)

#: Fields the encoder writes conditionally; the decoder must still parse
#: them (with a default) or resumed sessions silently lose state.
DKV1_OPTIONAL_FIELDS = (
    "stop_state",
)

#: The full header contract.  PROTO-001 checks encode/decode against it.
DKV1_HEADER_FIELDS = DKV1_BASE_FIELDS + DKV1_SCALARS + DKV1_OPTIONAL_FIELDS

# --------------------------------------------------------------------------
# Metric families read across a process boundary (cli top / explain /
# snapshot scrape them off /metrics, /metrics/fleet and /metrics/history —
# they never share a registry with the process that registered them).
# --------------------------------------------------------------------------

MET_HTTP_REQUESTS = "dllama_http_requests_total"
MET_TTFT_MS = "dllama_ttft_ms"
MET_TPOT_MS = "dllama_tpot_ms"
MET_KV_TRANSFER_BYTES = "dllama_kv_transfer_bytes_total"
MET_CLASS_TTFT_MS = "dllama_class_ttft_ms"
MET_CLASS_TPOT_MS = "dllama_class_tpot_ms"
MET_CLASS_QUEUE_DEPTH = "dllama_class_queue_depth"
MET_CLASS_RESIDENT_ROWS = "dllama_class_resident_rows"
MET_TS_SAMPLES = "dllama_ts_samples_total"
MET_ALERTS = "dllama_alerts_total"
MET_FEDERATE_SKIPPED = "dllama_router_federate_skipped_total"
MET_FLEET_REPLICAS = "dllama_fleet_replicas"
MET_SCALE_EVENTS = "dllama_fleet_scale_events_total"
MET_POLICY_EVALS = "dllama_fleet_policy_evals_total"
MET_CKPT_EXPIRED = "dllama_router_ckpt_expired_total"
MET_TP_REDUCE_CHUNKS = "dllama_tp_reduce_chunks_total"

#: Label names of the ``dllama_tp_wire_info`` info-gauge (value 1, identity
#: in the labels): the resolved gather wire, overlap mode, and row-parallel
#: reduce mode.  The server registers with exactly these labels and
#: BENCH_REDUCE / fleet dashboards read them back off /metrics, so the
#: tuple lives here with the other cross-process names.
TP_WIRE_INFO_LABELS = ("tp_wire", "tp_overlap", "tp_reduce")

#: Every family a cross-process consumer reads.  PROTO-004's cli.py pass
#: checks this tuple stays registered AND that cli.py spells no family
#: outside it.
WIRE_METRICS = (
    MET_HTTP_REQUESTS,
    MET_TTFT_MS,
    MET_TPOT_MS,
    MET_KV_TRANSFER_BYTES,
    MET_CLASS_TTFT_MS,
    MET_CLASS_TPOT_MS,
    MET_CLASS_QUEUE_DEPTH,
    MET_CLASS_RESIDENT_ROWS,
    MET_TS_SAMPLES,
    MET_ALERTS,
    MET_FEDERATE_SKIPPED,
    MET_FLEET_REPLICAS,
    MET_SCALE_EVENTS,
    MET_POLICY_EVALS,
    MET_CKPT_EXPIRED,
    MET_TP_REDUCE_CHUNKS,
)
