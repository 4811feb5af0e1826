"""KV page-stream wire codec for disaggregated prefill/decode serving.

A migrating row leaves a prefill replica as a :meth:`BatchSession.export_row
<dllama_tpu_torch.runtime.generate.BatchSession.export_row>` snapshot — page
payloads plus the carried decode state — and arrives at a decode replica as
the byte stream this module frames:

``MAGIC | u32 len | header JSON | u32 crc32`` followed by one
``u32 len | payload | u32 crc32`` frame per (arena leaf, page). The header
carries everything :meth:`admit_from_export` and the serving layer need
(geometry, sampler-chain state, budget accounting, the prompt tokens, and
an opaque ``extra`` dict for HTTP-level fields); the frames carry each
page's VALID token prefix only — the last, partially-filled page ships
short, and the decoder zero-fills the never-attended tail.

Three wire modes:

* ``f32`` — bit-exact: pages travel as raw float32 (a superset of the
  bf16/f32 arena dtypes), so a migrated row's stream is token-for-token
  the solo stream.
* ``q80`` — each page payload is flattened and block-quantized with the
  repo's Q80 codec (:mod:`dllama_tpu_torch.quants.blocks`: 32-element blocks,
  f16 delta + int8 quants — 34 bytes per 128) for ~3.76x fewer wire
  bytes. Lossy but error-bounded: :func:`q80_error_bound` derives the
  per-element bound from the same quant model, and the tolerance test
  gates the codec against it.
* ``q80+f32`` — hybrid: FULL pages ship q80, the partially-filled tail
  page ships bit-exact f32. The tail page is the only KV the very next
  decode steps attend to with fresh queries, so shipping it exact keeps
  greedy continuation bit-identical in practice at near-q80 wire cost
  (the full-page error bound still applies to the q80 frames). The
  frame split is derived from the header geometry on both sides —
  ``ntok == page_tokens`` means q80 — so no per-frame mode byte rides
  the wire.

Header versions: ``v=1`` is the original header; ``v=2`` adds the
optional ``stop_state`` field carrying a ``StopDetector``'s scanback
state (``{"stops": [...], "hold": "...", "stopped": false}``) so
stop-string sessions can migrate/resume. Decoders accept both; a v1
stream simply has ``stop_state=None``, and anything newer than v2 is
rejected with a reason (``TransferError``) rather than half-admitted.

Every length is read exactly and every frame CRC-checked; a short read or
checksum mismatch raises :class:`TransferError` — a torn stream can never
half-admit a row. Dependency-free beyond numpy (stdlib ``json``/``zlib``),
so the router can decode headers without jax."""

from __future__ import annotations

import io
import json
import zlib
from typing import Optional

import numpy as np

from ..quants.blocks import QK, dequantize_q80, quantize_q80
# wire-contract strings live in serving/protocol.py (PROTO-001 checks the
# encode/decode field sets against DKV1_HEADER_FIELDS there); the names
# below stay re-exported for existing importers
from .protocol import DKV1_MAGIC as MAGIC
from .protocol import DKV1_SCALARS as _SCALARS
from .protocol import KV_CONTENT_TYPE as CONTENT_TYPE
from .protocol import WIRE_MODES


class TransferError(RuntimeError):
    """A KV page stream that cannot be trusted: truncated mid-frame, CRC
    mismatch, bad magic, or a header that fails validation. The importer
    treats every one the same way — reject the whole transfer and let the
    caller fall back to re-prefilling; a torn stream never half-admits."""


def q80_error_bound(x: np.ndarray) -> float:
    """Max absolute per-element error the Q80 wire may introduce on ``x``,
    derived from the quant model itself: values quantize in 32-element
    blocks with ``delta = f16(absmax/127)``, round-half-even — so the
    reconstruction error is at most ``delta/2`` per block plus the f16
    rounding of delta (relative ``2**-11``) scaled by the +-127 quant
    range. Tests assert the actual round-trip error under this bound.

    Under the hybrid ``q80+f32`` wire this bound applies only to FULL
    pages — the partial tail page travels f32 and round-trips exactly
    (error 0), which is what keeps greedy continuation bit-identical."""
    flat = np.asarray(x, np.float32).reshape(-1)
    if flat.size == 0:
        return 0.0
    pad = (-flat.size) % QK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    absmax = np.abs(flat.reshape(-1, QK)).max(axis=1)
    delta = (absmax / 127.0).astype(np.float16).astype(np.float32)
    return float(delta.max() * (0.5 + 127.0 * 2.0 ** -11))


def _q80_encode(flat: np.ndarray) -> bytes:
    pad = (-flat.size) % QK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    return quantize_q80(flat).tobytes()


def _q80_decode(payload: bytes, n: int) -> np.ndarray:
    padded = n + (-n) % QK
    raw = np.frombuffer(payload, np.uint8)
    want = (padded // QK) * 34
    if raw.size != want:
        raise TransferError(
            f"q80 frame size {raw.size} != expected {want}")
    return dequantize_q80(raw, padded)[:n]


def _frame_is_f32(mode: str, ntok: int, page: int) -> bool:
    """Per-frame wire choice, derived identically on both sides: hybrid
    ships full pages q80 and the partial tail page bit-exact f32."""
    return mode == "f32" or (mode == "q80+f32" and ntok < page)


def encode_snapshot(snap: dict, prompt_tokens, mode: str = "f32",
                    extra: Optional[dict] = None,
                    stop_state: Optional[dict] = None) -> bytes:
    """Frame an ``export_row`` snapshot (plus the row's prompt and an
    opaque ``extra`` dict for the serving layer) into one byte stream.
    ``stop_state`` (a StopDetector's ``{"stops", "hold", "stopped"}``
    scanback state) bumps the header to v=2 so pre-v2 importers reject
    the stream with a reason instead of silently dropping the stops."""
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {mode!r} (know {WIRE_MODES})")
    leaves = snap["leaves"]
    page = int(snap["page_tokens"])
    nblk = int(snap["n_blocks"])
    # positions [0, pos) are written KV; the rest of the last page is
    # garbage the decode overwrites before attending — don't ship it
    tokens = max(0, min(int(snap["pos"]), nblk * page))
    header = {"v": 2 if stop_state is not None else 1,
              "mode": mode, "tokens": tokens,
              "prompt": [int(t) for t in prompt_tokens],
              "keys": [int(k) for k in snap["keys"]],
              "temp": float(snap["temp"]), "topp": float(snap["topp"]),
              "stop_tokens": [int(t) for t in snap["stop_tokens"]],
              "n_leaves": len(leaves),
              # per-leaf block shape [L, page, kv, hd] (leaves arrive as
              # [L, n_blocks, page, kv, hd]; the page axis is reframed)
              "leaf_shapes": [[int(lf.shape[0])] + list(lf.shape[2:])
                              for lf in leaves],
              "extra": extra or {}}
    if stop_state is not None:
        header["stop_state"] = {
            "stops": [str(s) for s in stop_state.get("stops", [])],
            "hold": str(stop_state.get("hold", "")),
            "stopped": bool(stop_state.get("stopped", False))}
    for k in _SCALARS:
        header[k] = int(snap[k])
    hdr = json.dumps(header, separators=(",", ":")).encode()
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(len(hdr).to_bytes(4, "big"))
    out.write(hdr)
    out.write(zlib.crc32(hdr).to_bytes(4, "big"))
    for leaf in leaves:
        lf = np.asarray(leaf, np.float32)  # exact for bf16/f32 arenas
        for b in range(nblk):
            ntok = max(0, min(tokens - b * page, page))
            x = np.ascontiguousarray(lf[:, b, :ntok])
            flat = x.reshape(-1)
            payload = (flat.tobytes() if _frame_is_f32(mode, ntok, page)
                       else _q80_encode(flat))
            out.write(len(payload).to_bytes(4, "big"))
            out.write(payload)
            out.write(zlib.crc32(payload).to_bytes(4, "big"))
    return out.getvalue()


def _read_exact(rd, n: int, what: str) -> bytes:
    buf = rd.read(n)
    if buf is None or len(buf) != n:
        raise TransferError(
            f"torn stream: short read of {what} "
            f"({0 if buf is None else len(buf)}/{n} bytes)")
    return buf


def decode_snapshot(data) -> dict:
    """Parse a framed page stream back into an ``admit_from_export``-shaped
    snapshot (leaves float32, zero-filled past each page's valid tokens)
    with ``prompt``, ``mode`` and ``extra`` attached. ``data`` is a bytes
    object or a binary file-like. Raises :class:`TransferError` on any
    truncation, CRC mismatch, or malformed header."""
    rd = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    if _read_exact(rd, len(MAGIC), "magic") != MAGIC:
        raise TransferError("bad magic: not a KV page stream")
    hlen = int.from_bytes(_read_exact(rd, 4, "header length"), "big")
    if hlen <= 0 or hlen > 1 << 24:
        raise TransferError(f"implausible header length {hlen}")
    hdr = _read_exact(rd, hlen, "header")
    crc = int.from_bytes(_read_exact(rd, 4, "header crc"), "big")
    if zlib.crc32(hdr) != crc:
        raise TransferError("header crc mismatch")
    try:
        header = json.loads(hdr.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransferError(f"unparseable header: {e}") from None
    mode = header.get("mode")
    if header.get("v") not in (1, 2) or mode not in WIRE_MODES:
        raise TransferError(
            f"unsupported stream (v={header.get('v')!r}, mode={mode!r})")
    stop_state = header.get("stop_state")
    if stop_state is not None:
        if (not isinstance(stop_state, dict)
                or not isinstance(stop_state.get("stops"), list)):
            raise TransferError("malformed stop_state in v2 header")
        stop_state = {"stops": [str(s) for s in stop_state["stops"]],
                      "hold": str(stop_state.get("hold", "")),
                      "stopped": bool(stop_state.get("stopped", False))}
    try:
        page = int(header["page_tokens"])
        nblk = int(header["n_blocks"])
        tokens = int(header["tokens"])
        n_leaves = int(header["n_leaves"])
        shapes = [tuple(int(d) for d in s) for s in header["leaf_shapes"]]
        prompt = [int(t) for t in header["prompt"]]
    except (KeyError, TypeError, ValueError) as e:
        raise TransferError(f"malformed header: {e}") from None
    if (page < 1 or nblk < 0 or n_leaves != len(shapes)
            or len(prompt) != int(header["plen"])):
        raise TransferError("inconsistent header geometry")
    leaves = []
    for shape in shapes:
        # block shape [L, page, kv, hd]; the wire frames ship each page's
        # valid token prefix [L, ntok, kv, hd]
        if len(shape) != 4 or shape[1] != page:
            raise TransferError(f"bad leaf block shape {shape}")
        L, _, kv, hd = shape
        lf = np.zeros((L, nblk, page, kv, hd), np.float32)
        for b in range(nblk):
            ntok = max(0, min(tokens - b * page, page))
            n = L * ntok * kv * hd
            payload_len = int.from_bytes(
                _read_exact(rd, 4, "frame length"), "big")
            payload = _read_exact(rd, payload_len, "frame payload")
            fcrc = int.from_bytes(_read_exact(rd, 4, "frame crc"), "big")
            if zlib.crc32(payload) != fcrc:
                raise TransferError(f"frame crc mismatch at block {b}")
            if _frame_is_f32(mode, ntok, page):
                if payload_len != 4 * n:
                    raise TransferError(
                        f"f32 frame size {payload_len} != {4 * n}")
                flat = np.frombuffer(payload, np.float32).copy()
            else:
                flat = _q80_decode(payload, n)
            if ntok:
                lf[:, b, :ntok] = flat.reshape(L, ntok, kv, hd)
        leaves.append(lf)
    snap = {k: int(header[k]) for k in _SCALARS}
    snap["keys"] = [int(k) for k in header["keys"]]
    snap["temp"] = float(header["temp"])
    snap["topp"] = float(header["topp"])
    snap["stop_tokens"] = [int(t) for t in header["stop_tokens"]]
    snap["leaves"] = leaves
    snap["prompt"] = prompt
    snap["mode"] = mode
    snap["extra"] = header.get("extra") or {}
    snap["stop_state"] = stop_state  # None for v1 streams
    return snap
