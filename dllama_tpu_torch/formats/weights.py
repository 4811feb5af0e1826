"""`.m` weight-file reader/writer.

The tensor order mirrors the reference root loader exactly
(`distributed-llama/src/transformer.cpp:630-690`):

```
token_embedding [vocab, dim]            f32 (always)
repeat n_layers:
    wq   [dim,    dim]     wft          # RowMatmulSlice(dim -> dim)
    wk   [kv_dim, dim]     wft
    wv   [kv_dim, dim]     wft
    wo   [dim,    dim]     wft          # ColMatmulSlice
    if moe:
        moe_router [n_experts, dim] wft
        repeat n_experts:
            moe_up   [hidden, dim] wft
            moe_gate [hidden, dim] wft
            moe_down [dim, hidden] wft
    else:
        w1 [hidden, dim]   wft
        w2 [dim, hidden]   wft
        w3 [hidden, dim]   wft
    rms_att [dim] f32
    rms_ffn [dim] f32
    if grok1:
        rms_moe  [dim] f32
        rms_ffn2 [dim] f32
rms_final [dim] f32
wcls [vocab, dim] wft
```

All 2-D tensors are row-major ``[out_features, in_features]`` (the reference matmul
computes ``y[d] = sum_n w[d,n] * x[n]``, `distributed-llama/src/funcs.cpp:157-197`).

Reading is mmap-backed and lazy so a 70B file never materializes twice in host RAM;
callers can also restrict to a shard's row range (tensor-parallel loading) via the
``rows`` argument of :func:`read_tensor_rows`.

**Integrity section.** :class:`ModelWriter` appends (by default) a trailing
section after the last tensor::

    b"DLCK" | u32 version=1 | u32 n_tensors | u64 payload_size
            | u32 crc32 per tensor (plan order) | u32 crc32 of the section itself

The reference loader reads tensors sequentially by offset and never checks the
file size, so checksummed files stay loadable there; readers that predate the
section simply see trailing bytes. This reader validates sizes/offsets at open
(truncation is caught before any mmap read, naming the first cut tensor) and
CRC-checks each tensor lazily on first read (disable with
``DLLAMA_WEIGHTS_VERIFY=0``). :meth:`WeightFileReader.verify` checks the whole
file — that is what ``python -m dllama_tpu_torch.cli verify`` drives.

**Row-band section (sharded verify).** After the DLCK section the writer
appends a second trailing section::

    b"DLRB" | u32 version=1 | u32 n_tensors | u32 band_rows
            | per tensor (plan order): u32 n_bands | u32 crc32 per band
            | u32 crc32 of the section itself

Each band covers ``band_rows`` consecutive tensor rows (the unit
``read_tensor_rows`` loads for a tensor-parallel shard), so a host can
CRC-check ONLY the rows it actually maps: the lazy first-read check of a row
band touches just the overlapping bands, and ``cli verify --shard I/N``
checks one host's stripe of every tensor instead of the whole file. Files
without the section fall back to whole-tensor verification; files without
either section are validated by open-time size/offset arithmetic only.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
import zlib
from typing import Iterator

import numpy as np

from dllama_tpu_torch import faults, observability
from dllama_tpu_torch.formats.spec import (
    MAX_HEADER_SIZE,
    ArchType,
    FormatError,
    ModelSpec,
    parse_header,
    write_header,
)
from dllama_tpu_torch.quants import blocks

INTEGRITY_TAG = b"DLCK"
INTEGRITY_VERSION = 1
_SEC_FIXED = struct.calcsize("<4sIIQ")  # tag + version + n_tensors + payload_size

ROW_BAND_TAG = b"DLRB"
ROW_BAND_VERSION = 1
#: rows per verification band: small enough that a 1/N shard of a big matmul
#: tensor skips most of the file's bytes, large enough that the CRC table
#: stays a rounding error next to the payload
DEFAULT_ROW_BAND = 64
_RB_FIXED = struct.calcsize("<4sIII")  # tag + version + n_tensors + band_rows

_REG = observability.default_registry()
_M_CRC_FAIL = _REG.counter(
    "dllama_weights_checksum_failures_total",
    "Tensors whose bytes failed the recorded CRC32 (lazy read or verify)")
_M_OPEN_FAIL = _REG.counter(
    "dllama_weights_open_failures_total",
    "Weight files rejected at open (empty/truncated/hostile header)")
_M_VERIFIED = _REG.counter(
    "dllama_weights_tensors_verified_total",
    "Tensors that passed their CRC32 check")


class ChecksumError(FormatError):
    """A tensor's bytes do not match the CRC recorded at write time."""

    def __init__(self, path: str, name: str, offset: int, expected: int, actual: int):
        super().__init__(
            f"checksum mismatch in {path}: tensor {name!r} at byte offset {offset} "
            f"(crc32 {actual:#010x}, recorded {expected:#010x}) — file is corrupt")
        self.tensor_name = name
        self.offset = offset


def build_integrity_section(crcs: list[int], payload_size: int) -> bytes:
    """Serialize the trailing integrity section (self-checksummed)."""
    sec = struct.pack(f"<4sIIQ{len(crcs)}I", INTEGRITY_TAG, INTEGRITY_VERSION,
                      len(crcs), payload_size, *crcs)
    return sec + struct.pack("<I", zlib.crc32(sec))


def parse_integrity_section(extra: bytes, n_tensors: int, payload_size: int) -> list[int]:
    """Parse + validate trailing bytes as an integrity section, returning the
    per-tensor CRC table. Raises FormatError on any inconsistency."""
    if len(extra) < _SEC_FIXED + 4 or bytes(extra[:4]) != INTEGRITY_TAG:
        raise FormatError(
            f"{len(extra)} trailing bytes after the last tensor are not an "
            f"integrity section (expected {INTEGRITY_TAG!r} tag)")
    _, version, n, payload = struct.unpack_from("<4sIIQ", extra, 0)
    if version != INTEGRITY_VERSION:
        raise FormatError(f"unsupported integrity section version {version}")
    if n != n_tensors:
        raise FormatError(
            f"integrity section covers {n} tensors, plan has {n_tensors}")
    if payload != payload_size:
        raise FormatError(
            f"integrity section records payload of {payload} bytes, "
            f"tensor plan ends at {payload_size}")
    if len(extra) != _SEC_FIXED + 4 * n + 4:
        raise FormatError(
            f"integrity section is {len(extra)} bytes, want {_SEC_FIXED + 4 * n + 4}")
    (self_crc,) = struct.unpack_from("<I", extra, _SEC_FIXED + 4 * n)
    if zlib.crc32(bytes(extra[: _SEC_FIXED + 4 * n])) != self_crc:
        raise FormatError("integrity section fails its own checksum")
    return list(struct.unpack_from(f"<{n}I", extra, _SEC_FIXED))


def build_row_band_section(band_crcs: list[list[int]], band_rows: int) -> bytes:
    """Serialize the DLRB row-band CRC section (self-checksummed)."""
    parts = [struct.pack("<4sIII", ROW_BAND_TAG, ROW_BAND_VERSION,
                         len(band_crcs), band_rows)]
    for crcs in band_crcs:
        parts.append(struct.pack(f"<I{len(crcs)}I", len(crcs), *crcs))
    sec = b"".join(parts)
    return sec + struct.pack("<I", zlib.crc32(sec))


def parse_row_band_section(extra: bytes,
                           dims: list[int]) -> tuple[int, list[list[int]]]:
    """Parse + validate the bytes after the DLCK section as a DLRB row-band
    table, returning ``(band_rows, per-tensor band CRC lists)``. Band counts
    are cross-checked against the plan's row dims (``dims``) so a hostile
    table can never index out of a tensor."""
    if len(extra) < _RB_FIXED + 4 or bytes(extra[:4]) != ROW_BAND_TAG:
        raise FormatError(
            f"{len(extra)} trailing bytes after the integrity section are "
            f"not a row-band section (expected {ROW_BAND_TAG!r} tag)")
    _, version, n, band_rows = struct.unpack_from("<4sIII", extra, 0)
    if version != ROW_BAND_VERSION:
        raise FormatError(f"unsupported row-band section version {version}")
    if n != len(dims):
        raise FormatError(
            f"row-band section covers {n} tensors, plan has {len(dims)}")
    if band_rows < 1:
        raise FormatError(f"row-band section has band_rows={band_rows}")
    off = _RB_FIXED
    tables: list[list[int]] = []
    for d in dims:
        want = (d + band_rows - 1) // band_rows
        if off + 4 * (want + 1) > len(extra):
            raise FormatError("row-band integrity section truncated mid-table")
        (nb,) = struct.unpack_from("<I", extra, off)
        if nb != want:
            raise FormatError(
                f"row-band table {len(tables)} has {nb} bands, "
                f"{d} rows at {band_rows}/band want {want}")
        tables.append(list(struct.unpack_from(f"<{nb}I", extra, off + 4)))
        off += 4 * (nb + 1)
    if len(extra) != off + 4:
        raise FormatError(
            f"row-band integrity section is {len(extra)} bytes, want {off + 4}")
    (self_crc,) = struct.unpack_from("<I", extra, off)
    if zlib.crc32(bytes(extra[:off])) != self_crc:
        raise FormatError("row-band section fails its own checksum")
    return band_rows, tables


@dataclasses.dataclass(frozen=True)
class TensorEntry:
    name: str
    d: int  # rows (output features); 1 for 1-D tensors
    n: int  # row length (input features)
    float_type: int
    offset: int  # absolute byte offset in file

    @property
    def nbytes(self) -> int:
        return blocks.batch_bytes(self.float_type, self.n, self.d)

    @property
    def shape(self) -> tuple:
        return (self.d, self.n) if self.d > 1 else (self.n,)


def tensor_plan(spec: ModelSpec) -> list[TensorEntry]:
    """Ordered tensor table with absolute file offsets."""
    wft = spec.weights_float_type
    entries: list[TensorEntry] = []
    offset = spec.header_size if spec.header_size else 0

    def add(name: str, d: int, n: int, ft: int) -> None:
        nonlocal offset
        e = TensorEntry(name, d, n, ft, offset)
        entries.append(e)
        offset += e.nbytes

    add("token_embedding", spec.vocab_size, spec.dim, blocks.F32)
    for i in range(spec.n_layers):
        p = f"layers.{i}."
        add(p + "wq", spec.dim, spec.dim, wft)
        add(p + "wk", spec.kv_dim, spec.dim, wft)
        add(p + "wv", spec.kv_dim, spec.dim, wft)
        add(p + "wo", spec.dim, spec.dim, wft)
        if spec.is_moe:
            add(p + "moe_router", spec.n_experts, spec.dim, wft)
            for e in range(spec.n_experts):
                add(p + f"experts.{e}.up", spec.hidden_dim, spec.dim, wft)
                add(p + f"experts.{e}.gate", spec.hidden_dim, spec.dim, wft)
                add(p + f"experts.{e}.down", spec.dim, spec.hidden_dim, wft)
        else:
            add(p + "w1", spec.hidden_dim, spec.dim, wft)
            add(p + "w2", spec.dim, spec.hidden_dim, wft)
            add(p + "w3", spec.hidden_dim, spec.dim, wft)
        add(p + "rms_att", 1, spec.dim, blocks.F32)
        add(p + "rms_ffn", 1, spec.dim, blocks.F32)
        if spec.arch == ArchType.GROK1:
            add(p + "rms_moe", 1, spec.dim, blocks.F32)
            add(p + "rms_ffn2", 1, spec.dim, blocks.F32)
    add("rms_final", 1, spec.dim, blocks.F32)
    add("wcls", spec.vocab_size, spec.dim, wft)
    return entries


class WeightFileReader:
    """mmap-backed reader for `.m` files with strict open-time validation and
    lazy per-tensor CRC verification (when the file carries an integrity
    section)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        try:
            try:
                self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:
                _M_OPEN_FAIL.inc()
                raise FormatError(f"empty weight file: {path}") from None
        except BaseException:
            self._file.close()
            raise
        try:
            self._buf = np.frombuffer(self._mm, dtype=np.uint8)
            fv = faults.fire("weights_open")
            if fv is not None and fv["action"] == "truncate":
                self._buf = self._buf[: max(0, len(self._buf) - max(1, fv["drop"]))]
            # a bytes COPY of the header region: if parse_header raises, its
            # traceback (held by the caller) must not pin a view of the mmap
            # and turn the cleanup close() into a BufferError
            self.spec = parse_header(bytes(self._buf[:MAX_HEADER_SIZE]),
                                     file_size=len(self._buf))
            self.entries = tensor_plan(self.spec)
            end = self.entries[-1].offset + self.entries[-1].nbytes
            if end > len(self._buf):
                bad = next(e for e in self.entries
                           if e.offset + e.nbytes > len(self._buf))
                raise FormatError(
                    f"truncated model file {path}: {len(self._buf)} bytes on disk "
                    f"but tensor {bad.name!r} spans bytes "
                    f"[{bad.offset}, {bad.offset + bad.nbytes}) — file ends "
                    f"{end - len(self._buf)} bytes early")
            self.tensor_crcs: list[int] | None = None
            self.band_crcs: list[list[int]] | None = None
            self.band_rows = 0
            if end < len(self._buf):
                extra = self._buf[end:].tobytes()
                # the DLCK section's length is fixed by the plan; anything
                # after it must be the DLRB row-band table
                dlck = _SEC_FIXED + 4 * len(self.entries) + 4
                self.tensor_crcs = parse_integrity_section(
                    extra[:dlck], len(self.entries), end)
                if len(extra) > dlck:
                    self.band_rows, self.band_crcs = parse_row_band_section(
                        extra[dlck:], [e.d for e in self.entries])
            self._by_name = {e.name: e for e in self.entries}
            self._index = {e.name: i for i, e in enumerate(self.entries)}
            self._verified: set = set()
            self._verified_bands: dict = {}  # name -> set of checked bands
            self._lazy_verify = (
                self.tensor_crcs is not None
                and os.environ.get("DLLAMA_WEIGHTS_VERIFY", "1") != "0")
        except BaseException as e:
            if isinstance(e, FormatError):
                _M_OPEN_FAIL.inc()
            self.close()
            raise

    @property
    def has_integrity(self) -> bool:
        return self.tensor_crcs is not None

    def close(self) -> None:
        self._buf = None  # release the exported mmap buffer before closing it
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def entry(self, name: str) -> TensorEntry:
        return self._by_name[name]

    def _raw_view(self, e: TensorEntry) -> np.ndarray:
        """The tensor's file bytes, with the ``weights_read:bitflip`` fault
        seam applied (on a copy) so corruption drills exercise detection."""
        raw = self._buf[e.offset : e.offset + e.nbytes]
        fv = faults.fire("weights_read")
        if fv is not None and fv["action"] == "bitflip":
            raw = raw.copy()
            raw[min(max(0, fv["byte"]), e.nbytes - 1)] ^= 1
        return raw

    def _checked_raw(self, e: TensorEntry) -> np.ndarray:
        """Raw bytes after the lazy first-read CRC check (whole tensor, even
        when the caller only wants a row band — integrity beats shard
        locality, and it is a read+crc32 with no dequantization)."""
        raw = self._raw_view(e)
        if self._lazy_verify and e.name not in self._verified:
            expected = self.tensor_crcs[self._index[e.name]]
            actual = zlib.crc32(raw)
            if actual != expected:
                # drop the mmap view before raising: a caller holding the
                # exception (and so this frame) must not pin the buffer and
                # turn a later close() into a BufferError
                del raw
                _M_CRC_FAIL.inc()
                raise ChecksumError(self.path, e.name, e.offset, expected, actual)
            self._verified.add(e.name)
            _M_VERIFIED.inc()
        return raw

    def read_tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Full tensor, dequantized to ``dtype``, shaped ``[d, n]`` (or ``[n]``)."""
        e = self._by_name[name]
        raw = self._checked_raw(e)
        x = blocks.decode_tensor(raw, e.float_type, e.d * e.n)
        return x.reshape(e.shape).astype(dtype, copy=False)

    def read_raw(self, name: str) -> np.ndarray:
        """The tensor's undecoded file bytes (uint8 view into the mmap) —
        the input to lossless quantized repacking (ops.qmatmul.repack_q40)."""
        return self._checked_raw(self._by_name[name])

    def _rows_raw(self, e: TensorEntry, b0: int, b1: int) -> np.ndarray:
        """Tensor bytes [b0, b1) with the ``weights_read:bitflip`` seam
        applied when its (tensor-relative) target byte falls in range."""
        raw = self._buf[e.offset + b0 : e.offset + b1]
        fv = faults.fire("weights_read")
        if fv is not None and fv["action"] == "bitflip":
            k = min(max(0, fv["byte"]), e.nbytes - 1)
            if b0 <= k < b1:
                raw = raw.copy()
                raw[k - b0] ^= 1
        return raw

    def _check_bands(self, e: TensorEntry, start: int, stop: int,
                     failures: list | None = None) -> int:
        """CRC the not-yet-verified DLRB bands overlapping rows
        [start, stop). A mismatch raises :class:`ChecksumError` (the lazy
        read path) unless ``failures`` is given (the verify report path,
        which records and keeps scanning). Returns bands checked now."""
        if stop <= start:
            return 0
        crcs = self.band_crcs[self._index[e.name]]
        done = self._verified_bands.setdefault(e.name, set())
        rb = blocks.row_bytes(e.float_type, e.n)
        checked = 0
        for b in range(start // self.band_rows,
                       (stop - 1) // self.band_rows + 1):
            if b in done:
                continue
            r0 = b * self.band_rows
            r1 = min(e.d, r0 + self.band_rows)
            raw = self._rows_raw(e, r0 * rb, r1 * rb)
            actual = zlib.crc32(raw)
            checked += 1
            if actual != crcs[b]:
                del raw
                _M_CRC_FAIL.inc()
                if failures is None:
                    raise ChecksumError(self.path, e.name, e.offset + r0 * rb,
                                        crcs[b], actual)
                failures.append({
                    "name": e.name, "band": b, "offset": e.offset + r0 * rb,
                    "nbytes": (r1 - r0) * rb,
                    "expected_crc32": f"{crcs[b]:#010x}",
                    "actual_crc32": f"{actual:#010x}",
                })
                continue
            done.add(b)
            if len(done) == len(crcs):
                self._verified.add(e.name)
                _M_VERIFIED.inc()
        return checked

    def read_tensor_rows(self, name: str, rows: slice, dtype=np.float32) -> np.ndarray:
        """Dequantize only a row band — the unit of tensor-parallel sharded loading.

        Equivalent to the reference ``RowMatmulSlice.splitWeights`` row-band copy
        (`distributed-llama/src/transformer.cpp:25-42`) but done lazily at load time so
        each host only ever touches its own shard's bytes. The first touch of a
        checksummed band CRC-verifies only the DLRB bands the slice overlaps
        (sharded verify); files without a row-band table fall back to the
        whole-tensor check.
        """
        e = self._by_name[name]
        start, stop, step = rows.indices(e.d)
        assert step == 1
        if self._lazy_verify and e.name not in self._verified:
            if self.band_crcs is not None:
                self._check_bands(e, start, stop)
            else:
                self._checked_raw(e)
        rb = blocks.row_bytes(e.float_type, e.n)
        raw = self._buf[e.offset + start * rb : e.offset + stop * rb]
        x = blocks.decode_tensor(raw, e.float_type, (stop - start) * e.n)
        return x.reshape(stop - start, e.n).astype(dtype, copy=False)

    def shard_rows(self, e: TensorEntry, shard: int, n_shards: int) -> tuple:
        """The row stripe host ``shard`` of ``n_shards`` loads from ``e``:
        1-D tensors (d == 1) are replicated — every host reads them all."""
        if e.d == 1:
            return 0, 1
        return e.d * shard // n_shards, e.d * (shard + 1) // n_shards

    def verify(self, shard: tuple | None = None) -> dict:
        """Check tensors against the integrity sections (no dequantization).

        Default: every tensor's whole-tensor CRC, failures in plan order (the
        first element is the first bad tensor by byte offset). With
        ``shard=(i, n)``: only the row stripe host i of n actually loads
        (``shard_rows``; replicated 1-D tensors are always fully checked),
        using the DLRB row-band table — a 1/n verify reads ~1/n of the
        file's bytes. A sharded verify of a file WITHOUT a row-band table
        falls back to whole-tensor CRCs of the shard's tensors (every
        stripe is non-empty, so that is the whole file — honest, just not
        cheap). Files without any integrity section pass with
        ``has_integrity: False`` — open-time size/offset validation is then
        the only guarantee.
        """
        failures: list = []
        bands_checked = 0
        use_bands = shard is not None and self.band_crcs is not None
        for i, e in enumerate(self.entries):
            if self.tensor_crcs is None:
                break
            lo, hi = ((0, e.d) if shard is None
                      else self.shard_rows(e, shard[0], shard[1]))
            if hi <= lo:
                continue
            if use_bands:
                bands_checked += self._check_bands(e, lo, hi, failures)
                continue
            actual = zlib.crc32(self._raw_view(e))
            expected = self.tensor_crcs[i]
            if actual != expected:
                _M_CRC_FAIL.inc()
                failures.append({
                    "name": e.name, "offset": e.offset, "nbytes": e.nbytes,
                    "expected_crc32": f"{expected:#010x}",
                    "actual_crc32": f"{actual:#010x}",
                })
            else:
                self._verified.add(e.name)
                _M_VERIFIED.inc()
        report = {
            "path": self.path,
            "ok": not failures,
            "has_integrity": self.has_integrity,
            "has_row_bands": self.band_crcs is not None,
            "tensors": len(self.entries),
            "payload_bytes": self.entries[-1].offset + self.entries[-1].nbytes,
            "failures": failures,
        }
        if shard is not None:
            report["shard"] = f"{shard[0]}/{shard[1]}"
            report["row_band"] = self.band_rows
            report["bands_checked"] = bands_checked
        return report

    def iter_tensors(self, dtype=np.float32) -> Iterator[tuple[str, np.ndarray]]:
        for e in self.entries:
            yield e.name, self.read_tensor(e.name, dtype)


#: process-wide default for ModelWriter(checksums=None); the converter CLI's
#: ``--no-checksums`` flag flips it.
DEFAULT_WRITE_CHECKSUMS = True


class ModelWriter:
    """Streaming `.m` writer: header first, then tensors appended strictly in
    plan order — a 70B conversion never holds more than one tensor in RAM
    (the reference converters stream the same way,
    `distributed-llama/converter/convert-hf.py:92-125`). Unless ``checksums``
    is disabled, per-tensor CRC32s (and per-row-band CRC32s — the DLRB
    section that makes ``verify --shard`` and first-read shard verification
    cheap) are accumulated as tensors stream through and the trailing
    integrity sections are appended on close (the reference loader ignores
    trailing bytes, so such files stay reference-loadable)."""

    def __init__(self, path: str, spec: ModelSpec, checksums: bool | None = None,
                 row_band: int = DEFAULT_ROW_BAND):
        header = write_header(spec)
        self.spec = dataclasses.replace(spec, header_size=len(header))
        self.plan = tensor_plan(self.spec)
        self._i = 0
        self._checksums = DEFAULT_WRITE_CHECKSUMS if checksums is None else checksums
        self._row_band = max(1, int(row_band))
        self._crcs: list[int] = []
        self._band_crcs: list[list[int]] = []
        self._f = open(path, "wb")
        self._f.write(header)

    def write_next(self, name: str, x: np.ndarray) -> None:
        e = self.plan[self._i]
        if name != e.name:
            raise ValueError(f"tensor order violation: expected {e.name!r}, got {name!r}")
        x = np.asarray(x, dtype=np.float32)
        if x.size != e.d * e.n:
            raise ValueError(f"{e.name}: expected {e.d}x{e.n} values, got shape {x.shape}")
        raw = blocks.encode_tensor(x.reshape(-1), e.float_type)
        self._f.write(raw)
        if self._checksums:
            self._crcs.append(zlib.crc32(raw))
            rb = blocks.row_bytes(e.float_type, e.n)
            self._band_crcs.append([
                zlib.crc32(raw[r0 * rb:min(e.d, r0 + self._row_band) * rb])
                for r0 in range(0, e.d, self._row_band)])
        self._i += 1

    def close(self) -> None:
        if self._i != len(self.plan):
            missing = self.plan[self._i].name
            self._f.close()
            raise ValueError(f"model file incomplete: next expected tensor is {missing!r}")
        if self._checksums:
            payload = self.plan[-1].offset + self.plan[-1].nbytes
            self._f.write(build_integrity_section(self._crcs, payload))
            self._f.write(build_row_band_section(self._band_crcs,
                                                 self._row_band))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self._f.close()


def write_model(path: str, spec: ModelSpec, tensors: dict) -> None:
    """Write a `.m` file from a ``name -> ndarray`` dict (shapes per tensor_plan)."""
    with ModelWriter(path, spec) as w:
        for e in w.plan:
            w.write_next(e.name, tensors[e.name])
