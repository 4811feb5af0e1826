"""Model spec: hyperparameters + on-disk header codec for the `.m` weight format.

Mirrors the reference header semantics (`distributed-llama/src/transformer.cpp:183-298`,
writer at `distributed-llama/converter/writer.py:110-139`) so published distributed-llama
model files load directly:

* new format: ``int32 magic 0x0A00ABCD``, ``int32 headerSize`` (bytes, counting the two
  leading ints), then ``(key, value) int32`` pairs.
* old format: magic ``0xABCD00`` (llama) / ``0xABCD01`` (grok1) followed by a fixed
  9-int struct (`distributed-llama/src/transformer.hpp:59-69`).

Weights follow the header immediately; tensor order is defined in
``dllama_tpu_torch.formats.weights``.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import IntEnum

from dllama_tpu_torch.quants import blocks

MAGIC_KV = 0x0A00ABCD
MAGIC_OLD_LLAMA = 0xABCD00
MAGIC_OLD_GROK1 = 0xABCD01

# headers are ~120 bytes in practice; anything past this is a hostile/corrupt file
MAX_HEADER_SIZE = 1 << 16


class FormatError(ValueError):
    """A malformed, hostile, or corrupt `.m` file. ValueError subclass so
    callers that predate the integrity work keep catching it."""


class ArchType(IntEnum):
    LLAMA = 0xABCD00
    GROK1 = 0xABCD01
    MIXTRAL = 0xABCD02


class HiddenAct(IntEnum):
    GELU = 0
    SILU = 1


class HeaderKey(IntEnum):
    """`distributed-llama/src/transformer.hpp:41-56`."""

    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHTS_FLOAT_TYPE = 13


@dataclasses.dataclass
class ModelSpec:
    arch: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    weights_float_type: int = blocks.F32
    version: int = 0
    header_size: int = 0  # bytes from file start to first weight byte

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def validate(self) -> None:
        for field in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
                      "vocab_size", "seq_len"):
            v = getattr(self, field)
            if v <= 0:
                raise FormatError(f"bad header field {field}: {v} (must be positive)")
        if self.n_experts < 0 or self.n_active_experts < 0:
            raise FormatError(
                f"bad header field nExperts/nActiveExperts: "
                f"{self.n_experts}/{self.n_active_experts}")
        if self.dim % self.n_heads != 0:
            raise FormatError(
                f"bad header field dim: {self.dim} not divisible by nHeads={self.n_heads}")
        if (self.dim * self.n_kv_heads) % self.n_heads != 0:
            raise FormatError(
                f"bad header field nKvHeads: kv_dim not integral for "
                f"dim={self.dim}, nHeads={self.n_heads}, nKvHeads={self.n_kv_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise FormatError(
                f"bad header field nKvHeads: {self.n_kv_heads} does not divide "
                f"nHeads={self.n_heads}")
        if self.is_moe and not 0 < self.n_active_experts <= self.n_experts:
            raise FormatError(
                f"bad header field nActiveExperts: {self.n_active_experts} "
                f"(nExperts={self.n_experts})")
        if self.weights_float_type not in (blocks.F32, blocks.F16, blocks.Q40, blocks.Q80):
            raise FormatError(
                f"bad header field weightsFloatType: {self.weights_float_type} "
                f"(known: F32=0, F16=1, Q40=2, Q80=3)")


def parse_header(data, file_size: int | None = None) -> ModelSpec:
    """Parse a `.m` header from the first bytes of the file.

    ``data`` is any buffer covering at least the header. Hostile or corrupt
    headers raise :class:`FormatError` naming the offending field — never a
    bare ``struct.error`` and never a silently-garbage spec. ``file_size``
    (when known) lets the ``headerSize``-past-EOF check run.
    """
    try:
        (magic,) = struct.unpack_from("<i", data, 0)
    except struct.error:
        raise FormatError(f"file too short for a header magic ({len(data)} bytes)") from None
    if magic in (MAGIC_OLD_LLAMA, MAGIC_OLD_GROK1):
        try:
            fields = struct.unpack_from("<9i", data, 4)
        except struct.error:
            raise FormatError(
                f"header truncated: old-format header needs 40 bytes, have {len(data)}"
            ) from None
        dim, hidden_dim, n_layers, n_heads, n_kv_heads, n_experts, n_active, vocab, seq = fields
        spec = ModelSpec(
            arch=ArchType(magic),
            dim=dim,
            hidden_dim=hidden_dim,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            n_experts=n_experts,
            n_active_experts=n_active,
            vocab_size=vocab,
            seq_len=seq,
            header_size=4 + 9 * 4,
        )
    elif magic == MAGIC_KV:
        try:
            (header_size,) = struct.unpack_from("<i", data, 4)
        except struct.error:
            raise FormatError("header truncated: missing headerSize") from None
        if header_size < 16 or header_size > MAX_HEADER_SIZE:
            raise FormatError(
                f"bad header field headerSize: {header_size} "
                f"(want 16..{MAX_HEADER_SIZE})")
        if (header_size - 8) % 8 != 0:
            raise FormatError(
                f"bad header field headerSize: {header_size} does not hold "
                f"whole (key, value) int32 pairs")
        if file_size is not None and header_size > file_size:
            raise FormatError(
                f"bad header field headerSize: {header_size} runs past "
                f"end of file ({file_size} bytes)")
        if header_size > len(data):
            raise FormatError(
                f"header truncated: headerSize={header_size} but only "
                f"{len(data)} bytes available")
        n_kv_ints = (header_size - 8) // 4
        values = struct.unpack_from(f"<{n_kv_ints}i", data, 8)
        try:
            kv = {HeaderKey(values[i]): values[i + 1] for i in range(0, n_kv_ints, 2)}
        except ValueError:
            bad = [values[i] for i in range(0, n_kv_ints, 2)
                   if values[i] not in HeaderKey._value2member_map_]
            raise FormatError(f"unknown header key(s): {bad}") from None
        try:
            required = {}
            for key in (HeaderKey.ARCH_TYPE, HeaderKey.DIM, HeaderKey.HIDDEN_DIM,
                        HeaderKey.N_LAYERS, HeaderKey.N_HEADS,
                        HeaderKey.VOCAB_SIZE, HeaderKey.SEQ_LEN):
                required[key] = kv[key]
        except KeyError as e:
            raise FormatError(f"missing required header field {e.args[0].name}") from None
        try:
            arch = ArchType(kv[HeaderKey.ARCH_TYPE])
        except ValueError:
            raise FormatError(
                f"bad header field archType: {kv[HeaderKey.ARCH_TYPE]:#x}") from None
        try:
            hidden_act = HiddenAct(kv.get(HeaderKey.HIDDEN_ACT, HiddenAct.SILU))
        except ValueError:
            raise FormatError(
                f"bad header field hiddenAct: {kv[HeaderKey.HIDDEN_ACT]}") from None
        spec = ModelSpec(
            arch=arch,
            dim=kv[HeaderKey.DIM],
            hidden_dim=kv[HeaderKey.HIDDEN_DIM],
            n_layers=kv[HeaderKey.N_LAYERS],
            n_heads=kv[HeaderKey.N_HEADS],
            n_kv_heads=kv.get(HeaderKey.N_KV_HEADS, kv[HeaderKey.N_HEADS]),
            n_experts=kv.get(HeaderKey.N_EXPERTS, 0),
            n_active_experts=kv.get(HeaderKey.N_ACTIVE_EXPERTS, 0),
            vocab_size=kv[HeaderKey.VOCAB_SIZE],
            seq_len=kv[HeaderKey.SEQ_LEN],
            hidden_act=hidden_act,
            # rope_theta is stored as a plain int in the reference format
            # (`distributed-llama/src/transformer.cpp:240`)
            rope_theta=float(kv.get(HeaderKey.ROPE_THETA, 10000)),
            weights_float_type=kv.get(HeaderKey.WEIGHTS_FLOAT_TYPE, blocks.F32),
            version=kv.get(HeaderKey.VERSION, 0),
            header_size=8 + n_kv_ints * 4,
        )
    else:
        raise FormatError(f"unsupported model file magic 0x{magic & 0xFFFFFFFF:X}")
    spec.validate()
    return spec


def write_header(spec: ModelSpec) -> bytes:
    """Serialize a ModelSpec as a new-style KV header (matches writer.py:110-139)."""
    pairs = [
        (HeaderKey.VERSION, spec.version),
        (HeaderKey.ARCH_TYPE, int(spec.arch)),
        (HeaderKey.DIM, spec.dim),
        (HeaderKey.HIDDEN_DIM, spec.hidden_dim),
        (HeaderKey.N_LAYERS, spec.n_layers),
        (HeaderKey.N_HEADS, spec.n_heads),
        (HeaderKey.N_KV_HEADS, spec.n_kv_heads),
        (HeaderKey.N_EXPERTS, spec.n_experts),
        (HeaderKey.N_ACTIVE_EXPERTS, spec.n_active_experts),
        (HeaderKey.VOCAB_SIZE, spec.vocab_size),
        (HeaderKey.SEQ_LEN, spec.seq_len),
        (HeaderKey.HIDDEN_ACT, int(spec.hidden_act)),
        (HeaderKey.ROPE_THETA, int(spec.rope_theta)),
        (HeaderKey.WEIGHTS_FLOAT_TYPE, spec.weights_float_type),
    ]
    data = b"".join(struct.pack("<ii", int(k), int(v)) for k, v in pairs)
    return struct.pack("<ii", MAGIC_KV, 8 + len(data)) + data
