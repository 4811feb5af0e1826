"""Runtime model configuration, derived from the on-disk ModelSpec."""

from __future__ import annotations

import dataclasses

import torch

from dllama_tpu_torch.formats.spec import ArchType, HiddenAct, ModelSpec
from dllama_tpu_torch.ops import rope as rope_ops

# Grok-1 scalings (`distributed-llama/src/grok1-tasks.cpp:11-14,269-272`)
GROK_EMBEDDING_SCALE = 78.38367176906169
GROK_LOGIT_SCALE = 0.5773502691896257

#: user-facing dtype aliases (CLI flags -> torch dtypes)
DTYPE_ALIASES = {"f8": torch.float8_e4m3fn}


def resolve_dtype(name: str | None, default: str) -> torch.dtype:
    """Flag string (or None) -> torch.dtype, honoring DTYPE_ALIASES."""
    name = name or default
    if name in DTYPE_ALIASES:
        return DTYPE_ALIASES[name]
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str  # "llama" | "grok1" | "mixtral"
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    head_size: int
    kv_dim: int
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: str = "silu"
    rope_theta: float = 10000.0
    # None = "derive from arch" for the four arch-implied fields below; an
    # explicitly passed value always wins
    rope_style: str | None = None
    embedding_scale: float | None = None
    logit_scale: float | None = None
    post_norms: bool | None = None
    norm_eps: float = 1e-5
    dtype: str = "float32"

    def __post_init__(self):
        grok = self.arch == "grok1"
        if self.rope_style is None:
            object.__setattr__(
                self, "rope_style",
                rope_ops.HALF if self.arch in ("grok1", "mixtral")
                else rope_ops.INTERLEAVED)
        if self.embedding_scale is None:
            object.__setattr__(
                self, "embedding_scale", GROK_EMBEDDING_SCALE if grok else 1.0)
        if self.logit_scale is None:
            object.__setattr__(
                self, "logit_scale", GROK_LOGIT_SCALE if grok else 1.0)
        if self.post_norms is None:
            object.__setattr__(self, "post_norms", grok)

    @property
    def torch_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype, "float32")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @classmethod
    def from_spec(cls, spec: ModelSpec, dtype: str = "float32") -> "ModelConfig":
        arch = {ArchType.LLAMA: "llama", ArchType.GROK1: "grok1", ArchType.MIXTRAL: "mixtral"}[
            spec.arch
        ]
        # Grok/Mixtral use the half-split (NeoX) rotary layout, Llama the
        # interleaved one (`distributed-llama/src/transformer.cpp:398-402`).
        rope_style = rope_ops.HALF if arch in ("grok1", "mixtral") else rope_ops.INTERLEAVED
        return cls(
            arch=arch,
            dim=spec.dim,
            hidden_dim=spec.hidden_dim,
            n_layers=spec.n_layers,
            n_heads=spec.n_heads,
            n_kv_heads=spec.n_kv_heads,
            vocab_size=spec.vocab_size,
            seq_len=spec.seq_len,
            head_size=spec.head_size,
            kv_dim=spec.kv_dim,
            n_experts=spec.n_experts,
            n_active_experts=spec.n_active_experts,
            hidden_act="gelu" if spec.hidden_act == HiddenAct.GELU else "silu",
            rope_theta=spec.rope_theta,
            rope_style=rope_style,
            embedding_scale=GROK_EMBEDDING_SCALE if arch == "grok1" else 1.0,
            logit_scale=GROK_LOGIT_SCALE if arch == "grok1" else 1.0,
            post_norms=arch == "grok1",
            dtype=dtype,
        )
