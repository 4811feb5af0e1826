"""Solo decode engine: bucketed prefill, then one decode step per token with
a resident KV cache, per-token timing and sampling on the device.

The port of the JAX package's single-device ``Engine`` (prefill, generate,
Session, TokenStats and the numeric-health watchdog). PyTorch runs eagerly,
so there are no compiled step functions: a decode step enqueues its kernels
and the host waits only when it reads the sampled token. The KV cache is
updated in place, where the JAX programs donate it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import torch

from dllama_tpu_torch import resolve_device
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.runtime.sampler import SamplerConfig, sample_dynamic

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


class NumericHealthError(RuntimeError):
    """The decode-step watchdog saw non-finite logits (NaN/Inf from corrupt
    weights, a bad kernel, or a hardware error). Solo decode fails fast."""

    def __init__(self, where: str):
        super().__init__(f"non-finite logits detected {where}; "
                         f"output is unusable from this point")
        self.where = where


def prefill_bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return n


@dataclasses.dataclass
class TokenStats:
    """Per-token timing (the reference's G/I/T line):

    * ``generation_ms`` (G): total wall time for the token.
    * ``inference_ms`` (I): time the host waited on the device after
      enqueueing the step (``torch.cuda.synchronize``).
    * ``transfer_ms`` (T): G - I — host work and kernel launches.
    """

    generation_ms: float
    inference_ms: float
    transfer_ms: float = 0.0


@dataclasses.dataclass
class Session:
    """Conversation state carried across generate() calls (chat mode).

    ``pending_token`` is the last sampled token, which has NOT yet been fed
    through the model — the next call consumes it first."""

    cache: dict
    pos: int
    pending_token: Optional[int] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Holds device-resident params and runs solo generation on ``device``
    (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 sampler_cfg: SamplerConfig = SamplerConfig(),
                 cache_dtype=torch.float32, device=None):
        """Quantized projections that share an input are fused
        (``llama.fuse_qkv_ffn``) if they are not already. Every decode step
        checks ``isfinite(logits)`` and raises :class:`NumericHealthError`
        on a non-finite value."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sampler_cfg = sampler_cfg
        if llama.has_quant_leaves(params):
            params = llama.fuse_qkv_ffn(params)
        self.params = llama.params_to(params, self.device)
        self.rope = llama.rope_tables(cfg, self.device)
        self.cache_dtype = cache_dtype
        self.generator = torch.Generator(device=self.device).manual_seed(sampler_cfg.seed)
        self.prefill_ms = 0.0
        self.final_session: Optional[Session] = None

    def new_cache(self) -> dict:
        return llama.init_cache(self.cfg, self.cache_dtype, self.device)

    def prefill(self, cache: dict, tokens: list, pos: int = 0,
                chunk: Optional[int] = None) -> tuple:
        """Run the prompt starting at ``pos``. Returns (last_logits, cache).

        Tail-padding to a bucket is safe: padded queries produce logits we
        never read, and padded cache slots sit at positions a causal query
        never attends before a real decode overwrites them. ``chunk`` splits
        the prompt into pieces of at most that many tokens, each its own
        bucketed forward at an advancing ``pos`` into the same cache."""
        if not 0 < pos + len(tokens) <= self.cfg.seq_len:
            raise ValueError(
                f"prompt of {len(tokens)} tokens at pos {pos} exceeds seq_len {self.cfg.seq_len}")
        if chunk is not None and chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        if chunk is None or chunk >= len(tokens):
            return self._prefill_piece(cache, tokens, pos)
        logits = None
        for i in range(0, len(tokens), chunk):
            logits, cache = self._prefill_piece(cache, tokens[i:i + chunk], pos + i)
        return logits, cache

    def _prefill_piece(self, cache: dict, tokens, pos: int) -> tuple:
        """One bucketed prefill forward (validated by the callers)."""
        # clamp the padded bucket to the remaining context: padded rows past
        # seq_len would have nowhere to land in the cache
        bucket = min(prefill_bucket(len(tokens)), self.cfg.seq_len - pos)
        padded = torch.zeros(bucket, dtype=torch.long)
        padded[: len(tokens)] = torch.tensor(tokens, dtype=torch.long)
        logits, cache = llama.forward(self.cfg, self.params, self.rope,
                                      padded.to(self.device), cache, pos,
                                      last_pos=len(tokens) - 1)
        return logits[0], cache

    def _decode_step(self, cache: dict, token: torch.Tensor, pos: int) -> tuple:
        """Enqueue one decode step; returns (next token, finite flag), both
        device tensors the host has not waited for yet."""
        logits, _ = llama.forward(self.cfg, self.params, self.rope,
                                  token.reshape(1), cache, pos)
        scfg = self.sampler_cfg
        nxt = sample_dynamic(logits[0], scfg.temperature, scfg.topp, self.generator)
        return nxt, torch.isfinite(logits).all()

    def generate(self, prompt_tokens: list, steps: int, session: Optional[Session] = None,
                 stop_tokens: tuple = ()) -> Iterator[tuple]:
        """Yield (token_id, TokenStats) for up to ``steps`` generated tokens.

        Pass the previous call's ``engine.final_session`` to continue a
        conversation with one continuous KV cache and position counter."""
        scfg = self.sampler_cfg
        if session is None:
            cache, pos = self.new_cache(), 0
        else:
            cache, pos = session.cache, session.pos
            if session.pending_token is not None:
                prompt_tokens = [session.pending_token] + list(prompt_tokens)
        steps = min(steps, self.cfg.seq_len - pos - len(prompt_tokens))

        t0 = time.perf_counter()
        if len(prompt_tokens) > 1:
            last_logits, cache = self.prefill(cache, prompt_tokens, pos)
            token = sample_dynamic(last_logits, scfg.temperature, scfg.topp, self.generator)
        else:
            token = torch.tensor(prompt_tokens[0], dtype=torch.long, device=self.device)
        _sync(self.device)
        self.prefill_ms = (time.perf_counter() - t0) * 1000.0

        tok_int: Optional[int] = None
        if len(prompt_tokens) > 1:
            pos += len(prompt_tokens)
            if steps <= 0:
                self.final_session = Session(cache, pos, pending_token=None)
                return
            tok_int = int(token)
            self.final_session = Session(cache, pos, pending_token=tok_int)
            yield tok_int, TokenStats(self.prefill_ms, self.prefill_ms)
            steps -= 1
            if tok_int in stop_tokens:
                return
        for _ in range(max(steps, 0)):
            t1 = time.perf_counter()
            token, ok = self._decode_step(cache, token, pos)
            # the step returns once its kernels are enqueued: the wait from
            # here to the result is device execution ("inference")
            t2 = time.perf_counter()
            _sync(self.device)
            t3 = time.perf_counter()
            if not bool(ok):
                raise NumericHealthError(f"at decode position {pos}")
            tok_int = int(token)
            t4 = time.perf_counter()
            pos += 1
            self.final_session = Session(cache, pos, pending_token=tok_int)
            yield tok_int, TokenStats(
                generation_ms=(t4 - t1) * 1000.0,
                inference_ms=(t3 - t2) * 1000.0,
                transfer_ms=(t2 - t1 + t4 - t3) * 1000.0,
            )
            if tok_int in stop_tokens:
                break
        if tok_int is None:
            pending = prompt_tokens[0] if len(prompt_tokens) == 1 else None
        else:
            pending = tok_int
        self.final_session = Session(cache, pos, pending_token=pending)
