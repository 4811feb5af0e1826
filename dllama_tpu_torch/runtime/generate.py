"""Decode engine: bucketed prefill, then decode steps with a resident KV
cache, per-token timing and sampling on the device.

The port of the JAX package's single-device ``Engine`` (prefill, generate,
Session, TokenStats and the numeric-health watchdog), its batched decode
(``generate_batch``), the continuous-batching ``BatchSession`` in its three
residency layouts (the uniform pool, bucketed KV slot pools and paged KV
with the radix prefix cache and row export/import) and prompt-lookup
speculative decoding, solo (``generate_spec``) and batched
(``generate_batch_spec``).
PyTorch runs eagerly, so where the JAX package compiles a decode step and
fuses N of them into one program, the port captures one decode step in a
CUDA graph (``runtime.graphs.StepGraph``) and replays it once per step:
solo (``generate``, ``generate_fused``) and batched (``generate_batch``,
``BatchSession``, whose bucket slabs and paged windows are graphs of their
own). Each replay feeds the next on the device, and the host
waits only when it reads the sampled tokens — once per token in
``generate``, which yields each one, and once per chunk of up to
``decode_chunk`` steps in ``generate_fused`` and batched decode.
``Engine(cuda_graphs=False)`` keeps the eager steps (solo ``forward`` with a
host position) for comparison; on the CPU the graph's body runs eagerly.
Prefill and the speculative verify steps are eager. The KV cache is updated
in place, where the JAX programs donate it.

Tensor parallelism (``Engine(tp=...)``, a ``parallel.group.TPGroup``): one
engine per rank, each holding its rank's output-sharded quantized weights
and its kv heads' cache; every forward gathers the activations
(``parallel.collectives``, over the Q80 wire with ``tp_compress``), so
every rank computes the same logits, and every rank samples them with the
same seeded generator: every rank emits the same tokens, with no broadcast.
``generate``, ``generate_fused`` and ``generate_batch`` run under TP, with
eager steps: a gloo gather cannot be captured in a CUDA graph, and
capturing NCCL's is later work. The speculative paths and ``BatchSession``
(the server's) are refused under TP.

Telemetry and fault seams are the reference's: ``Engine(metrics=...)``
registers the same metric names on an ``observability.MetricsRegistry``
(the port's default registry unless told otherwise; ``None`` turns them
off), observed on the host once per call, chunk or prefill piece, never
inside a captured graph. The ``prefill``, ``prefill_chunk``, ``admit``,
``step_chunk`` and ``logits`` seams of ``faults`` fire where the
reference fires them; ``logits:nan`` poisons a decode row through the
graph's static ``poison`` flags (``StepGraph.load``), which every replay
reads.

Batched rows and solo runs: a batched row sums in the order K1/K3 and flash
decode take at B rows, which is not the solo order (the dequant-matmuls'
split plans depend on the row count), so a row agrees with its solo run
within the decode-step tolerance, not bit for bit. At a fixed batch size a
row's tokens do not depend on its neighbours, bit for bit: every kernel
computes a row from that row alone, in an order fixed by the shapes.

Speculative and plain decode: a verify step scores T = draft + 1 rows in
one forward, where plain decode feeds one. A step with no draft is plain
decode's own step. With drafts the kernels sum T rows in another order
than one (past 8 rows K1/K3 take the tensor-core tile), so verify logits
agree with plain decode's within the decode-step tolerance, not bit for
bit. The emitted tokens are the ones plain decode would pick from those
logits: argmax, or the Gumbel draw plain decode would make with the same
generator state (``verify_sampled``).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Iterator, Optional

import numpy as np
import torch

from dllama_tpu_torch import faults, observability, resolve_device
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel import quant_tp
from dllama_tpu_torch.runtime import paged_kv
from dllama_tpu_torch.runtime.graphs import GraphCache, StepGraph
from dllama_tpu_torch.runtime.sampler import (
    SamplerConfig, gumbel_noise, row_seed, sample_dynamic, sample_rows,
)

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
#: decode steps per host sync in generate_fused and batched decode (one read
#: of the chunk's tokens)
DECODE_CHUNK = 64

#: sentinel for Engine(metrics=...): "the port's default registry"
DEFAULT_METRICS = object()


class NumericHealthError(RuntimeError):
    """The decode-step watchdog saw non-finite logits (NaN/Inf from corrupt
    weights, a bad kernel, or a hardware error). Solo decode fails fast; a
    BatchSession quarantines the row instead (finish reason ``"error"``)
    and the server maps it to a 500 / ``finish_reason: "error"``."""

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
    """Per-token timing (the reference's G/I/T/S/R line):

    * ``generation_ms`` (G): total wall time for the token.
    * ``inference_ms`` (I): time the host waited on the device after
      enqueueing the step (``torch.cuda.synchronize``).
    * ``transfer_ms`` (T): G - I — host work and kernel launches.
    * ``sent_kb`` / ``recv_kb`` (S/R): the kB this rank's gathers sent for
      the token under tensor parallelism (the group's byte counter,
      ``parallel.collectives``), and received: as many, an all-gather's
      ring; 0 on one device.
    """

    generation_ms: float
    inference_ms: float
    transfer_ms: float = 0.0
    sent_kb: float = 0.0
    recv_kb: float = 0.0


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
                 cache_dtype=torch.float32, device=None, decode_chunk: int = DECODE_CHUNK,
                 cuda_graphs: bool = True, metrics=DEFAULT_METRICS, tp=None,
                 tp_compress: bool = False):
        """Quantized projections that share an input are fused
        (``llama.fuse_qkv_ffn``) if they are not already. Every solo decode
        step checks ``isfinite(logits)`` and ``generate`` raises
        :class:`NumericHealthError` on a non-finite value (``generate_fused``
        once per chunk); batched decode keeps a per-row flag instead
        (``row_health``). ``decode_chunk``: decode steps between host syncs
        in ``generate_fused`` and batched decode. ``cuda_graphs``: decode
        steps replay captured graphs (:class:`StepGraph`, on the CPU their
        body runs eagerly); False keeps the eager steps. ``metrics``: the
        registry the engine's histograms and counters go to (the default
        registry unless given; ``None`` disables them).

        ``tp``: this process's rank of a tensor-parallel world
        (``parallel.group.TPGroup``); ``params`` must be the rank's
        quantized shards (``quant_params_from_reader(..., tp=)``,
        ``quant_tp.shard_params``), fused here from its own parts, and the
        engine runs on the group's device with eager steps
        (``cuda_graphs`` is ignored). ``tp_compress``: the gathers move the
        Q80 wire (``tp_wire`` says which wire runs)."""
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self._register_metrics(
            observability.default_registry() if metrics is DEFAULT_METRICS else metrics)
        self.tp = tp
        self.tp_wire = "q80" if tp is not None and tp_compress else "plain"
        self._tp_kw: dict = {}
        self._tp_size = 1
        if tp is not None:
            quant_tp.validate_quant_tp(cfg, tp.size)
            quant_tp.check_shards(params, cfg, tp.size)
            if device is not None and torch.device(device) != tp.device:
                raise ValueError(f"device {device} is not the tensor-parallel rank's {tp.device}")
            device = tp.device
            cuda_graphs = False
            self._tp_kw = {"tp": tp, "tp_compress": tp_compress}
            self._tp_size = tp.size
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sampler_cfg = sampler_cfg
        if llama.has_quant_leaves(params):
            params = llama.fuse_qkv_ffn(params)
        self.params = llama.params_to(params, self.device)
        self.rope = llama.rope_tables(cfg, self.device)
        self.cache_dtype = cache_dtype
        self.generator = torch.Generator(device=self.device).manual_seed(sampler_cfg.seed)
        self.decode_chunk = decode_chunk
        self.cuda_graphs = cuda_graphs
        self.graphs = GraphCache()
        # the solo cache that calls without a session reuse, and the live
        # Sessions and running calls that hold it
        self._resident: Optional[dict] = None
        self._holders: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
        # the batch cache BatchSessions decode in, and the open session using it
        self._pool: Optional[dict] = None
        self._pool_user = None
        # bucket slabs of closed bucketed sessions, oldest first: the next
        # session's pools take them (and replay the graphs captured on
        # them) instead of allocating new slabs
        self._slabs: list = []
        #: generate_batch_spec runs on this engine (the server's spec route)
        self.supports_batch_spec = tp is None
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.row_health: list = []
        self.final_session: Optional[Session] = None

    def _register_metrics(self, metrics) -> None:
        """The reference Engine's metric names (``None``: no telemetry). The
        two TP counters belong to ``--tp-overlap`` and ``--tp-reduce``, which
        are not ported: they stay at 0, so that ``/metrics`` lists the same
        names as the reference's."""
        self.metrics = metrics
        if metrics is None:
            self._m_prefill = self._m_step = self._m_chunk = None
            self._m_prefill_chunk = self._m_quarantine = None
            self._m_spec_steps = self._m_spec_accepted = self._m_spec_emitted = None
            self._m_migrations = self._m_prefix_hits = self._m_prefix_misses = None
            self._m_prefix_tokens = self._m_cow = self._m_prefix_evictions = None
            return
        h, c = metrics.histogram, metrics.counter
        self._m_prefill = h("dllama_prefill_ms", "Prompt prefill wall time per request")
        self._m_step = h("dllama_decode_step_ms",
                         "Per-token decode wall time (solo streaming path)")
        self._m_chunk = h("dllama_decode_chunk_ms",
                          "Fused decode-chunk wall time (fused/batched/pooled paths)")
        self._m_prefill_chunk = h("dllama_prefill_chunk_ms",
                                  "Incremental prefill chunk wall time (chunked admission)")
        self._m_migrations = c("dllama_kv_migrations_total",
                               "Pooled rows migrated to the next larger KV bucket")
        self._m_quarantine = c("dllama_numeric_quarantines_total",
                               "Rows/streams stopped by the numeric-health watchdog")
        self._m_spec_steps = c("dllama_spec_verify_steps_total",
                               "Speculative-decode verify launches")
        self._m_spec_accepted = c("dllama_spec_drafts_accepted_total",
                                  "Draft tokens accepted by speculative verify")
        self._m_spec_emitted = c("dllama_spec_tokens_emitted_total",
                                 "Tokens emitted by speculative decode paths")
        self._m_prefix_hits = c("dllama_prefix_cache_hits_total",
                                "Paged admissions that aliased at least one cached KV page")
        self._m_prefix_misses = c("dllama_prefix_cache_misses_total",
                                  "Paged admissions with no cached prefix page to alias")
        self._m_prefix_tokens = c(
            "dllama_prefix_tokens_matched_total",
            "Prompt tokens served from the radix prefix cache instead of being re-prefilled")
        self._m_cow = c("dllama_kv_cow_copies_total",
                        "Boundary KV pages copied (copy-on-write) at paged admission")
        self._m_prefix_evictions = c(
            "dllama_prefix_evictions_total",
            "Refcount-zero prefix-cache pages evicted (LRU) to satisfy an allocation")
        c("dllama_tp_overlap_chunks_total",
          "Decode/verify dispatches routed through the microbatch "
          "compute/communication-overlap TP programs")
        c("dllama_tp_reduce_chunks_total",
          "Decode/verify dispatches served by the row-parallel "
          "(K-sharded wo/w2, ring reduce-scatter) TP programs")

    def _poison_flag(self) -> bool:
        """The solo ``logits:nan`` fault seam: True poisons this dispatch."""
        fv = faults.fire("logits")
        return fv is not None and fv["action"] == "nan"

    def _poison_rows(self, batch: int) -> tuple:
        """The batched ``logits:nan`` seam: the rows (``row=N``, clamped to
        the batch) this dispatch poisons."""
        fv = faults.fire("logits")
        if fv is not None and fv["action"] == "nan":
            return (min(max(fv["row"], 0), batch - 1),)
        return ()

    def _wire_bytes(self) -> int:
        """Bytes this rank's gathers have sent so far (0 on one device)."""
        return 0 if self.tp is None else self.tp.sent_bytes

    def _refuse_under_tp(self, what: str) -> None:
        if self.tp is not None:
            raise ValueError(f"{what} does not run under tensor parallelism yet: "
                             f"{quant_tp.NOT_PORTED}")

    def new_cache(self) -> dict:
        return llama.init_cache(self.cfg, self.cache_dtype, self.device, self._tp_size)

    def free_cache(self, cache: dict) -> None:
        """Free ``cache`` now rather than at the next collection: the
        engine forgets it (as its resident solo or pool cache, or its
        ``final_session``'s), its step graphs go, and ``cache`` is emptied,
        so the memory returns to the allocator once no other reference to
        its tensors is left. The dict must not be used afterwards."""
        if cache is self._resident:
            self._resident = None
        if cache is self._pool:
            self._pool, self._pool_user = None, None
        self._slabs = [c for c in self._slabs if c is not cache]
        if self.final_session is not None and self.final_session.cache is cache:
            self.final_session = None
        if "k" in cache:
            self.graphs.drop(cache["k"])
        cache.clear()

    def _pool_cache(self, sess: "BatchSession", batch: int) -> dict:
        """The batch cache [L, batch, S, kv, hd] for a new BatchSession: the
        engine's resident one, unless an open session uses it (then a new
        one). Consecutive sessions of one pool size thus replay the decode
        graphs captured on it; a session of another size replaces it.
        Slot reuse needs no clearing (see BatchSession)."""
        user = self._pool_user() if self._pool_user is not None else None
        if user is not None and not user._closed:
            return self._batch_cache_init(batch)
        if self._pool is not None and self._pool["k"].shape[1] != batch:
            self.free_cache(self._pool)
        if self._pool is None:
            self._pool = self._batch_cache_init(batch)
        self._pool_user = weakref.ref(sess)
        return self._pool

    def _solo_cache(self) -> dict:
        """A zeroed solo cache for a ``generate`` or ``generate_fused`` call
        without a session: the engine's resident one, unless a live Session
        or a running call holds it (then a new one). Consecutive calls thus
        replay one decode graph, captured once per engine (a graph holds its
        cache's pointers). ``final_session`` is dropped first: the engine's
        own reference does not hold the cache."""
        self.final_session = None
        if self._resident is None:
            self._resident = self.new_cache()
            return self._resident
        if self._holders:
            return self.new_cache()
        for c in self._resident.values():
            c.zero_()
        return self._resident

    def _session(self, cache: dict, pos: int, pending_token: Optional[int] = None) -> Session:
        """A Session over ``cache``, counted among the resident cache's
        holders when it is that cache."""
        s = Session(cache, pos, pending_token)
        if cache is self._resident:
            self._holders[id(s)] = s
        return s

    def _batch_cache_init(self, batch: int) -> dict:
        return llama.init_batch_cache(self.cfg, batch, self.cache_dtype, self.device,
                                      self._tp_size)

    def _bucket_cache_init(self, cap: int, ctx: int) -> dict:
        """A zeroed slab [L, cap, ctx, kv, hd]: a bucket pool's cache, or
        (cap pages of ctx tokens) a paged session's arena."""
        cfg = self.cfg
        shape = (cfg.n_layers, cap, ctx, cfg.n_kv_heads // self._tp_size, cfg.head_size)
        return {n: torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
                for n in ("k", "v")}

    @staticmethod
    def _batch_cache_insert(cache: dict, single: dict, b: int) -> None:
        """Copy a single-sequence cache [L, S, kv, hd] into row ``b`` of a
        slot slab [L, B, ctx, kv, hd], in place. Only the slab's own context
        is copied: admission places a row in a slab that covers its prompt,
        so its prefill wrote nothing past it."""
        for n in ("k", "v"):
            dst = cache[n]
            dst[:, b].copy_(single[n][:, :dst.shape[2]])

    @staticmethod
    def _bucket_cache_migrate(dst: dict, src: dict, sb: int, db: int) -> None:
        """Row ``sb`` of a bucket slab into row ``db`` of a longer one, in
        place: the copy is the row's whole attended history (its position
        is below the source's context); the slots past it are garbage the
        row writes before it attends them, so migration is exact."""
        for n in ("k", "v"):
            dst[n][:, db, :src[n].shape[2]].copy_(src[n][:, sb])

    @staticmethod
    def _bucket_cache_grow(dst: dict, src: dict) -> None:
        """A pool's rows into a slab of twice the capacity (same context):
        rows keep their indices, the new rows are free."""
        for n in ("k", "v"):
            dst[n][:, :src[n].shape[1]].copy_(src[n])

    def _take_slab(self, cap: int, ctx: int) -> dict:
        """A bucket slab [L, cap, ctx, kv, hd]: the one a closed session
        left last (its step graphs are still captured), else a new one.
        Slot reuse needs no clearing (see BatchSession)."""
        for i in range(len(self._slabs) - 1, -1, -1):  # the newest first
            if tuple(self._slabs[i]["k"].shape[1:3]) == (cap, ctx):
                return self._slabs.pop(i)
        return self._bucket_cache_init(cap, ctx)

    def _keep_slabs(self, caches: list, budget_tokens: int) -> None:
        """Keep closed bucket slabs for the next session, newest last, and
        free the oldest ones while the kept slabs hold more than
        ``budget_tokens`` token-slots (the session's modeled budget)."""
        self._slabs.extend(caches)
        size = [c["k"].shape[1] * c["k"].shape[2] for c in self._slabs]
        while self._slabs and sum(size) > budget_tokens:
            size.pop(0)
            self.free_cache(self._slabs[0])

    # -- paged KV: one arena {k, v: [L, P, page, kv, hd]}, page 0 scratch ----
    @staticmethod
    def _pages_to_single(single: dict, arena: dict, pages: list, ntok: int) -> None:
        """Arena pages ``pages`` into token positions [0, ntok) of a solo
        staging cache, in one indexed copy per leaf: a paged admission
        preloads its whole aliased prefix so."""
        idx = torch.tensor(pages, dtype=torch.long, device=arena["k"].device)
        for n in ("k", "v"):
            a = arena[n]
            w = a.index_select(1, idx).reshape(a.shape[0], -1, a.shape[3], a.shape[4])
            single[n][:, :ntok].copy_(w[:, :ntok])

    @staticmethod
    def _single_to_pages(arena: dict, single: dict, pages: list, offs: list) -> None:
        """Token blocks [offs[i], offs[i] + page) of a filled staging cache
        into arena pages ``pages[i]``, in one indexed copy per leaf."""
        dev = arena["k"].device
        page = arena["k"].shape[2]
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        slots = (torch.tensor(offs, dtype=torch.long, device=dev)[:, None]
                 + torch.arange(page, device=dev)).reshape(-1)
        for n in ("k", "v"):
            s = single[n].index_select(1, slots)  # [L, M * page, kv, hd]
            arena[n].index_copy_(1, idx, s.reshape(s.shape[0], len(pages), page,
                                                   *s.shape[2:]))

    @staticmethod
    def _pages_import(arena: dict, pages: list, blob: list) -> None:
        """Imported page payloads (the arena's leaves in order, each
        [L, M, page, kv, hd]) into arena pages ``pages`` [M], cast to the
        arena's dtype, in one indexed copy per leaf."""
        dev = arena["k"].device
        idx = torch.tensor(pages, dtype=torch.long, device=dev)
        for n, x in zip(("k", "v"), blob):
            a = arena[n]
            a.index_copy_(1, idx, torch.as_tensor(x).to(device=dev, dtype=a.dtype))

    @staticmethod
    def _page_copy(arena: dict, dst: int, src: int) -> None:
        """Arena page ``src`` duplicated into page ``dst``: the
        copy-on-write boundary of a paged admission whose prompt ends flush
        on a cached block (its last slot is the pending token's write)."""
        for n in ("k", "v"):
            arena[n][:, dst].copy_(arena[n][:, src])

    def _row_generator(self, temperature: float, seed: int) -> Optional[torch.Generator]:
        """A sampled row's own generator (greedy rows draw nothing)."""
        if temperature <= 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

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
        faults.fire("prefill")
        if chunk is not None and chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        if chunk is None or chunk >= len(tokens):
            return self._prefill_piece(cache, tokens, pos)
        logits = None
        for i in range(0, len(tokens), chunk):
            faults.fire("prefill_chunk")
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
                                      last_pos=len(tokens) - 1, **self._tp_kw)
        return logits[0], cache

    def _sampling(self, sampler: Optional[SamplerConfig]) -> tuple:
        """(settings, generator) of one call: ``sampler`` with a fresh
        generator seeded from ``sampler.seed``, else the engine's own."""
        if sampler is None:
            return self.sampler_cfg, self.generator
        return sampler, torch.Generator(device=self.device).manual_seed(sampler.seed)

    def _decode_step(self, cache: dict, token: torch.Tensor, pos: int, scfg: SamplerConfig,
                     gen: torch.Generator, poison: bool = False) -> tuple:
        """Enqueue one decode step; returns (next token, finite flag), both
        device tensors the host has not waited for yet. ``poison``: the
        logits are NaN (the ``logits`` fault seam)."""
        logits, _ = llama.forward(self.cfg, self.params, self.rope,
                                  token.reshape(1), cache, pos, **self._tp_kw)
        if poison:
            logits = torch.full_like(logits, float("nan"))
        nxt = sample_dynamic(logits[0], scfg.temperature, scfg.topp, gen)
        return nxt, torch.isfinite(logits).all()

    def step_graph(self, cache: dict, sampled: bool, ring: int) -> StepGraph:
        """The captured decode step over ``cache`` (made on first use): the
        solo step (``llama.forward_decode``) for a cache [L, S, kv, hd], the
        batched one at the grid bound ctx for a slot slab [L, B, ctx, kv,
        hd] (the uniform pool's ctx is seq_len, a bucket's its own).
        ``sampled``: the graph samples (any mix of sampled and greedy rows;
        else every row is greedy); ``ring``: the most steps a run takes."""
        cfg, params, rope = self.cfg, self.params, self.rope
        solo = cache["k"].dim() == 4
        ctx = cache["k"].shape[1 if solo else 2]

        def step(c, tok, pos):
            if solo:
                return llama.forward_decode(cfg, params, rope, tok, c, pos)[0]
            return llama.forward_batched(cfg, params, rope, tok, c, pos, ctx)[0]

        def make() -> StepGraph:
            return StepGraph(step, cache, ctx, sampled, ring)

        # the storage and shape (B, ctx) of the cache, greedy or sampled, the ring
        key = (cache["v"].data_ptr(), tuple(cache["k"].shape), sampled, ring)
        return self.graphs.get(cache["k"], key, make)

    def _paged_step(self, arena: dict, tokens: torch.Tensor, pos: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
        """One batched decode step over paged KV -> logits [B, vocab]. Each
        row's pages (``table`` [B, nb], page 0 the scratch page) are
        gathered into a window [L, B, nb * page, kv, hd], where logical
        position i of a row is window slot i, so ``llama.forward_batched``
        runs on it as on a bucket slab of ctx nb * page (grid bound the
        window); then only the page holding each row's written position
        goes back to the arena. An aliased prefix page is never that page (a
        live row writes at or past its pending token, in a private page),
        and rows on scratch write scratch."""
        B, nb = table.shape
        a = arena["k"]
        L, page = a.shape[0], a.shape[2]
        W = nb * page
        flat = table.reshape(-1)
        window = {n: arena[n].index_select(1, flat).reshape(L, B, W, *a.shape[3:])
                  for n in ("k", "v")}
        logits = llama.forward_batched(self.cfg, self.params, self.rope, tokens, window, pos,
                                       W)[0]
        blk = (pos.long().clamp(0, W - 1) // page)[:, None]  # [B, 1]
        phys = table.gather(1, blk).reshape(-1)  # [B]
        rows = torch.arange(B, device=table.device)
        for n in ("k", "v"):
            w = window[n].reshape(L, B, nb, page, *a.shape[3:])
            arena[n].index_copy_(1, phys, w[:, rows, blk[:, 0]])
        return logits

    def paged_graph(self, arena: dict, cap: int, nb: int, sampled: bool,
                    ring: int) -> StepGraph:
        """The captured paged decode step (made on first use) of ``cap``
        rows with tables of ``nb`` blocks over ``arena``: the window
        ``nb * page`` is its grid bound and pinning slot. Keyed by the
        arena's storage, nb, cap and greedy or sampled; the table is a
        static input that ``load`` refills."""
        W = nb * arena["k"].shape[2]

        def make() -> StepGraph:
            return StepGraph(self._paged_step, arena, W, sampled, ring, batch=cap,
                             table_blocks=nb)

        key = (arena["v"].data_ptr(), ("paged", nb, cap), sampled, ring)
        return self.graphs.get(arena["k"], key, make)

    def _decode_chunk_solo(self, cache: dict, token: torch.Tensor, pos: int, n: int,
                           scfg: SamplerConfig, gen: torch.Generator,
                           poison: bool = False) -> tuple:
        """``n`` solo decode steps from ``token`` (a device tensor) at host
        ``pos`` with no host sync: one graph replay each (eager steps with
        ``cuda_graphs=False``). Returns the sampled tokens int64 [n] and the
        finite flag [1], device tensors. ``poison``: every step's logits are
        NaN (the ``logits`` fault seam)."""
        if self.cuda_graphs:
            g = self.step_graph(cache, scfg.temperature > 0.0, self.decode_chunk)
            g.load(token, pos, [scfg.temperature], [scfg.topp], poison=(0,) if poison else ())
            toks, ok = g.run(n, [gen])
            return toks[:, 0], ok
        out, ok = [], torch.ones(1, dtype=torch.bool, device=self.device)
        for i in range(n):
            token, finite = self._decode_step(cache, token, pos + i, scfg, gen, poison)
            ok &= finite
            out.append(token)
        return torch.stack(out), ok

    def generate(self, prompt_tokens: list, steps: int, session: Optional[Session] = None,
                 stop_tokens: tuple = (), sampler: Optional[SamplerConfig] = None
                 ) -> Iterator[tuple]:
        """Yield (token_id, TokenStats) for up to ``steps`` generated tokens.

        Pass the previous call's ``engine.final_session`` to continue a
        conversation with one continuous KV cache and position counter.
        Without a session the call decodes in the engine's resident cache
        when no live Session holds it, so its decode graph is captured once
        per engine; a Session kept from an earlier call stays valid.
        ``sampler`` overrides the engine's settings for this call only, with
        a fresh generator seeded from ``sampler.seed`` (the engine's
        generator is left as it is)."""
        scfg, gen = self._sampling(sampler)
        if session is None:
            cache, pos = self._solo_cache(), 0
        else:
            cache, pos = session.cache, session.pos
            if session.pending_token is not None:
                prompt_tokens = [session.pending_token] + list(prompt_tokens)
        held = self._session(cache, pos)  # holds the cache while this call runs
        steps = min(steps, self.cfg.seq_len - pos - len(prompt_tokens))

        t0 = time.perf_counter()
        b0 = self._wire_bytes()
        if len(prompt_tokens) > 1:
            last_logits, cache = self.prefill(cache, prompt_tokens, pos)
            token = sample_dynamic(last_logits, scfg.temperature, scfg.topp, gen)
        else:
            token = torch.tensor(prompt_tokens[0], dtype=torch.long, device=self.device)
        _sync(self.device)
        self.prefill_ms = (time.perf_counter() - t0) * 1000.0
        if self._m_prefill is not None and len(prompt_tokens) > 1:
            self._m_prefill.observe(self.prefill_ms)

        tok_int: Optional[int] = None
        if len(prompt_tokens) > 1:
            pos += len(prompt_tokens)
            if steps <= 0:
                self.final_session = self._session(cache, pos, pending_token=None)
                return
            tok_int = int(token)
            self.final_session = self._session(cache, pos, pending_token=tok_int)
            kb = (self._wire_bytes() - b0) / 1024.0
            yield tok_int, TokenStats(self.prefill_ms, self.prefill_ms, sent_kb=kb, recv_kb=kb)
            steps -= 1
            if tok_int in stop_tokens:
                return
        for _ in range(max(steps, 0)):
            t1 = time.perf_counter()
            b1 = self._wire_bytes()
            poison = self._poison_flag()
            if self.cuda_graphs:
                toks, ok = self._decode_chunk_solo(cache, token, pos, 1, scfg, gen, poison)
                token = toks[0]
            else:
                token, ok = self._decode_step(cache, token, pos, scfg, gen, poison)
            # the step returns once its kernels are enqueued: the wait from
            # here to the result is device execution ("inference")
            t2 = time.perf_counter()
            _sync(self.device)
            t3 = time.perf_counter()
            if not bool(ok.all()):
                if self._m_quarantine is not None:
                    self._m_quarantine.inc()
                raise NumericHealthError(f"at decode position {pos}")
            tok_int = int(token)
            t4 = time.perf_counter()
            if self._m_step is not None:
                self._m_step.observe((t4 - t1) * 1000.0)
            pos += 1
            self.final_session = self._session(cache, pos, pending_token=tok_int)
            kb = (self._wire_bytes() - b1) / 1024.0
            yield tok_int, TokenStats(
                generation_ms=(t4 - t1) * 1000.0,
                inference_ms=(t3 - t2) * 1000.0,
                transfer_ms=(t2 - t1 + t4 - t3) * 1000.0,
                sent_kb=kb, recv_kb=kb,
            )
            if tok_int in stop_tokens:
                break
        if tok_int is None:
            pending = prompt_tokens[0] if len(prompt_tokens) == 1 else None
        else:
            pending = tok_int
        self.final_session = self._session(cache, pos, pending_token=pending)

    def generate_fused(self, prompt_tokens: list, steps: int,
                       sampler: Optional[SamplerConfig] = None, stop_tokens: tuple = (),
                       on_chunk=None) -> tuple:
        """Generate ``steps`` tokens in chunks of at most ``decode_chunk``
        decode steps, with one host sync per chunk: the port of the
        reference's fused on-device loop. Returns (tokens, prefill_ms,
        decode_ms). Each chunk is one graph replay per step; a non-finite
        logit anywhere in a chunk raises :class:`NumericHealthError` after
        it. ``final_session`` resumes after the last token, which is pending
        (fed by the next call).

        ``stop_tokens``: the tokens are cut after the first one, and no
        chunk runs after the chunk that made it (the steps past it in that
        chunk are wasted, and their cache slots past ``final_session.pos``
        are written before any later step attends them). ``on_chunk(tokens)``:
        called with the prefill's token, then with each chunk's tokens (cut
        as returned), as they reach the host. Use ``generate`` where each
        token must reach the host as soon as it is made.

        The reference pads its last chunk to a prefill bucket so that
        distinct step counts share compiled programs; graph replays have no
        such cost, so the port runs exactly the steps it needs. The cache
        slots past ``final_session.pos`` may differ from the reference's;
        no later step reads them before writing them.

        ``sampler`` (or the engine's settings and generator) draws as
        ``generate`` draws: with the same seed the two emit the same
        tokens. The reference's fused loop splits its key chain once per
        chunk and so departs from its own ``generate``; the port's
        generator has no chain, and its numbers differ from JAX's anyway."""
        scfg, gen = self._sampling(sampler)
        cache = self._solo_cache()
        steps = min(steps, self.cfg.seq_len - len(prompt_tokens))
        t0 = time.perf_counter()
        if steps <= 0 and len(prompt_tokens) > 1:
            # nothing to emit; the prefill still advances the session
            _, cache = self.prefill(cache, prompt_tokens, 0)
            _sync(self.device)
            self.prefill_ms = (time.perf_counter() - t0) * 1000.0
            self.final_session = self._session(cache, len(prompt_tokens), pending_token=None)
            return [], self.prefill_ms, 0.0
        if len(prompt_tokens) > 1:
            last_logits, cache = self.prefill(cache, prompt_tokens, 0)
            token = sample_dynamic(last_logits, scfg.temperature, scfg.topp, gen)
            pos = len(prompt_tokens)
            first = [int(token)]
            steps = 0 if first[0] in stop_tokens else steps - 1
        else:
            token = torch.tensor(prompt_tokens[0], dtype=torch.long, device=self.device)
            pos = 0
            first = []
        _sync(self.device)
        self.prefill_ms = prefill_ms = (time.perf_counter() - t0) * 1000.0
        if self._m_prefill is not None and len(prompt_tokens) > 1:
            self._m_prefill.observe(prefill_ms)
        if first and on_chunk is not None:
            on_chunk(first)

        t1 = time.perf_counter()
        toks: list = []
        remaining = steps
        while remaining > 0:
            tc = time.perf_counter()
            n = min(self.decode_chunk, remaining)
            chunk, ok = self._decode_chunk_solo(cache, token, pos, n, scfg, gen,
                                                self._poison_flag())
            *got, finite = torch.cat([chunk, ok.long()]).tolist()  # the chunk's one sync
            if not finite:
                if self._m_quarantine is not None:
                    self._m_quarantine.inc()
                raise NumericHealthError(f"in fused decode chunk starting at position {pos}")
            if self._m_chunk is not None:
                self._m_chunk.observe((time.perf_counter() - tc) * 1000.0)
            cut = next((i + 1 for i, t in enumerate(got) if t in stop_tokens), n)
            toks.extend(got[:cut])
            if on_chunk is not None:
                on_chunk(got[:cut])
            token = chunk[-1]
            pos += cut
            remaining = 0 if cut < n or got[-1] in stop_tokens else remaining - n
        decode_ms = (time.perf_counter() - t1) * 1000.0

        emitted = first + toks
        if emitted:
            pending = emitted[-1]
        else:
            pending = prompt_tokens[0] if len(prompt_tokens) == 1 else None
        self.final_session = self._session(cache, pos, pending_token=pending)
        return emitted, prefill_ms, decode_ms

    def generate_spec(self, prompt_tokens: list, steps: int, session: Optional[Session] = None,
                      stop_tokens: tuple = (), draft_len: int = 8, ngram: int = 3,
                      history: Optional[list] = None,
                      sampler: Optional[SamplerConfig] = None) -> Iterator[tuple]:
        """Decode with prompt-lookup speculative drafting, greedy or sampled:
        yields (token_id, TokenStats) as ``generate`` does, and the tokens
        ``generate`` picks with the same sampler wherever a verify row's
        logits equal the decode step's. On the CPU they do. On the card a
        verify step with drafts (T > 1) sums its logits through other kernel
        routes than a T = 1 decode step, so they differ in their low bits:
        greedy tokens can then differ at near-ties, and sampled ones far
        more often, since top-p ranks the vocabulary before the draw.

        A verify step drafts up to ``draft_len`` tokens by matching the
        trailing ``ngram`` of the context against its own history (what
        followed the same n-gram last time), feeds pending + draft through
        ONE ``forward`` at T = len(draft) + 1 (up to 16 rows take the decode
        kernels; a step with no draft is plain decode's T = 1 step), and
        accepts the longest prefix of the draft that the model itself picks:
        m matched drafts emit m + 1 tokens for one pass over the weights.

        Greedy takes each row's argmax and draws nothing, as ``generate``
        draws nothing. Sampled, row i takes the draw ``generate`` makes for
        its i-th token: the step draws one row of Gumbel noise per fed row,
        in order, from the call's generator (``sampler``'s fresh one, else
        the engine's) and notes the generator's state after each draw; after
        acceptance the generator goes back to the state after the last
        EMITTED token, so a stop token or the ``steps`` cap that truncates a
        step truncates the draws with it.

        Rejected draft rows write K/V past the accepted prefix;
        every later step writes a position before any query attends it, so
        nothing is rolled back. ``history``: tokens already in the session's
        cache before this call (without its pending token), used for
        drafting only. ``final_session`` after each yielded token resumes
        exactly after it. The first token's stats report the prefill, as in
        ``generate``; a verify step's times go to the first token it emits,
        the others report 0."""
        self._refuse_under_tp("generate_spec")
        scfg, gen = self._sampling(sampler)
        sampled = scfg.temperature > 0.0
        S = self.cfg.seq_len
        if session is None:
            cache, pos = self.new_cache(), 0
        else:
            cache, pos = session.cache, session.pos
            if session.pending_token is not None:
                prompt_tokens = [session.pending_token] + list(prompt_tokens)
        if not prompt_tokens:
            raise ValueError("generate_spec needs a token to feed: an empty prompt needs a "
                             "session with a pending token")
        held = self._session(cache, pos)  # holds the cache while this call runs
        steps = min(steps, S - pos - len(prompt_tokens))

        t0 = time.perf_counter()
        # the index covers the tokens in the cache; the pending token joins
        # it when a verify step consumes it
        index = _NgramIndex(ngram)
        if history:
            index.extend(history)
        if len(prompt_tokens) > 1:
            index.extend(prompt_tokens)
            last_logits, cache = self.prefill(cache, prompt_tokens, pos)
            token = int(sample_dynamic(last_logits, scfg.temperature, scfg.topp, gen))
            pos += len(prompt_tokens)
        else:
            token = int(prompt_tokens[0])
        self.prefill_ms = (time.perf_counter() - t0) * 1000.0
        if steps <= 0:
            self.final_session = self._session(cache, pos, pending_token=token)
            return

        emitted = 0
        first = len(prompt_tokens) > 1
        while emitted < steps:
            if first:  # the prefill's token
                out, first, base = [token], False, pos - 1
                stats = TokenStats(self.prefill_ms, self.prefill_ms)
            else:
                t1 = time.perf_counter()
                L = min(draft_len + 1, S - pos)
                draft = index.draft(token, min(L - 1, steps - emitted - 1))
                feed = torch.tensor([token] + draft, dtype=torch.long)
                logits, _ = llama.forward(self.cfg, self.params, self.rope,
                                          feed.to(self.device), cache, pos)
                if sampled:
                    picks, states = verify_sampled(logits, scfg, gen)
                else:
                    picks = torch.argmax(logits, dim=-1)
                ok = torch.isfinite(logits).all().reshape(1)
                t2 = time.perf_counter()
                _sync(self.device)
                t3 = time.perf_counter()
                *g, finite = torch.cat([picks, ok.long()]).tolist()  # the step's one read
                if not finite:
                    raise NumericHealthError(f"at verify position {pos}")
                m, out = accept(draft, g, steps - emitted, stop_tokens)
                if sampled:  # back to the state after the last emitted token's draw
                    gen.set_state(states[len(out) - 1])
                if self._m_spec_steps is not None:
                    self._m_spec_steps.inc()
                    self._m_spec_accepted.inc(m)
                    self._m_spec_emitted.inc(len(out))
                index.extend([token] + draft[:m])
                token, base = out[-1], pos
                pos += m + 1
                t4 = time.perf_counter()
                stats = TokenStats(generation_ms=(t4 - t1) * 1000.0,
                                   inference_ms=(t3 - t2) * 1000.0,
                                   transfer_ms=(t2 - t1 + t4 - t3) * 1000.0)
            for i, tk in enumerate(out):
                emitted += 1
                # a consumer stopping at token i resumes as if only tokens
                # 0..i were consumed: later slots are overwritten first
                self.final_session = self._session(cache, base + i + 1, pending_token=tk)
                yield tk, (stats if i == 0 else TokenStats(0.0, 0.0))
                if tk in stop_tokens:
                    return

    # -- batched decode -------------------------------------------------------
    def _decode_chunk_batch(self, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                            n: int, temps: list, topps: list, generators: list,
                            host_pos: list, poison: tuple = (),
                            table: Optional[torch.Tensor] = None) -> tuple:
        """``n`` batched decode steps with no host sync: tokens, positions
        and the per-row finite flags stay on the device. Row b samples with
        its own settings and generator; a row whose context fills pins at
        slot ctx - 1 (its later tokens are garbage the caller drops), ctx
        the slab's context (seq_len for the uniform pool and generate_batch,
        a bucket's own, or a paged window nb * page).
        One graph replay per step, the graph's grid bound ctx (a row's
        bits do not depend on the bound); eager with ``cuda_graphs=False``,
        where ``host_pos``, the host's mirror of ``pos``, bounds flash
        decode's grid for the whole chunk. ``poison``: the rows whose logits
        are NaN in every step (the ``logits`` fault seam). ``table``: the
        page tables [B, nb] of a paged step over the arena ``cache``.
        Returns (tokens [n, B], ok [B], the positions after the chunk)."""
        sampled = any(t > 0.0 for t in temps)
        ring = max(n, self.decode_chunk)
        if table is None:
            ctx = cache["k"].shape[2]
        else:
            ctx = table.shape[1] * cache["k"].shape[2]
        if self.cuda_graphs:
            if table is None:
                g = self.step_graph(cache, sampled, ring)
            else:
                g = self.paged_graph(cache, table.shape[0], table.shape[1], sampled, ring)
            g.load(tokens, pos, temps, topps, poison=poison, table=table)
            toks, ok = g.run(n, generators)
            return toks.clone(), ok.clone(), g.pos.clone()
        if table is None:
            bound = min(max(host_pos) + n, ctx)

            def step(tok, p):
                return llama.forward_batched(self.cfg, self.params, self.rope, tok, cache, p,
                                             bound, **self._tp_kw)[0]
        else:
            table = table.to(self.device, torch.long)

            def step(tok, p):
                return self._paged_step(cache, tok, p, table)
        ok = torch.ones(tokens.shape, dtype=torch.bool, device=self.device)
        mask = None
        if poison:
            mask = torch.zeros(tokens.shape, dtype=torch.bool)
            mask[list(poison)] = True
            mask = mask.to(self.device)
        out = []
        for _ in range(n):
            logits = step(tokens, pos)
            if mask is not None:
                logits = logits.masked_fill(mask[:, None], float("nan"))
            ok &= torch.isfinite(logits).all(dim=-1)
            tokens = sample_rows(logits, temps, topps, generators)
            out.append(tokens)
            pos = torch.clamp(pos + 1, max=ctx - 1)
        return torch.stack(out), ok, pos

    def _prefill_batch_rows(self, prompts: list) -> tuple:
        """The batch cache [L, B, S, kv, hd] with every row's prompt prefix
        in place: each DISTINCT prefix is prefilled once through the solo
        bucketed ``prefill`` and copied into every row that shares it. The
        last prompt token stays pending (the first batched step feeds it).
        Returns (cache, pending tokens [B], positions [B]); sets
        ``prefill_ms``."""
        t0 = time.perf_counter()
        cache = self._batch_cache_init(len(prompts))
        groups: dict = {}
        for b, p in enumerate(prompts):
            if len(p) > 1:
                groups.setdefault(tuple(p[:-1]), []).append(b)
        for prefix, rows in groups.items():
            _, single = self.prefill(self.new_cache(), list(prefix), 0)
            for b in rows:
                self._batch_cache_insert(cache, single, b)
            del single  # 1-token-prompt rows keep their zero slots
        _sync(self.device)
        self.prefill_ms = (time.perf_counter() - t0) * 1000.0
        if self._m_prefill is not None:
            self._m_prefill.observe(self.prefill_ms)
        return cache, [int(p[-1]) for p in prompts], [len(p) - 1 for p in prompts]

    def generate_batch(self, prompts: list, steps: int,
                       sampler: Optional[SamplerConfig] = None, stop_tokens: tuple = (),
                       row_steps: Optional[list] = None, samplers: Optional[list] = None,
                       on_chunk=None) -> list:
        """Decode B independent prompts together: one pass over the weights
        per step serves every sequence (``llama.forward_batched``). Returns B
        token lists; row b carries min(steps, its own remaining context)
        tokens — a near-full row pins at its last slot while the others go
        on. ``stop_tokens``: once EVERY row has emitted one (or met its
        budget) the remaining chunks are skipped; rows still carry tokens
        past their stop (the caller truncates). ``row_steps``: per-row
        budgets for that check (default ``steps``).

        Sampling: row b runs its own generator. ``samplers`` gives row b its
        full settings, the generator seeded with ``samplers[b].seed``. With
        one ``sampler``, rows share its temperature/top-p and row b's seed
        is ``row_seed(sampler.seed, b)`` (row 0 keeps the seed itself). With
        neither, the engine's settings, and a base seed drawn from the
        engine's generator. Greedy rows are exact argmaxes either way.

        ``on_chunk(rows)``: called after every chunk with each row's tokens
        from this chunk (trimmed to its budget). After the call
        ``row_health[b]`` is False once row b's logits went non-finite (its
        tokens are garbage from that chunk on; the other rows are
        unaffected); ``prefill_ms`` and ``decode_ms`` hold the wall times."""
        if not prompts or any(not p for p in prompts):
            raise ValueError("generate_batch needs non-empty prompts")
        B = len(prompts)
        if samplers is not None:
            if len(samplers) != B:
                raise ValueError(f"samplers must have {B} entries")
            cfgs, seeds = list(samplers), [sc.seed for sc in samplers]
        else:
            scfg = sampler if sampler is not None else self.sampler_cfg
            if sampler is not None:
                base = scfg.seed
            else:
                base = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                         device=self.device))
            cfgs, seeds = [scfg] * B, [row_seed(base, b) for b in range(B)]
        temps = [float(c.temperature) for c in cfgs]
        topps = [float(c.topp) for c in cfgs]
        gens = [self._row_generator(t, sd) for t, sd in zip(temps, seeds)]

        cache, pend, poss = self._prefill_batch_rows(prompts)
        S = self.cfg.seq_len
        tokens = torch.tensor(pend, dtype=torch.long, device=self.device)
        pos = torch.tensor(poss, dtype=torch.int32, device=self.device)
        rooms = [S - p for p in poss]  # feeds each row allows
        steps = min(steps, max(rooms))
        budgets = [min(rooms[b], row_steps[b] if row_steps else steps) for b in range(B)]
        out: list = [[] for _ in range(B)]
        self.row_health = [True] * B
        self.decode_ms = 0.0
        if steps <= 0:
            return out
        remaining, done = steps, 0
        host_pos = list(poss)
        t1 = time.perf_counter()
        while remaining > 0:
            tc = time.perf_counter()
            n = min(self.decode_chunk, remaining)
            chunk, ok, pos = self._decode_chunk_batch(cache, tokens, pos, n, temps, topps, gens,
                                                      host_pos, self._poison_rows(B))
            arr = chunk.cpu().tolist()  # the chunk's one host sync
            okh = ok.cpu().tolist()
            if self._m_chunk is not None:
                self._m_chunk.observe((time.perf_counter() - tc) * 1000.0)
            tokens = chunk[-1]
            host_pos = [min(p + n, S - 1) for p in host_pos]
            fresh: list = [[] for _ in range(B)]
            for b in range(B):
                if self.row_health[b] and not okh[b] and self._m_quarantine is not None:
                    self._m_quarantine.inc()
                self.row_health[b] = self.row_health[b] and bool(okh[b])
                # a context-exhausted row pinned at its last slot: keep only
                # the tokens its room allows
                keep = max(0, min(n, rooms[b] - done))
                fresh[b] = [row[b] for row in arr[:keep]]
                out[b].extend(fresh[b])
            done += n
            remaining -= n
            if on_chunk is not None:
                on_chunk(fresh)
            if (stop_tokens or row_steps) and all(
                    len(out[b]) >= budgets[b]
                    or (stop_tokens and any(t in stop_tokens for t in out[b]))
                    for b in range(B)):
                break
        self.decode_ms = (time.perf_counter() - t1) * 1000.0
        return out

    def generate_batch_spec(self, prompts: list, steps: int, stop_tokens: tuple = (),
                            row_steps: Optional[list] = None, draft_len: int = 8,
                            ngram: int = 3, sampler: Optional[SamplerConfig] = None,
                            on_step=None, row_cancel=None) -> tuple:
        """Batched greedy decode with prompt-lookup drafting: every verify
        step scores T candidate rows of ALL B sequences in one pass over the
        weights (``llama.forward_batched_verify``), T = 1 + the longest
        draft of the step (at most ``draft_len``; shorter drafts are padded).

        Returns (rows, stats). Row b is ``generate_batch``'s greedy row b cut
        at its budget min(steps, row_steps[b], its context) and, inclusively,
        at its first stop token; stats = {"verify_steps", "accepted_drafts",
        "emitted"}. The draft cap is shared and shrinks so the most
        context-bound active row's rows fit; a row with no draft still verifies its pending token
        (at least one token a step), and a finished row re-verifies its
        pending token in place at min(pos, S - T) without advancing. Greedy
        only: above temperature 0 (``sampler`` or the engine's settings) it
        raises ValueError. With no ``sampler`` it draws one number from the
        engine's generator, as ``generate_batch`` does, so either call leaves
        the generator in the same state.

        ``on_step(fresh)``: after every verify step, each row's tokens that
        step emitted (final: budget- and stop-truncated; empty for finished
        rows). ``row_cancel(b) -> bool``: asked for every unfinished row
        between steps; True finishes the row there, its tokens so far stand.
        The host reads the [B, T] argmax once a step."""
        self._refuse_under_tp("generate_batch_spec")
        if not prompts or any(not p for p in prompts):
            raise ValueError("generate_batch_spec needs non-empty prompts")
        scfg = sampler if sampler is not None else self.sampler_cfg
        if scfg.temperature > 0.0:
            raise ValueError("generate_batch_spec is greedy only: use generate_batch for sampled "
                             "batches or generate_spec for sampled solo decoding")
        if sampler is None:  # generate_batch's base-seed draw
            torch.randint(0, 2 ** 62, (1,), generator=self.generator, device=self.device)
        B, S, dev = len(prompts), self.cfg.seq_len, self.device
        cache, pend, poss = self._prefill_batch_rows(prompts)
        budgets = [min(S - poss[b], row_steps[b] if row_steps else steps, steps)
                   for b in range(B)]
        indexes = [_NgramIndex(ngram) for _ in range(B)]
        for b, p in enumerate(prompts):
            indexes[b].extend(p[:-1])
        out: list = [[] for _ in range(B)]
        done = [budgets[b] <= 0 for b in range(B)]
        verify_steps = accepted = 0
        t1 = time.perf_counter()
        while not all(done):
            if row_cancel is not None:
                for b in range(B):
                    if not done[b] and row_cancel(b):
                        done[b] = True
                if all(done):
                    break
            cap = min(draft_len, min(S - poss[b] for b in range(B) if not done[b]) - 1)
            drafts = [[] if done[b] else
                      indexes[b].draft(pend[b], min(cap, budgets[b] - len(out[b]) - 1))
                      for b in range(B)]
            T = 1 + max(len(d) for d in drafts)
            # a finished row re-verifies its pending token in place
            feeds = [[pend[b]] * T if done[b] else [pend[b]] + d + [0] * (T - 1 - len(d))
                     for b, d in enumerate(drafts)]
            starts = [min(poss[b], S - T) if done[b] else poss[b] for b in range(B)]
            logits, cache = llama.forward_batched_verify(
                self.cfg, self.params, self.rope,
                torch.tensor(feeds, dtype=torch.long, device=dev), cache,
                torch.tensor(starts, dtype=torch.int32, device=dev))
            g = torch.argmax(logits, dim=-1).tolist()  # the step's one host read
            verify_steps += 1
            fresh: list = [[] for _ in range(B)]
            for b in range(B):
                if done[b]:
                    continue
                m, emit = accept(drafts[b], g[b], budgets[b] - len(out[b]), stop_tokens)
                accepted += m
                indexes[b].extend([pend[b]] + drafts[b][:m])
                out[b].extend(emit)
                fresh[b] = emit
                pend[b] = emit[-1]
                poss[b] += m + 1
                if len(out[b]) >= budgets[b] or emit[-1] in stop_tokens:
                    done[b] = True
            if on_step is not None:
                on_step(fresh)
        self.decode_ms = (time.perf_counter() - t1) * 1000.0
        emitted = sum(len(r) for r in out)
        if self._m_spec_steps is not None:
            self._m_spec_steps.inc(verify_steps)
            self._m_spec_accepted.inc(accepted)
            self._m_spec_emitted.inc(emitted)
        return out, {"verify_steps": verify_steps, "accepted_drafts": accepted,
                     "emitted": emitted}

    def batch_session(self, max_batch: int, chunk: Optional[int] = None,
                      bucket_kv: bool = False, min_bucket: Optional[int] = None,
                      prefill_chunk: int = 0, kv_budget=None,
                      kv_pages: int = 0) -> "BatchSession":
        """Open a slot-pool decode session (continuous batching): rows are
        admitted, stepped and released independently between chunks of
        ``chunk`` steps (default ``decode_chunk``); see
        :class:`BatchSession`. The default is one uniform batch cache [L,
        max_batch, S, kv, hd]; ``bucket_kv`` shards it into power-of-two
        context buckets from ``min_bucket`` up to S under the same modeled
        budget of max_batch * S token-slots, so more short rows fit;
        ``kv_pages`` > 0 (tokens a page) makes it one page arena under that
        budget with per-row page tables and a copy-on-write radix prefix
        cache (and takes precedence over ``bucket_kv``). ``prefill_chunk``
        > 0 sets the default token budget of ``prefill_step`` for chunked
        (``admit_begin``) admissions; ``kv_budget`` is an optional external
        accountant (``serving.lifecycle.KVBudget``) that mirrors
        reservations into gauges and, paged, owns the page free list
        (``attach_pages``)."""
        self._refuse_under_tp("a BatchSession")
        return BatchSession(self, max_batch, chunk, bucket_kv=bucket_kv,
                            min_bucket=min_bucket, prefill_chunk=prefill_chunk,
                            kv_budget=kv_budget, kv_pages=kv_pages)


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one admitted BatchSession row."""

    room: int  # feeds the row's remaining context allows (S - admit pos)
    budget: int  # min(room, the caller's step budget)
    stop_tokens: tuple
    reserved: int  # KV token-slots reserved against the session budget
    offered: int = 0  # tokens the chunks have offered this row so far
    done: bool = False  # budget/stop reached; pinned in place until release()
    emitted: int = 0  # tokens actually kept (after budget/stop truncation)
    finish: Optional[str] = None  # "stop" | "length" | "error" once done
    prefilling: bool = False  # admit_begin()ed, prompt not fully consumed
    prefill_ms: float = 0.0  # accumulated admission-prefill wall time


@dataclasses.dataclass
class _PendingPrefill:
    """A chunked admission's prompt in flight (``admit_begin``)."""

    prompt: list
    scfg: SamplerConfig
    cache: dict  # the solo staging cache [L, S, kv, hd] being filled
    cursor: int = 0  # prompt-prefix tokens already prefilled
    # paged publish-at-admit: the radix nodes this admission published
    # ready=False (aligned with the row's blocks; None where another row's
    # node was there first), and the tokens already scattered into pages
    pub_nodes: list = dataclasses.field(default_factory=list)
    scattered: int = 0


class _Rows:
    """Host-side decode state of one decode shape's rows, shipped to the
    device per chunk: each row's pending token, position, sampler settings
    and generator, and the handle occupying it. Free rows pin at ``pin``
    (the shape's last slot), greedy, feeding token 0."""

    def __init__(self, cap: int, pin: int):
        self.cap, self.pin = cap, pin
        self.tokens = [0] * cap
        self.pos = [pin] * cap
        self.temps = [0.0] * cap
        self.topps = [1.0] * cap
        self.gens: list = [None] * cap
        self.rows: list = [None] * cap  # the handle occupying each row

    def _grow_rows(self) -> None:
        """Double the capacity: rows keep their indices, the new rows are free."""
        pad = self.cap
        self.tokens += [0] * pad
        self.pos += [self.pin] * pad
        self.temps += [0.0] * pad
        self.topps += [1.0] * pad
        self.gens += [None] * pad
        self.rows += [None] * pad
        self.cap *= 2

    def move_row(self, r: int, dst: "_Rows", d: int) -> None:
        """Carry row ``r``'s decode state to row ``d`` of ``dst`` and free
        ``r`` (its position re-pins)."""
        for name in ("tokens", "pos", "temps", "topps", "gens", "rows"):
            getattr(dst, name)[d] = getattr(self, name)[r]
        self.free_row(r)

    def free_row(self, r: int) -> None:
        self.rows[r] = None
        self.tokens[r], self.pos[r] = 0, self.pin
        self.temps[r], self.topps[r], self.gens[r] = 0.0, 1.0, None

    def live(self, slots: dict) -> list:
        """Rows whose handle is live (admitted, not done, not prefilling)."""
        return [r for r, h in enumerate(self.rows)
                if h is not None and not slots[h].done and not slots[h].prefilling]


class _BucketPool(_Rows):
    """One context bucket's slot pool: a slab [L, cap, ctx, kv, hd] and its
    rows' host state. ``ctx`` may be shorter than the model's context: a
    row's position stays inside its slab (the session migrates it out
    before it outgrows it), and attention reads a row only up to its own
    position, so a short slab is exact."""

    def __init__(self, eng: Engine, ctx: int, cap: int, cache: Optional[dict] = None):
        super().__init__(cap, ctx - 1)
        self.ctx = ctx
        self.cache = cache if cache is not None else eng._take_slab(cap, ctx)

    def grow(self, eng: Engine, retired: list) -> None:
        """Double the pool's capacity: rows keep their indices (no handle
        moves), the new rows are free. The old slab goes to ``retired``."""
        bigger = eng._take_slab(self.cap * 2, self.ctx)
        eng._bucket_cache_grow(bigger, self.cache)
        retired.append(self.cache)
        self.cache = bigger
        self._grow_rows()


@dataclasses.dataclass
class _RowPages:
    """A paged row's page table: ``blocks[b]`` is the arena page of its
    logical token block b (aliased prefix pages first, private pages
    appended as it grows). ``outstanding``: private pages reserved and not
    yet allocated (handed back at release); ``cap_tokens``: its worst-case
    context, which its pages never pass."""

    blocks: list
    outstanding: int
    cap_tokens: int
    plen: int


class _PagedGroup(_Rows):
    """The rows whose page tables span ``nb`` blocks: one decode shape
    (window nb * page). The KV lives in the session's arena, so moving a
    growing row to a wider group rewrites host state only. Free rows pin
    at the window's last slot with an all-scratch table."""

    def __init__(self, nb: int, cap: int, page: int):
        super().__init__(cap, nb * page - 1)
        self.nb = nb
        self.tables = torch.full((cap, nb), paged_kv.SCRATCH_PAGE, dtype=torch.int32)

    def grow(self) -> None:
        """Double the capacity (host state only)."""
        self.tables = torch.cat([self.tables, torch.full_like(self.tables,
                                                              paged_kv.SCRATCH_PAGE)])
        self._grow_rows()

    def free_row(self, r: int) -> None:
        super().free_row(r)
        self.tables[r] = paged_kv.SCRATCH_PAGE


def _gen_words(gen: Optional[torch.Generator]) -> list:
    """A row generator's state as little-endian uint32 words (``[]`` for a
    greedy row): the ``keys`` of an exported row."""
    if gen is None:
        return []
    raw = gen.get_state().numpy().tobytes()
    return [int.from_bytes(raw[i:i + 4], "little") for i in range(0, len(raw), 4)]


def _gen_from_words(words: list, device: torch.device) -> torch.Generator:
    """A generator on ``device`` continuing from the state ``words``
    (:func:`_gen_words`). Raises ValueError when the words are not a state
    of this device's generator."""
    gen = torch.Generator(device=device)
    want = gen.get_state().numel()
    raw = b"".join(int(w).to_bytes(4, "little") for w in words)
    if len(raw) != want:
        raise ValueError(
            f"the snapshot's sampler state is {len(raw)} bytes, a {device.type} generator's "
            f"state is {want}: a sampled row resumes only from a state of its own device's "
            "generator (the reference's two-word JAX keys cannot be restored)")
    try:
        gen.set_state(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    except RuntimeError as e:
        raise ValueError(f"the snapshot's sampler state cannot be restored: {e}") from None
    return gen


class BatchSession:
    """Slot-pool decode, the continuous-batching primitive: rows join
    (``admit``, or ``admit_begin`` and ``prefill_step``), step
    (``step_chunk``) and leave (``release``) independently between chunks.

    Three residency layouts share the class:

    * uniform (default): one slab [L, max_batch, S, kv, hd], handles are
      its row indices 0..max_batch-1. The slab is the engine's resident
      pool cache when no other open session uses it
      (``Engine._pool_cache``), so a later session of the same size replays
      the graphs captured for an earlier one.
    * bucketed (``bucket_kv``): power-of-two context buckets from
      ``min_bucket`` (default max(16, 2 * chunk)) up to S under the same
      modeled budget of max_batch * S token-slots. A row reserves its
      worst-case bucket (prompt + steps), is placed in the smallest slab
      covering its prompt plus one chunk, and migrates to a longer bucket
      before it outgrows its slab (an exact copy of its slab), so short
      requests stop paying for the full context and more rows fit. One
      decode shape per occupied (bucket, capacity); capacities double.
      Closed sessions leave their slabs on the engine (``Engine._keep_slabs``)
      for the next one, with the graphs captured on them.
    * paged (``kv_pages`` > 0 tokens a page, halved until it divides S):
      one arena of pages under the same budget (plus the scratch page 0),
      per-row page tables, and a radix prefix cache whose full prompt
      blocks later admissions alias (copy-on-write at the boundary block).
      Each step gathers a group's pages into a window, decodes it as a
      slab and scatters back the written page; growing a row appends a
      page and, past its window, regroups it (host state only). Only this
      layout exports a live row (``export_row``/``admit_from_export``).

    Every chunk runs each occupied decode shape whole through the engine's
    batched decode chunk. Free, finished and mid-prefill rows ride along
    pinned at the shape's last slot (greedy, feeding token 0), and a row's
    arithmetic never depends on its neighbours: at one capacity, a row
    admitted mid-flight emits, bit for bit, the tokens it would emit
    admitted at the start. The dequant-matmuls' split plans depend on the
    row count, so a row's bits equal the uniform pool's only while its
    shape's capacity equals the uniform pool's; a bucket slab or paged
    window gives the uniform slab's bits at equal capacity (the other
    kernels plan and write each row from its own position). Slot reuse
    needs no clearing: going live overwrites the row's attended window, a
    1-token prompt writes position 0 before attending it, and positions
    past a row's own are never attended.

    Chunked admission: ``admit_begin`` reserves a row and ``prefill_step``
    advances the oldest pending prompt by at most ``prefill_chunk`` tokens
    into its own solo staging cache, which lands in the row's slab (or
    pages) when the prompt is done. The pieces run the decode kernels where
    the monolithic prefill runs the prefill ones (K1/K3 take the GEMV at up
    to 8 rows, K4/K5 their decode launches at up to 16), so a chunked row's
    logits agree with a monolithic admission's within float rounding, not
    bit for bit; at one ``prefill_chunk`` a row's tokens do not depend on
    when its pieces ran. A warm paged admission prefills only the tail
    past its aliased prefix, from the cursor, so it agrees with a cold one
    within the same rounding."""

    def __init__(self, eng: Engine, max_batch: int, chunk: Optional[int] = None,
                 bucket_kv: bool = False, min_bucket: Optional[int] = None,
                 prefill_chunk: int = 0, kv_budget=None, kv_pages: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        chunk = eng.decode_chunk if chunk is None else chunk
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.eng = eng
        self.max_batch = max_batch
        self.chunk = chunk
        self.paged = kv_pages > 0
        self.bucket_kv = bool(bucket_kv) and not self.paged
        self.prefill_chunk = max(0, int(prefill_chunk))
        S = eng.cfg.seq_len
        if self.paged:
            # pages tile the context exactly: halve the size until it divides S
            page = max(1, int(kv_pages))
            while S % page:
                page //= 2
            self.page = page
        if self.bucket_kv:
            lo = int(min_bucket) if min_bucket else max(16, 2 * chunk)
            lo = max(2, min(lo, S))
            b = 1
            while b < lo:
                b *= 2
            ladder = []
            while b < S:
                ladder.append(b)
                b *= 2
            ladder.append(S)
            self.buckets = tuple(ladder)
        else:
            self.buckets = (S,)
        #: KV token-slots the session may hold: max_batch full-context rows
        self.budget_tokens = max_batch * S
        self._reserved_tokens = 0
        self._budget = kv_budget  # duck-typed lifecycle.KVBudget mirror
        self._pools: dict = {}  # ctx -> _BucketPool
        self._retired: list = []  # slabs grown out of, kept for the engine
        self._slots: dict = {}  # handle -> _SlotState
        self._where: dict = {}  # handle -> (pool or group, row)
        self._prefills: dict = {}  # handle -> _PendingPrefill, oldest first
        self._next_handle = 0
        self._closed = False
        self.migrations = 0  # rows moved to a longer bucket
        self.decode_ms = 0.0  # cumulative chunk wall time
        self.prefill_ms = 0.0  # cumulative admission-prefill wall time
        # paged-mode counters (0 in the slab modes)
        self.prefix_hits = 0  # admissions that aliased at least one cached page
        self.prefix_misses = 0  # admissions with nothing cached to alias
        self.prefix_tokens_matched = 0  # prompt tokens served from the cache
        self.cow_copies = 0  # boundary pages copied at admission
        self.prefix_evictions = 0  # cached pages evicted for allocations
        self.regroups = 0  # rows moved to a wider window (host state only)
        if self.paged:
            num_pages = self.budget_tokens // self.page + 1
            self._arena = eng._bucket_cache_init(num_pages, self.page)
            if kv_budget is not None and hasattr(kv_budget, "attach_pages"):
                # the serving accountant owns the free list and refcounts
                self._alloc = kv_budget.attach_pages(num_pages, self.page)
            else:
                self._alloc = paged_kv.PageAllocator(num_pages, self.page)
            self._radix = paged_kv.RadixPrefixCache(self.page)
            self._pgroups: dict = {}  # nb -> _PagedGroup
            self._rowpages: dict = {}  # handle -> _RowPages
            max_nb = S // self.page
            ladder, nb = [], 1
            while nb < max_nb:
                ladder.append(nb)
                nb *= 2
            ladder.append(max_nb)
            self._nb_ladder = tuple(ladder)
        elif not self.bucket_kv:
            self._pools[S] = _BucketPool(eng, S, max_batch, eng._pool_cache(self, max_batch))

    # -- introspection ----------------------------------------------------
    @property
    def cache(self) -> Optional[dict]:
        """The uniform pool's slab (None once closed, and in the bucketed
        and paged layouts, which have no single cache)."""
        if self._closed or self.bucket_kv or self.paged:
            return None
        return self._pools[self.eng.cfg.seq_len].cache

    @property
    def free_slots(self) -> list:
        """The uniform pool's free row indices. The bucketed and paged
        layouts admit by KV budget, not by row count (ask ``can_admit``):
        there, pseudo-indices, one per smallest admission (a bucket, a page)
        that still fits, so that ``if sess.free_slots:`` still means "can
        admit something"."""
        if self._closed:
            return []
        if self.paged:
            n = (self._alloc.free_count + self._alloc.evictable_count
                 - self._alloc.reserved_pages)
            return list(range(max(0, n)))
        if not self.bucket_kv:
            return [b for b, h in enumerate(self._pools[self.eng.cfg.seq_len].rows)
                    if h is None]
        n = (self.budget_tokens - self._reserved_tokens) // self.buckets[0]
        return list(range(max(0, n)))

    @property
    def occupied(self) -> list:
        """Admitted-and-not-released handles (done and mid-prefill rows
        included)."""
        return sorted(self._slots)

    @property
    def num_live(self) -> int:
        """Rows the next step_chunk will advance."""
        return sum(1 for st in self._slots.values() if not st.done and not st.prefilling)

    @property
    def pending_prefills(self) -> list:
        """Handles admitted with ``admit_begin`` whose prompts are still
        being consumed, oldest first."""
        return list(self._prefills)

    @property
    def reserved_tokens(self) -> int:
        """KV token-slots currently reserved against ``budget_tokens``."""
        return self._reserved_tokens

    @property
    def prefix_hit_rate(self) -> float:
        """The share of paged admissions that aliased at least one cached
        page (0.0 in the slab layouts and before any admission)."""
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    def page_stats(self) -> dict:
        """The paged layout's occupancy for /stats and /ready ({} in the
        slab layouts): the allocator's page counts, the radix tree's size,
        resident rows per window and the prefix-cache counters."""
        if not self.paged:
            return {}
        s = self._alloc.stats()
        s["radix_nodes"] = len(self._radix)
        s["rows_per_window"] = {
            str(nb * self.page): sum(1 for h in g.rows if h is not None)
            for nb, g in sorted(self._pgroups.items())}
        s["prefix_hits"] = self.prefix_hits
        s["prefix_misses"] = self.prefix_misses
        s["prefix_hit_rate"] = self.prefix_hit_rate
        s["prefix_tokens_matched"] = self.prefix_tokens_matched
        s["cow_copies"] = self.cow_copies
        s["prefix_evictions"] = self.prefix_evictions
        s["regroups"] = self.regroups
        return s

    def _state(self, slot: int) -> _SlotState:
        st = self._slots.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} is not occupied")
        return st

    def is_done(self, slot: int) -> bool:
        """True once the row hit its stop token, budget or the watchdog (it
        gets no more tokens; release() it to free the slot)."""
        return self._state(slot).done

    def finish_reason(self, slot: int) -> Optional[str]:
        """``"stop"``, ``"length"``, ``"error"`` (non-finite logits), or None
        while live / after cancel()."""
        return self._state(slot).finish

    def prefill_ms_of(self, slot: int) -> float:
        """Wall time this row's admission prefill has taken so far."""
        return self._state(slot).prefill_ms

    # -- capacity ---------------------------------------------------------
    def _need_ctx(self, prompt_len: int, steps: int) -> int:
        """Context slots the row can reach: its last write position + 1."""
        S = self.eng.cfg.seq_len
        return max(prompt_len, min(S, prompt_len - 1 + max(0, steps)))

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def can_admit(self, prompt_len: int, steps: int,
                  prompt_tokens: Optional[list] = None) -> bool:
        """True when the session's KV budget (and the external
        ``kv_budget``, if any) has room for this request's worst case:
        admission reserves the bucket (or the private pages) covering
        prompt + steps, so later growth never oversubscribes. A paged
        session reserves only the pages the radix cache cannot alias;
        ``prompt_tokens`` lets the check count the match (without it, no
        match is assumed)."""
        if self._closed:
            return False
        if self.paged:
            priv, full, _ = self._plan_pages(prompt_len, steps, prompt_tokens)
            # matched evictable pages would be pinned by this admission,
            # leaving the available pool: count them with the private need
            pinned = sum(1 for n in full if self._alloc.refcount(n.page) == 0)
            if not self._alloc.can_reserve(priv + pinned):
                return False
            return self._budget is None or self._budget.can_fit(priv * self.page)
        need = self._bucket_for(self._need_ctx(prompt_len, steps))
        if self._reserved_tokens + need > self.budget_tokens:
            return False
        return self._budget is None or self._budget.can_fit(need)

    # -- paged-mode internals ---------------------------------------------
    def _plan_pages(self, prompt_len: int, steps: int,
                    prompt_tokens: Optional[list]) -> tuple:
        """(private pages to reserve, aliasable full-prefix nodes, the COW
        boundary node or None) of a prospective paged admission. The full
        nodes hold blocks strictly below position prompt_len - 1, which the
        row never writes; a cached block that the prompt ends flush on is
        copied instead (its last slot is the pending token's write)."""
        need = paged_kv.pages_for(self._need_ctx(prompt_len, steps), self.page)
        if prompt_tokens is None:
            return need, [], None
        path = self._radix.match(prompt_tokens)
        nfull = min(len(path), (prompt_len - 1) // self.page)
        full = path[:nfull]
        cow = None
        if len(path) > nfull and (nfull + 1) * self.page == prompt_len:
            cow = path[nfull]
        return need - nfull, full, cow

    def _page_alloc(self, rp: _RowPages) -> int:
        """One private arena page for ``rp``'s row, evicting LRU cached
        prefix pages when the free list is dry (a reserved row always gets
        one: admission counted free + evictable pages)."""
        faults.fire("page_alloc")
        p = self._alloc.alloc()
        if p is None:
            freed = self._radix.evict(1, self._alloc)
            self.prefix_evictions += freed
            if self.eng._m_prefix_evictions is not None and freed:
                self.eng._m_prefix_evictions.inc(freed)
            p = self._alloc.alloc()
        if p is None:
            raise RuntimeError("paged KV pool exhausted despite the admission's reservation")
        rp.outstanding = max(0, rp.outstanding - 1)
        return p

    def _nb_for(self, blocks: int) -> int:
        for nb in self._nb_ladder:
            if nb >= blocks:
                return nb
        return self._nb_ladder[-1]

    def _alloc_prow(self, nb: int) -> tuple:
        """A free row in the ``nb``-block group, made or grown on demand."""
        g = self._pgroups.get(nb)
        if g is None:
            g = self._pgroups[nb] = _PagedGroup(nb, 1, self.page)
        for r in range(g.cap):
            if g.rows[r] is None:
                return g, r
        r = g.cap
        g.grow()
        return g, r

    def _sync_table(self, handle: int) -> None:
        """Copy the row's block list into its group's page table
        (scratch past its allocated tail)."""
        g, r = self._where[handle]
        blocks = self._rowpages[handle].blocks[:g.nb]
        g.tables[r] = paged_kv.SCRATCH_PAGE
        g.tables[r, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)

    def _regroup(self, handle: int, nb: int) -> None:
        """Move a growing row to a wider window group: host state only, the
        KV stays in its pages."""
        src, srow = self._where[handle]
        dst, drow = self._alloc_prow(nb)
        src.move_row(srow, dst, drow)
        self._where[handle] = (dst, drow)
        self.regroups += 1
        self._sync_table(handle)

    def _finish_pages(self, handle: int, prompt_tokens: list,
                      staging: Optional[dict] = None) -> None:
        """Complete a paged row's table through its pending token's block:
        allocate the private tail pages, scatter the staging cache's
        prefilled blocks into them in one call (``staging`` None where
        nothing was prefilled: every attended block is aliased or copied,
        or the prompt is one token), then publish every block the prompt
        fills into the radix tree."""
        rp = self._rowpages[handle]
        plen = len(prompt_tokens)
        total = (plen - 1) // self.page + 1
        pages, offs = [], []
        for b in range(len(rp.blocks), total):
            p = self._page_alloc(rp)
            if staging is not None and b * self.page < plen - 1:
                pages.append(p)
                offs.append(b * self.page)
            rp.blocks.append(p)
        if pages:
            self.eng._single_to_pages(self._arena, staging, pages, offs)
        # blocks (b + 1) * page <= plen - 1 hold prompt KV the row never
        # writes again: cacheable for later admissions
        nins = (plen - 1) // self.page
        for p in self._radix.insert(prompt_tokens, rp.blocks[:nins]):
            self._alloc.hold(p)
        self._sync_table(handle)

    def _alloc_row(self, ctx: int) -> tuple:
        """A free row in the ``ctx`` pool, made or grown on demand (the
        uniform pool is made full-size)."""
        pool = self._pools.get(ctx)
        if pool is None:
            pool = self._pools[ctx] = _BucketPool(self.eng, ctx, 1)
        for r in range(pool.cap):
            if pool.rows[r] is None:
                return pool, r
        r = pool.cap
        pool.grow(self.eng, self._retired)
        return pool, r

    # -- lifecycle --------------------------------------------------------
    def admit(self, prompt_tokens: list, steps: int, sampler: Optional[SamplerConfig] = None,
              stop_tokens: tuple = ()) -> int:
        """Prefill ``prompt_tokens`` into a free row and return its handle
        (the uniform pool's: the row index): ``admit_begin``, then one
        ``prefill_step`` over the whole prefix. The last prompt token stays
        pending for the row's first step, which samples with a generator
        freshly seeded from ``sampler.seed`` (``sampler`` defaults to the
        engine's). ``steps`` and ``stop_tokens`` are the row's own budget
        and stop set. Raises RuntimeError when the session is closed or
        nothing fits (ask ``can_admit``)."""
        handle = self.admit_begin(prompt_tokens, steps, sampler=sampler,
                                  stop_tokens=stop_tokens)
        while self._slots[handle].prefilling:
            self.prefill_step(handle, budget=len(prompt_tokens))
        return handle

    def admit_begin(self, prompt_tokens: list, steps: int,
                    sampler: Optional[SamplerConfig] = None, stop_tokens: tuple = ()) -> int:
        """Reserve a row for the prompt without prefilling it:
        ``prefill_step`` calls, interleaved with ``step_chunk``, consume
        the prompt, so resident rows keep decoding while a long prompt
        fills its staging cache. A 1-token prompt has nothing to prefill
        and goes live at once."""
        if self._closed:
            raise RuntimeError("batch session is closed")
        if not prompt_tokens:
            raise ValueError("admit needs a non-empty prompt")
        S = self.eng.cfg.seq_len
        if len(prompt_tokens) > S:
            raise ValueError(f"prompt of {len(prompt_tokens)} tokens exceeds seq_len {S}")
        if not self.can_admit(len(prompt_tokens), steps,
                              list(prompt_tokens) if self.paged else None):
            raise RuntimeError(
                f"no free slot (max_batch={self.max_batch}, KV budget "
                f"{self._reserved_tokens}/{self.budget_tokens} tokens); "
                "release a finished row first")
        faults.fire("admit")
        scfg = sampler if sampler is not None else self.eng.sampler_cfg
        if self.paged:
            return self._admit_begin_paged(list(prompt_tokens), steps, scfg,
                                           tuple(stop_tokens))
        plen = len(prompt_tokens)
        reserved = self._bucket_for(self._need_ctx(plen, steps))
        # placed small, for the prompt plus one chunk: migration (covered by
        # the reservation) grows the rows that live long
        place = self._bucket_for(min(reserved, plen + self.chunk))
        pool, row = self._alloc_row(place)
        handle = self._next_handle if self.bucket_kv else row
        self._next_handle += 1
        self._reserved_tokens += reserved
        if self._budget is not None:
            self._budget.reserve(reserved)
            self._budget.place(pool.ctx)
        room = S - (plen - 1)
        budget = min(room, steps)
        st = _SlotState(room=room, budget=budget, stop_tokens=tuple(stop_tokens),
                        reserved=reserved, done=budget <= 0,
                        finish="length" if budget <= 0 else None)
        self._slots[handle] = st
        self._where[handle] = (pool, row)
        pool.rows[row] = handle
        if budget <= 0:
            return handle  # never decodes; skip the prefill
        if plen == 1:
            self._go_live(handle, prompt_tokens, scfg)
        else:
            faults.fire("prefill")
            st.prefilling = True
            self._prefills[handle] = _PendingPrefill(list(prompt_tokens), scfg,
                                                     self.eng.new_cache())
        return handle

    def _admit_begin_paged(self, prompt_tokens: list, steps: int, scfg: SamplerConfig,
                           stop_tokens: tuple) -> int:
        """Paged admission: match the radix tree, alias the cached full
        blocks (all strictly below position plen - 1, which the row never
        writes), copy a boundary block, reserve only the private tail and
        prefill only what the cache cannot serve."""
        S = self.eng.cfg.seq_len
        plen = len(prompt_tokens)
        faults.fire("prefix_match")
        priv, full, cow = self._plan_pages(plen, steps, prompt_tokens)
        # pin the aliased prefix first: pinning takes evictable pages out of
        # the available pool, so the reservation check below is exact
        for n in full:
            self._alloc.ref(n.page)
        if not self._alloc.can_reserve(priv) or (
                self._budget is not None and not self._budget.can_fit(priv * self.page)):
            for n in full:
                self._alloc.unref(n.page)
            raise RuntimeError(
                f"no free KV pages ({self._alloc.free_count} free + "
                f"{self._alloc.evictable_count} evictable, "
                f"{self._alloc.reserved_pages} reserved, need {priv}); "
                "release a finished row first")
        self._alloc.reserve(priv)
        reserved = priv * self.page
        self._reserved_tokens += reserved
        if self._budget is not None:
            self._budget.reserve(reserved)
        need_ctx = self._need_ctx(plen, steps)
        rp = _RowPages([n.page for n in full], priv, need_ctx, plen)
        # a window for the prompt plus one chunk; regrouping widens it
        place = min(need_ctx, plen + self.chunk)
        g, row = self._alloc_prow(self._nb_for(paged_kv.pages_for(place, self.page)))
        handle = self._next_handle
        self._next_handle += 1
        room = S - (plen - 1)
        budget = min(room, steps)
        st = _SlotState(room=room, budget=budget, stop_tokens=stop_tokens, reserved=reserved,
                        done=budget <= 0, finish="length" if budget <= 0 else None)
        self._slots[handle] = st
        self._where[handle] = (g, row)
        self._rowpages[handle] = rp
        g.rows[row] = handle
        if budget <= 0:
            return handle  # never decodes; its pages stay pinned until release
        eng = self.eng
        cached = len(full) * self.page
        if cow is not None:
            p = self._page_alloc(rp)
            eng._page_copy(self._arena, p, cow.page)
            rp.blocks.append(p)
            cached = plen - 1
            self.cow_copies += 1
            if eng._m_cow is not None:
                eng._m_cow.inc()
        matched = min(cached, plen - 1)
        if matched > 0:
            self.prefix_hits += 1
            self.prefix_tokens_matched += matched
            if eng._m_prefix_hits is not None:
                eng._m_prefix_hits.inc()
                eng._m_prefix_tokens.inc(matched)
        else:
            self.prefix_misses += 1
            if eng._m_prefix_misses is not None:
                eng._m_prefix_misses.inc()
        if plen == 1 or cached >= plen - 1:
            # every attended prefix position is aliased or copied
            self._finish_pages(handle, prompt_tokens)
            self._go_live(handle, prompt_tokens, scfg)
            return handle
        faults.fire("prefill")
        st.prefilling = True
        staging = eng.new_cache()
        if full:  # the aliased prefix, preloaded in one gather
            eng._pages_to_single(staging, self._arena, [n.page for n in full], cached)
        pf = _PendingPrefill(prompt_tokens, scfg, staging, cursor=cached, scattered=cached)
        # publish-at-admit: the row's full prompt blocks hang in the radix
        # tree ready=False now, and each turns ready when the piece that
        # fills it lands, so a concurrent admission of the same prefix
        # aliases it while both rows are live
        nins = (plen - 1) // self.page
        for _ in range(len(rp.blocks), nins):
            rp.blocks.append(self._page_alloc(rp))
        pf.pub_nodes = self._radix.publish_pending(prompt_tokens, rp.blocks[:nins])
        for n in pf.pub_nodes:
            if n is not None:
                self._alloc.hold(n.page)
        self._prefills[handle] = pf
        return handle

    def prefill_step(self, handle: Optional[int] = None,
                     budget: Optional[int] = None) -> Optional[tuple]:
        """Advance ONE pending admission by up to ``budget`` prompt tokens
        (default: the session's ``prefill_chunk``; the whole remaining
        prefix when neither is set): one bucketed prefill forward into its
        staging cache, synced before returning. Returns (handle, finished);
        ``finished`` means the row just went live (its slab or pages are
        written; the next step_chunk decodes it). Returns None when nothing
        is pending. Without ``handle`` it takes the oldest pending
        admission."""
        if self._closed:
            raise RuntimeError("batch session is closed")
        if handle is None:
            handle = next((h for h in self._prefills if not self._slots[h].done), None)
            if handle is None:
                return None
        pf = self._prefills.get(handle)
        if pf is None:
            raise ValueError(f"slot {handle} has no pending prefill")
        st = self._slots[handle]
        prefix = pf.prompt[:-1]
        n = budget if budget is not None else self.prefill_chunk
        if n <= 0:
            n = len(prefix) - pf.cursor
        piece = prefix[pf.cursor:pf.cursor + n]
        faults.fire("prefill_chunk")
        t0 = time.perf_counter()
        if piece:  # empty when a fault stopped the last piece after its forward
            _, pf.cache = self.eng._prefill_piece(pf.cache, piece, pf.cursor)
        pf.cursor += len(piece)
        if self.paged:
            self._scatter_published(handle, pf)
        done = pf.cursor >= len(prefix)
        if done:  # land the staging cache in the row's slab or pages
            if self.paged:
                self._finish_pages(handle, pf.prompt, staging=pf.cache)
            else:
                pool, row = self._where[handle]
                Engine._batch_cache_insert(pool.cache, pf.cache, row)
        _sync(self.eng.device)
        dt = (time.perf_counter() - t0) * 1000.0
        self.prefill_ms += dt
        st.prefill_ms += dt
        if self.eng._m_prefill_chunk is not None:
            self.eng._m_prefill_chunk.observe(dt)
        if not done:
            return handle, False
        del self._prefills[handle]
        st.prefilling = False
        self._go_live(handle, pf.prompt, pf.scfg)
        if self.eng._m_prefill is not None:
            self.eng._m_prefill.observe(st.prefill_ms)
        return handle, True

    def _scatter_published(self, handle: int, pf: _PendingPrefill) -> None:
        """Land the staging cache's newly filled full blocks in their
        published pages (one call) and mark their nodes ready. Blocks whose
        node another row published first (``pub_nodes`` None) get their
        private copy all the same and never become cache."""
        rp = self._rowpages[handle]
        nins = (len(pf.prompt) - 1) // self.page
        done = min(pf.cursor // self.page, nins)
        start = pf.scattered // self.page
        if done <= start:
            return
        self.eng._single_to_pages(self._arena, pf.cache, rp.blocks[start:done],
                                  [b * self.page for b in range(start, done)])
        for b in range(start, done):
            n = pf.pub_nodes[b] if b < len(pf.pub_nodes) else None
            if n is not None:
                n.ready = True
        pf.scattered = done * self.page

    # -- migration (disaggregated serving) --------------------------------
    def export_row(self, handle: int, fire_fault: bool = True) -> dict:
        """Snapshot a live paged row for a sibling replica: its page
        payloads (f32 numpy in the arena's leaf order, ``k`` then ``v``,
        [L, n_blocks, page, kv, hd]), its geometry, and the decode state
        it carries across the next chunk boundary: pending token,
        position, budget and stop accounting, and in ``keys`` its
        generator's state as uint32 words (``[]`` for a greedy row), so a
        sampled row resumes from the exact draw it would have made.
        :meth:`admit_from_export` on a session of the same model, chunk and
        capacity continues the stream bit for bit. The row itself is
        untouched: the caller releases it once the transfer is
        acknowledged. ``fire_fault=False`` skips the ``kv_export`` seam
        (the checkpoint path fires its own)."""
        if not self.paged:
            raise RuntimeError("export_row needs a paged session (--kv-pages)")
        st = self._state(handle)
        if st.prefilling:
            raise RuntimeError(f"slot {handle} is still prefilling")
        if st.done:
            raise RuntimeError(f"slot {handle} already finished — nothing to migrate")
        if fire_fault:
            faults.fire("kv_export")
        g, r = self._where[handle]
        rp = self._rowpages[handle]
        idx = torch.tensor(rp.blocks, dtype=torch.long, device=self._arena["k"].device)
        leaves = [self._arena[n].index_select(1, idx).float().cpu().numpy()
                  for n in ("k", "v")]
        return {
            "page_tokens": self.page,
            "n_blocks": len(rp.blocks),
            "plen": rp.plen,
            "pos": int(g.pos[r]),
            "token": int(g.tokens[r]),
            "keys": _gen_words(g.gens[r]),
            "temp": float(g.temps[r]),
            "topp": float(g.topps[r]),
            "room": int(st.room),
            "budget": int(st.budget),
            "offered": int(st.offered),
            "emitted": int(st.emitted),
            "stop_tokens": list(st.stop_tokens),
            "leaves": leaves,
        }

    def admit_from_export(self, prompt_tokens: list, snap: dict) -> int:
        """Admit a row a sibling exported, warm: alias the full prompt
        blocks the local radix cache holds (their wire payload is dropped),
        import the rest into private pages in one call (cast to the arena's
        dtype: bf16 and f8 pages round-trip an f32 wire exactly), publish
        the prompt blocks and arm the row with the carried decode state.
        Raises RuntimeError when the pool cannot fit the row (the caller
        re-prefills), ValueError for a snapshot this session cannot resume,
        among them a sampled row whose ``keys`` are not a state of this
        device's generator."""
        if not self.paged:
            raise RuntimeError("admit_from_export needs a paged session (--kv-pages)")
        if self._closed:
            raise RuntimeError("batch session is closed")
        if int(snap["page_tokens"]) != self.page:
            raise ValueError(f"page size mismatch: wire {snap['page_tokens']} vs "
                             f"local {self.page}")
        plen = int(snap["plen"])
        if plen != len(prompt_tokens):
            raise ValueError(f"snapshot prompt length {plen} != {len(prompt_tokens)}")
        budget = int(snap["budget"])
        if int(snap["emitted"]) >= budget:
            raise ValueError("snapshot row already finished")
        temp = float(snap["temp"])
        gen = _gen_from_words(snap["keys"], self.eng.device) if temp > 0.0 else None
        faults.fire("kv_import")
        nblk = int(snap["n_blocks"])
        cap_tokens = max(plen, plen - 1 + budget)
        total = paged_kv.pages_for(cap_tokens, self.page)
        # alias what the local cache holds (blocks strictly below plen - 1);
        # everything else, the decoded tail included, imports privately
        path = self._radix.match(prompt_tokens)
        nfull = min(len(path), (plen - 1) // self.page, nblk)
        full = path[:nfull]
        priv = total - nfull
        for n in full:
            self._alloc.ref(n.page)
        if not self._alloc.can_reserve(priv) or (
                self._budget is not None and not self._budget.can_fit(priv * self.page)):
            for n in full:
                self._alloc.unref(n.page)
            raise RuntimeError(
                f"no free KV pages for imported row ({self._alloc.free_count} free + "
                f"{self._alloc.evictable_count} evictable, need {priv})")
        self._alloc.reserve(priv)
        reserved = priv * self.page
        self._reserved_tokens += reserved
        if self._budget is not None:
            self._budget.reserve(reserved)
        rp = _RowPages([n.page for n in full], priv, cap_tokens, plen)
        for _ in range(nfull, nblk):
            rp.blocks.append(self._page_alloc(rp))
        if nblk > nfull:
            self.eng._pages_import(self._arena, rp.blocks[nfull:nblk],
                                   [torch.from_numpy(np.ascontiguousarray(
                                       np.asarray(leaf, np.float32)[:, nfull:nblk]))
                                    for leaf in snap["leaves"]])
        g, row = self._alloc_prow(self._nb_for(max(1, len(rp.blocks))))
        handle = self._next_handle
        self._next_handle += 1
        self._slots[handle] = _SlotState(
            room=int(snap["room"]), budget=budget, stop_tokens=tuple(snap["stop_tokens"]),
            reserved=reserved, offered=int(snap["offered"]), emitted=int(snap["emitted"]))
        self._where[handle] = (g, row)
        self._rowpages[handle] = rp
        g.rows[row] = handle
        g.tokens[row] = int(snap["token"])
        g.pos[row] = int(snap["pos"])
        g.temps[row] = temp
        g.topps[row] = float(snap["topp"])
        g.gens[row] = gen
        self._sync_table(handle)
        # the imported prompt blocks are local KV now: later admissions of
        # the same prefix alias them
        nins = min((plen - 1) // self.page, len(rp.blocks))
        for p in self._radix.insert(prompt_tokens, rp.blocks[:nins]):
            self._alloc.hold(p)
        matched = nfull * self.page
        if matched > 0:
            self.prefix_hits += 1
            self.prefix_tokens_matched += matched
            if self.eng._m_prefix_hits is not None:
                self.eng._m_prefix_hits.inc()
                self.eng._m_prefix_tokens.inc(matched)
        else:
            self.prefix_misses += 1
            if self.eng._m_prefix_misses is not None:
                self.eng._m_prefix_misses.inc()
        return handle

    def _go_live(self, handle: int, prompt_tokens: list, scfg: SamplerConfig) -> None:
        """Arm the row's decode state: the pending last prompt token, its
        position and a freshly seeded generator."""
        pool, row = self._where[handle]
        pool.tokens[row] = int(prompt_tokens[-1])
        pool.pos[row] = len(prompt_tokens) - 1
        pool.temps[row] = float(scfg.temperature)
        pool.topps[row] = float(scfg.topp)
        pool.gens[row] = self.eng._row_generator(scfg.temperature, scfg.seed)

    def _migrate(self, handle: int) -> None:
        """Move a live row into a longer bucket before it outgrows its
        slab: an exact copy of its slab (its whole attended history) and
        its host decode state, so its stream goes on unchanged. Admission
        reserved the worst-case bucket, so migration never oversubscribes
        the budget."""
        src, srow = self._where[handle]
        S = self.eng.cfg.seq_len
        need = min(S, src.pos[srow] + self.chunk + 1)
        new_ctx = min(b for b in self.buckets if b > src.ctx and b >= need)
        dst, drow = self._alloc_row(new_ctx)
        self.eng._bucket_cache_migrate(dst.cache, src.cache, srow, drow)
        src.move_row(srow, dst, drow)
        self._where[handle] = (dst, drow)
        self.migrations += 1
        if self.eng._m_migrations is not None:
            self.eng._m_migrations.inc()
        if self._budget is not None:
            self._budget.migrate(src.ctx, dst.ctx)

    def step_chunk(self) -> dict:
        """Run ONE chunk over every occupied decode shape and return
        {handle: fresh tokens} for every live row, each truncated at the
        row's budget and (inclusively) at its first stop token — never empty
        unless the row's logits went non-finite (then it is done with
        finish reason ``"error"`` and gets nothing from the chunk; the other
        rows are untouched). Rows that finish are marked done and skip later
        chunks until released; mid-prefill rows are skipped until they go
        live. Returns {} without touching the device when nothing is live.

        Bucketed sessions step their pools smallest first, and migrate a
        live row that would outgrow its slab within the chunk just before
        its pool runs, so a row migrated this tick decodes this tick in its
        new pool. Paged sessions first extend every live row's pages ahead
        of the chunk's writes (regrouping a row that outgrew its window),
        then run each window group."""
        if self._closed:
            raise RuntimeError("batch session is closed")
        if not any(not st.done and not st.prefilling for st in self._slots.values()):
            return {}
        faults.fire("step_chunk")
        if self.paged:
            return self._step_chunk_paged()
        S = self.eng.cfg.seq_len
        fresh: dict = {}
        stepped: set = set()
        while True:
            todo = [c for c in sorted(self._pools) if c not in stepped]
            if not todo:
                break
            ctx = todo[0]
            stepped.add(ctx)
            pool = self._pools[ctx]
            if ctx < S:
                # rows that would outgrow the slab within the chunk move up;
                # rows finishing inside it stay (their writes fit)
                for h in [h for h in pool.rows if h is not None]:
                    st = self._slots[h]
                    if st.done or st.prefilling:
                        continue
                    useful = min(self.chunk, st.budget - st.emitted)
                    p = pool.pos[self._where[h][1]]
                    if ((useful >= self.chunk and p + self.chunk >= ctx)
                            or (useful < self.chunk and p + useful > ctx)):
                        self._migrate(h)
            self._run_chunk(pool, pool.cache, None, fresh)
        return fresh

    def _run_chunk(self, shape: _Rows, cache: dict, table: Optional[torch.Tensor],
                   fresh: dict) -> None:
        """One chunk of one decode shape (a bucket pool, or a paged group
        over the arena with its ``table``) if it has a live row, and its
        rows' accounting into ``fresh``."""
        live = shape.live(self._slots)
        if not live:
            return
        eng, dev = self.eng, self.eng.device
        t1 = time.perf_counter()
        chunk, ok, _ = eng._decode_chunk_batch(
            cache, torch.tensor(shape.tokens, dtype=torch.long, device=dev),
            torch.tensor(shape.pos, dtype=torch.int32, device=dev), self.chunk, shape.temps,
            shape.topps, shape.gens, shape.pos, eng._poison_rows(shape.cap), table=table)
        arr = chunk.cpu().tolist()  # the chunk's one host sync
        okh = ok.cpu().tolist()
        shape.tokens = [t if h is not None and h not in self._prefills else 0
                        for h, t in zip(shape.rows, arr[-1])]
        shape.pos = [min(p + self.chunk, shape.pin) for p in shape.pos]
        chunk_ms = (time.perf_counter() - t1) * 1000.0
        self.decode_ms += chunk_ms
        if eng._m_chunk is not None:
            eng._m_chunk.observe(chunk_ms)
        self._account_chunk(shape, live, arr, okh, fresh)

    def _account_chunk(self, shape: _Rows, live: list, arr: list, okh: list,
                       fresh: dict) -> None:
        """Per-row bookkeeping of one chunk's tokens, shared by the slab
        and paged layouts."""
        for r in live:
            h = shape.rows[r]
            st = self._slots[h]
            if not okh[r]:
                st.done, st.finish = True, "error"
                if self.eng._m_quarantine is not None:
                    self.eng._m_quarantine.inc()
                fresh[h] = []
                continue
            # a context-exhausted row pinned at its last slot: tokens past
            # its room are garbage
            keep = max(0, min(self.chunk, st.room - st.offered))
            st.offered += self.chunk
            toks = [row[r] for row in arr[:keep]]
            take = min(len(toks), st.budget - st.emitted)
            for j in range(take):
                if toks[j] in st.stop_tokens:
                    take = j + 1
                    break
            toks = toks[:take]
            st.emitted += len(toks)
            if st.emitted >= st.budget:
                st.done, st.finish = True, "length"
            elif st.stop_tokens and toks and toks[-1] in st.stop_tokens:
                st.done, st.finish = True, "stop"
            fresh[h] = toks

    def _step_chunk_paged(self) -> dict:
        """One chunk over every occupied window group: first every live
        row's table grows ahead of the chunk's writes (a page appended, a
        row past its window regrouped), so a live write target is always
        allocated; then one gathered-window chunk per group."""
        for h, st in list(self._slots.items()):
            if st.done or st.prefilling:
                continue
            g, r = self._where[h]
            rp = self._rowpages[h]
            needed = min(g.pos[r] + self.chunk + 1, rp.cap_tokens)
            while len(rp.blocks) < paged_kv.pages_for(needed, self.page):
                rp.blocks.append(self._page_alloc(rp))
            nb = self._nb_for(len(rp.blocks))
            if nb > g.nb:
                self._regroup(h, nb)
            else:
                self._sync_table(h)
        fresh: dict = {}
        for nb in sorted(self._pgroups):
            g = self._pgroups[nb]
            self._run_chunk(g, self._arena, g.tables, fresh)
        return fresh

    def _drop_prefill(self, slot: int) -> Optional[_PendingPrefill]:
        """Forget ``slot``'s pending prefill, retracting the radix nodes it
        published and never filled (their pages hold garbage)."""
        pf = self._prefills.pop(slot, None)
        if pf is not None and self.paged:
            self._radix.unpublish([n for n in pf.pub_nodes if n is not None and not n.ready],
                                  self._alloc)
        return pf

    def cancel(self, slot: int) -> None:
        """Stop decoding the row now: it is marked done and rides along
        pinned until ``release()``. A mid-prefill admission's staging cache
        is dropped at once. Idempotent."""
        st = self._state(slot)
        st.done = True
        if self._drop_prefill(slot) is not None:
            st.prefilling = False

    def release(self, slot: int) -> None:
        """Free the row for the next admission and return its reservation
        to the budget. The slab is not cleared (see the class docstring);
        the row re-pins at its shape's last slot. A paged row's pages lose
        its hold: published ones stay as evictable cache, the others go
        back to the free list."""
        st = self._slots.pop(slot, None)
        if st is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._drop_prefill(slot)
        pool, row = self._where.pop(slot)
        pool.free_row(row)
        if self.paged:
            rp = self._rowpages.pop(slot)
            for p in rp.blocks:
                self._alloc.unref(p)
            self._alloc.unreserve(rp.outstanding)
        self._reserved_tokens -= st.reserved
        if self._budget is not None:
            self._budget.release(st.reserved)
            if not self.paged:
                self._budget.unplace(pool.ctx)

    def close(self) -> None:
        """Drop every row and pending prefill and hand every reservation
        back to the external budget. The uniform slab stays the engine's
        resident pool cache, bucket slabs go to the engine for the next
        session (bounded by the budget), and a paged session's pages go
        back to its allocator before its arena is freed. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._budget is not None:
            for st in self._slots.values():
                self._budget.release(st.reserved)
            if not self.paged:
                for pool, _ in self._where.values():
                    self._budget.unplace(pool.ctx)
        if self.bucket_kv:
            self.eng._keep_slabs(self._retired + [p.cache for p in self._pools.values()],
                                 self.budget_tokens)
        if self.paged:
            # the allocator may be the serving accountant's, whose gauges
            # must not report pages of a freed arena
            for rp in self._rowpages.values():
                for p in rp.blocks:
                    self._alloc.unref(p)
                self._alloc.unreserve(rp.outstanding)
            self._radix.evict(self._alloc.num_pages, self._alloc)
            self.eng.free_cache(self._arena)
            self._arena = None
            self._pgroups = {}
            self._rowpages = {}
        self._pools = {}
        self._retired = []
        self._slots = {}
        self._where = {}
        self._prefills = {}
        self._reserved_tokens = 0


def accept(draft: list, picks: list, room: int, stop_tokens) -> tuple:
    """One sequence's verify rule: (m, emitted). m counts the leading drafts
    the model picked itself (``picks[i]`` is its pick after draft[:i]); the
    step emits those and the model's next pick, at most ``room`` tokens,
    cut after the first stop token."""
    m = 0
    while m < len(draft) and draft[m] == picks[m]:
        m += 1
    out = picks[:m + 1][:room]
    for j, t in enumerate(out):
        if t in stop_tokens:
            return m, out[:j + 1]
    return m, out


def verify_sampled(logits: torch.Tensor, scfg: SamplerConfig, gen: torch.Generator) -> tuple:
    """Sample every row of ``logits [L, vocab]`` as ``generate`` samples its
    next L tokens: row i takes the i-th draw of Gumbel noise from ``gen``.
    Returns (picks, states): the int64 [L] device picks, and ``gen``'s state
    after each draw, so the caller can put the generator back to the state
    after the last token it keeps. Nothing waits for the device."""
    L = logits.shape[0]
    noise, states = [], []
    for _ in range(L):
        noise.append(gumbel_noise(logits.shape[-1], gen, logits.device))
        states.append(gen.get_state())
    picks = sample_rows(logits, [scfg.temperature] * L, [scfg.topp] * L,
                        gumbel=torch.stack(noise))
    return picks, states


class _NgramIndex:
    """Incremental n-gram -> latest-start-position index over the consumed
    context: O(1) amortized per appended token and per draft lookup (a
    backward scan would cost O(context) of host time per verify step)."""

    def __init__(self, ngram: int):
        self.ngram = ngram
        self.ctx: list = []
        self._pos: dict = {}
        self._prev: dict = {}  # the occurrence before the latest, per n-gram

    def extend(self, tokens) -> None:
        for t in tokens:
            self.ctx.append(t)
            if len(self.ctx) >= self.ngram:
                key = tuple(self.ctx[-self.ngram:])
                if key in self._pos:
                    self._prev[key] = self._pos[key]
                self._pos[key] = len(self.ctx) - self.ngram

    def draft(self, pending: int, k: int) -> list:
        """Up to k proposed continuations of context + [pending]: what
        followed the most recent earlier occurrence of its trailing n-gram.
        If the latest occurrence ends flush at the end of the context (an
        empty continuation, the norm on runs of one repeated token), the one
        before it is used, whose continuation is never empty."""
        if k <= 0 or len(self.ctx) + 1 <= self.ngram:
            return []
        tail = tuple((self.ctx + [pending])[-self.ngram:])
        for j in (self._pos.get(tail), self._prev.get(tail)):
            if j is not None:
                cont = self.ctx[j + self.ngram: j + self.ngram + k]
                if cont:
                    return list(cont)
        return []
