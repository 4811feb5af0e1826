"""Decode engine: bucketed prefill, then decode steps with a resident KV
cache, per-token timing and sampling on the device.

The port of the JAX package's single-device ``Engine`` (prefill, generate,
Session, TokenStats and the numeric-health watchdog), its batched decode
(``generate_batch``), the uniform continuous-batching ``BatchSession`` and
prompt-lookup speculative decoding, solo (``generate_spec``) and batched
(``generate_batch_spec``).
PyTorch runs eagerly, so where the JAX package compiles a decode step and
fuses N of them into one program, the port captures one decode step in a
CUDA graph (``runtime.graphs.StepGraph``) and replays it once per step:
solo (``generate``, ``generate_fused``) and batched (``generate_batch``,
``BatchSession``). Each replay feeds the next on the device, and the host
waits only when it reads the sampled tokens — once per token in
``generate``, which yields each one, and once per chunk of up to
``decode_chunk`` steps in ``generate_fused`` and batched decode.
``Engine(cuda_graphs=False)`` keeps the eager steps (solo ``forward`` with a
host position) for comparison; on the CPU the graph's body runs eagerly.
Prefill and the speculative verify steps are eager. The KV cache is updated
in place, where the JAX programs donate it.

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

import torch

from dllama_tpu_torch import resolve_device
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.runtime.graphs import GraphCache, StepGraph
from dllama_tpu_torch.runtime.sampler import (
    SamplerConfig, gumbel_noise, row_seed, sample_dynamic, sample_rows,
)

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
#: decode steps per host sync in generate_fused and batched decode (one read
#: of the chunk's tokens)
DECODE_CHUNK = 64


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
                 cache_dtype=torch.float32, device=None, decode_chunk: int = DECODE_CHUNK,
                 cuda_graphs: bool = True):
        """Quantized projections that share an input are fused
        (``llama.fuse_qkv_ffn``) if they are not already. Every solo decode
        step checks ``isfinite(logits)`` and ``generate`` raises
        :class:`NumericHealthError` on a non-finite value (``generate_fused``
        once per chunk); batched decode keeps a per-row flag instead
        (``row_health``). ``decode_chunk``: decode steps between host syncs
        in ``generate_fused`` and batched decode. ``cuda_graphs``: decode
        steps replay captured graphs (:class:`StepGraph`, on the CPU their
        body runs eagerly); False keeps the eager steps."""
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
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
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.row_health: list = []
        self.final_session: Optional[Session] = None

    def new_cache(self) -> dict:
        return llama.init_cache(self.cfg, self.cache_dtype, self.device)

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
        return llama.init_batch_cache(self.cfg, batch, self.cache_dtype, self.device)

    @staticmethod
    def _batch_cache_insert(cache: dict, single: dict, b: int) -> None:
        """Copy a single-sequence cache [L, S, kv, hd] into row ``b`` of a
        batch cache [L, B, S, kv, hd], in place."""
        for n in ("k", "v"):
            cache[n][:, b].copy_(single[n])

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

    def _sampling(self, sampler: Optional[SamplerConfig]) -> tuple:
        """(settings, generator) of one call: ``sampler`` with a fresh
        generator seeded from ``sampler.seed``, else the engine's own."""
        if sampler is None:
            return self.sampler_cfg, self.generator
        return sampler, torch.Generator(device=self.device).manual_seed(sampler.seed)

    def _decode_step(self, cache: dict, token: torch.Tensor, pos: int, scfg: SamplerConfig,
                     gen: torch.Generator) -> tuple:
        """Enqueue one decode step; returns (next token, finite flag), both
        device tensors the host has not waited for yet."""
        logits, _ = llama.forward(self.cfg, self.params, self.rope,
                                  token.reshape(1), cache, pos)
        nxt = sample_dynamic(logits[0], scfg.temperature, scfg.topp, gen)
        return nxt, torch.isfinite(logits).all()

    def step_graph(self, cache: dict, sampled: bool, ring: int) -> StepGraph:
        """The captured decode step over ``cache`` (made on first use): the
        solo step (``llama.forward_decode``) for a cache [L, S, kv, hd], the
        batched one at the grid bound seq_len for [L, B, S, kv, hd].
        ``sampled``: the graph samples (any mix of sampled and greedy rows;
        else every row is greedy); ``ring``: the most steps a run takes."""
        cfg, params, rope, S = self.cfg, self.params, self.rope, self.cfg.seq_len
        solo = cache["k"].dim() == 4

        def step(c, tok, pos):
            if solo:
                return llama.forward_decode(cfg, params, rope, tok, c, pos)[0]
            return llama.forward_batched(cfg, params, rope, tok, c, pos, S)[0]

        def make() -> StepGraph:
            return StepGraph(step, cache, S, sampled, ring)

        # the storage and shape (B) of the cache, greedy or sampled, the ring
        key = (cache["v"].data_ptr(), tuple(cache["k"].shape), sampled, ring)
        return self.graphs.get(cache["k"], key, make)

    def _decode_chunk_solo(self, cache: dict, token: torch.Tensor, pos: int, n: int,
                           scfg: SamplerConfig, gen: torch.Generator) -> tuple:
        """``n`` solo decode steps from ``token`` (a device tensor) at host
        ``pos`` with no host sync: one graph replay each (eager steps with
        ``cuda_graphs=False``). Returns the sampled tokens int64 [n] and the
        finite flag [1], device tensors."""
        if self.cuda_graphs:
            g = self.step_graph(cache, scfg.temperature > 0.0, self.decode_chunk)
            g.load(token, pos, [scfg.temperature], [scfg.topp])
            toks, ok = g.run(n, [gen])
            return toks[:, 0], ok
        out, ok = [], torch.ones(1, dtype=torch.bool, device=self.device)
        for i in range(n):
            token, finite = self._decode_step(cache, token, pos + i, scfg, gen)
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
        if len(prompt_tokens) > 1:
            last_logits, cache = self.prefill(cache, prompt_tokens, pos)
            token = sample_dynamic(last_logits, scfg.temperature, scfg.topp, gen)
        else:
            token = torch.tensor(prompt_tokens[0], dtype=torch.long, device=self.device)
        _sync(self.device)
        self.prefill_ms = (time.perf_counter() - t0) * 1000.0

        tok_int: Optional[int] = None
        if len(prompt_tokens) > 1:
            pos += len(prompt_tokens)
            if steps <= 0:
                self.final_session = self._session(cache, pos, pending_token=None)
                return
            tok_int = int(token)
            self.final_session = self._session(cache, pos, pending_token=tok_int)
            yield tok_int, TokenStats(self.prefill_ms, self.prefill_ms)
            steps -= 1
            if tok_int in stop_tokens:
                return
        for _ in range(max(steps, 0)):
            t1 = time.perf_counter()
            if self.cuda_graphs:
                toks, ok = self._decode_chunk_solo(cache, token, pos, 1, scfg, gen)
                token = toks[0]
            else:
                token, ok = self._decode_step(cache, token, pos, scfg, gen)
            # the step returns once its kernels are enqueued: the wait from
            # here to the result is device execution ("inference")
            t2 = time.perf_counter()
            _sync(self.device)
            t3 = time.perf_counter()
            if not bool(ok.all()):
                raise NumericHealthError(f"at decode position {pos}")
            tok_int = int(token)
            t4 = time.perf_counter()
            pos += 1
            self.final_session = self._session(cache, pos, pending_token=tok_int)
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
        if first and on_chunk is not None:
            on_chunk(first)

        t1 = time.perf_counter()
        toks: list = []
        remaining = steps
        while remaining > 0:
            n = min(self.decode_chunk, remaining)
            chunk, ok = self._decode_chunk_solo(cache, token, pos, n, scfg, gen)
            *got, finite = torch.cat([chunk, ok.long()]).tolist()  # the chunk's one sync
            if not finite:
                raise NumericHealthError(f"in fused decode chunk starting at position {pos}")
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
                            host_pos: list) -> tuple:
        """``n`` batched decode steps with no host sync: tokens, positions
        and the per-row finite flags stay on the device. Row b samples with
        its own settings and generator; a row whose context fills pins at
        slot seq_len - 1 (its later tokens are garbage the caller drops).
        One graph replay per step, the graph's grid bound seq_len (a row's
        bits do not depend on the bound); eager with ``cuda_graphs=False``,
        where ``host_pos``, the host's mirror of ``pos``, bounds flash
        decode's grid for the whole chunk. Returns (tokens [n, B], ok [B],
        the positions after the chunk)."""
        if self.cuda_graphs:
            g = self.step_graph(cache, any(t > 0.0 for t in temps), max(n, self.decode_chunk))
            g.load(tokens, pos, temps, topps)
            toks, ok = g.run(n, generators)
            return toks.clone(), ok.clone(), g.pos.clone()
        S = self.cfg.seq_len
        bound = min(max(host_pos) + n, S)
        ok = torch.ones(tokens.shape, dtype=torch.bool, device=self.device)
        out = []
        for _ in range(n):
            logits, _ = llama.forward_batched(self.cfg, self.params, self.rope, tokens, cache,
                                              pos, bound)
            ok &= torch.isfinite(logits).all(dim=-1)
            tokens = sample_rows(logits, temps, topps, generators)
            out.append(tokens)
            pos = torch.clamp(pos + 1, max=S - 1)
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
            n = min(self.decode_chunk, remaining)
            chunk, ok, pos = self._decode_chunk_batch(cache, tokens, pos, n, temps, topps, gens,
                                                      host_pos)
            arr = chunk.cpu().tolist()  # the chunk's one host sync
            okh = ok.cpu().tolist()
            tokens = chunk[-1]
            host_pos = [min(p + n, S - 1) for p in host_pos]
            fresh: list = [[] for _ in range(B)]
            for b in range(B):
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
        return out, {"verify_steps": verify_steps, "accepted_drafts": accepted,
                     "emitted": sum(len(r) for r in out)}

    def batch_session(self, max_batch: int, chunk: Optional[int] = None,
                      bucket_kv: bool = False, prefill_chunk: int = 0,
                      kv_pages: int = 0) -> "BatchSession":
        """Open a slot-pool decode session (continuous batching) over one
        resident batch cache [L, max_batch, S, kv, hd]: rows are admitted,
        stepped and released independently between chunks of ``chunk``
        steps (default ``decode_chunk``). Only the uniform mode is ported:
        ``bucket_kv``, ``prefill_chunk`` and ``kv_pages`` raise
        NotImplementedError."""
        return BatchSession(self, max_batch, chunk, bucket_kv=bucket_kv,
                            prefill_chunk=prefill_chunk, kv_pages=kv_pages)


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one admitted BatchSession row."""

    room: int  # feeds the row's remaining context allows (S - admit pos)
    budget: int  # min(room, the caller's step budget)
    stop_tokens: tuple
    offered: int = 0  # tokens the chunks have offered this row so far
    done: bool = False  # budget/stop reached; pinned in place until release()
    emitted: int = 0  # tokens actually kept (after budget/stop truncation)
    finish: Optional[str] = None  # "stop" | "length" | "error" once done
    prefill_ms: float = 0.0  # admission-prefill wall time


class BatchSession:
    """Slot-pool decode over one resident batch cache [L, max_batch, S, kv,
    hd] — the continuous-batching primitive, uniform mode. Rows join
    (``admit``), step (``step_chunk``) and leave (``release``) independently
    between chunks; handles are slot indices 0..max_batch-1.

    Every chunk runs the whole fixed-size pool through the engine's batched
    decode chunk. Free and finished rows ride along pinned at slot S - 1
    (free rows greedy, feeding token 0), so the batch size never changes
    and a row's arithmetic never depends on who else is in the pool: a row
    admitted mid-flight emits, bit for bit, the tokens it would emit
    admitted at the start. Slot reuse needs no clearing: admission
    overwrites the row's whole slab with its prefilled cache (a 1-token
    prompt writes position 0 before attending it), and positions past a
    row's own pos are never attended.

    Not ported yet (ROADMAP Queue 1, items 3b and 4): bucketed slot pools
    (``bucket_kv``), chunked admission (``prefill_chunk``,
    ``admit_begin``/``prefill_step``), paged KV (``kv_pages``), the
    ``kv_budget`` accountant and row export/import."""

    def __init__(self, eng: Engine, max_batch: int, chunk: Optional[int] = None,
                 bucket_kv: bool = False, prefill_chunk: int = 0, kv_pages: int = 0):
        if bucket_kv or prefill_chunk > 0:
            raise NotImplementedError(
                "bucketed slot pools and chunked admission are not ported yet "
                "(ROADMAP Queue 1, item 3b): use the uniform session")
        if kv_pages > 0:
            raise NotImplementedError(
                "paged KV is not ported yet (ROADMAP Queue 1, item 4): use the uniform "
                "session")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        chunk = eng.decode_chunk if chunk is None else chunk
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.eng = eng
        self.max_batch = max_batch
        self.chunk = chunk
        self._cache: Optional[dict] = eng._batch_cache_init(max_batch)
        S = eng.cfg.seq_len
        # per-row decode state, host mirrors shipped to the device per chunk;
        # free rows pin at the last slot, greedy, feeding token 0
        self._tokens = [0] * max_batch
        self._pos = [S - 1] * max_batch
        self._temps = [0.0] * max_batch
        self._topps = [1.0] * max_batch
        self._gens: list = [None] * max_batch
        self._slots: dict = {}  # handle (= row) -> _SlotState
        self._closed = False
        self.decode_ms = 0.0  # cumulative chunk wall time
        self.prefill_ms = 0.0  # cumulative admission-prefill wall time

    # -- introspection ----------------------------------------------------
    @property
    def cache(self) -> Optional[dict]:
        """The resident batch cache (None once closed)."""
        return self._cache

    @property
    def free_slots(self) -> list:
        """Row indices ``admit`` can take right now."""
        if self._closed:
            return []
        return [b for b in range(self.max_batch) if b not in self._slots]

    @property
    def occupied(self) -> list:
        """Admitted-and-not-released handles (done rows included)."""
        return sorted(self._slots)

    @property
    def num_live(self) -> int:
        """Rows the next step_chunk will advance."""
        return sum(1 for st in self._slots.values() if not st.done)

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
        return self._state(slot).prefill_ms

    def can_admit(self, prompt_len: int, steps: int) -> bool:
        """True when a slot is free (uniform mode: every row reserves the
        full context)."""
        return bool(self.free_slots)

    # -- lifecycle --------------------------------------------------------
    def admit(self, prompt_tokens: list, steps: int, sampler: Optional[SamplerConfig] = None,
              stop_tokens: tuple = ()) -> int:
        """Prefill ``prompt_tokens`` into the lowest free row and return its
        handle (the slot index). The prompt's prefix runs through the
        engine's bucketed prefill into a fresh single cache, copied into the
        row's slab; the last prompt token stays pending for the row's first
        step, which samples with a generator freshly seeded from
        ``sampler.seed`` (``sampler`` defaults to the engine's). ``steps`` and
        ``stop_tokens`` are the row's own budget and stop set. Raises
        RuntimeError when the session is closed or full."""
        if self._closed:
            raise RuntimeError("batch session is closed")
        if not prompt_tokens:
            raise ValueError("admit needs a non-empty prompt")
        S = self.eng.cfg.seq_len
        if len(prompt_tokens) > S:
            raise ValueError(f"prompt of {len(prompt_tokens)} tokens exceeds seq_len {S}")
        free = self.free_slots
        if not free:
            raise RuntimeError(f"no free slot (max_batch={self.max_batch}); "
                               "release a finished row first")
        scfg = sampler if sampler is not None else self.eng.sampler_cfg
        row = free[0]
        plen = len(prompt_tokens)
        room = S - (plen - 1)
        budget = min(room, steps)
        st = _SlotState(room=room, budget=budget, stop_tokens=tuple(stop_tokens),
                        done=budget <= 0, finish="length" if budget <= 0 else None)
        self._slots[row] = st
        if budget <= 0:
            return row  # never decodes; skip the prefill
        if plen > 1:
            t0 = time.perf_counter()
            _, single = self.eng._prefill_piece(self.eng.new_cache(), list(prompt_tokens[:-1]),
                                                0)
            Engine._batch_cache_insert(self._cache, single, row)
            _sync(self.eng.device)
            st.prefill_ms = (time.perf_counter() - t0) * 1000.0
            self.prefill_ms += st.prefill_ms
        self._tokens[row] = int(prompt_tokens[-1])
        self._pos[row] = plen - 1
        self._temps[row] = float(scfg.temperature)
        self._topps[row] = float(scfg.topp)
        self._gens[row] = self.eng._row_generator(scfg.temperature, scfg.seed)
        return row

    def step_chunk(self) -> dict:
        """Run ONE chunk over the whole pool and return {handle: fresh
        tokens} for every live row, each truncated at the row's budget and
        (inclusively) at its first stop token — never empty unless the row's
        logits went non-finite (then it is done with finish reason
        ``"error"`` and gets nothing from the chunk). Rows that finish are
        marked done and skip later chunks until released. Returns {} without
        touching the device when nothing is live."""
        if self._closed:
            raise RuntimeError("batch session is closed")
        live = [r for r, st in sorted(self._slots.items()) if not st.done]
        if not live:
            return {}
        eng, S, dev = self.eng, self.eng.cfg.seq_len, self.eng.device
        t1 = time.perf_counter()
        chunk, ok, _ = eng._decode_chunk_batch(
            self._cache, torch.tensor(self._tokens, dtype=torch.long, device=dev),
            torch.tensor(self._pos, dtype=torch.int32, device=dev), self.chunk, self._temps,
            self._topps, self._gens, self._pos)
        arr = chunk.cpu().tolist()  # the chunk's one host sync
        okh = ok.cpu().tolist()
        self._tokens = [t if r in self._slots else 0 for r, t in enumerate(arr[-1])]
        self._pos = [min(p + self.chunk, S - 1) for p in self._pos]
        self.decode_ms += (time.perf_counter() - t1) * 1000.0
        fresh: dict = {}
        for r in live:
            st = self._slots[r]
            if not okh[r]:
                st.done, st.finish = True, "error"
                fresh[r] = []
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
            fresh[r] = toks
        return fresh

    def cancel(self, slot: int) -> None:
        """Stop decoding the row now: it is marked done and rides along
        pinned until ``release()``. Idempotent."""
        self._state(slot).done = True

    def release(self, slot: int) -> None:
        """Free the row for the next admission. The slab is not cleared (see
        the class docstring); the row re-pins at the last slot, greedy,
        feeding token 0."""
        if self._slots.pop(slot, None) is None:
            raise ValueError(f"slot {slot} is not occupied")
        self._tokens[slot] = 0
        self._pos[slot] = self.eng.cfg.seq_len - 1
        self._temps[slot], self._topps[slot], self._gens[slot] = 0.0, 1.0, None

    def close(self) -> None:
        """Drop the resident cache and every row. Idempotent."""
        self._closed = True
        self._cache = None
        self._slots = {}


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
