"""Captured decode steps: one CUDA graph replay per decode step.

PyTorch runs eagerly, so an eager decode step of the Llama-3-8B shape
enqueues ~2,000 launches from Python, and the card idles while the host
issues them. A CUDA graph records a step's launches once and replays them
with one call: the port's counterpart of the reference's jitted
``_decode_step`` and of ``_decode_loop``, N steps fused into one program
with sampling on the device (``dllama_tpu/runtime/generate.py:510-549``).

:class:`StepGraph` is one decode step of B sequences over one cache, its
inputs and outputs in static device tensors, so that each replay feeds the
next with no host work: the step samples its token into ``tokens``, adds 1
to ``pos`` and writes the token into a ring the host reads once per run. On
a CUDA device the step is warmed up once on a side stream and captured; on
the CPU the same body runs eagerly (the CPU tests reach it so). A capture
that fails raises: nothing falls back to eager.

:class:`GraphCache` keeps an engine's graphs. A graph holds its cache's
pointers, so it is keyed by the cache's storage and dropped when that cache
is freed.
"""

from __future__ import annotations

import time
import weakref

import torch

from dllama_tpu_torch import kernels
from dllama_tpu_torch.runtime.sampler import RowSampling, sample_prepared


class StepGraph:
    """One decode step over ``cache``: ``step(cache, tokens, pos) -> logits
    [B, vocab]`` (``llama.forward_decode`` on a solo cache [L, S, kv, hd],
    B = 1; ``llama.forward_batched`` at the grid bound ``seq_len`` on a
    slot slab [L, B, ctx, kv, hd], where ``seq_len`` is the slab's context
    ctx; a paged step over a page arena, ``step(arena, tokens, pos,
    table)``, with ``seq_len`` its window), then the watchdog and the
    sampler, over static tensors:

    * ``tokens`` int64 [B]: the token each row feeds; a step writes the
      token it sampled back, so the next step feeds it.
    * ``pos`` int32 [B]: each row's position; a step adds 1, clamped at
      ``seq_len - 1`` (a row whose context fills pins at its last slot, as
      the eager batched chunk pins it).
    * ``ok`` bool [B]: each row's logits were finite in every step of the
      current :meth:`run`.
    * ``ring`` int64 [ring_len, B]: step i of a run writes its tokens to row
      i (a device index, reset by :meth:`run`).
    * ``poison`` bool [B]: the ``logits:nan`` fault seam. A flagged row's
      logits are set to NaN before the watchdog reads them, in every step
      of a run; :meth:`load` sets the flags. Each replay reads the tensor,
      so a graph captured clean runs poisoned once a row is flagged.
    * ``logits``: the last step's logits (CUDA: the capture's output).
    * ``table`` int64 [B, nb] (a paged step only, ``table_blocks`` = nb):
      each row's page table, refilled by :meth:`load`. It is all page 0
      (the scratch page) while the graph is warmed up and captured, so
      making the graph writes no live or cached page.

    A greedy graph (``sampled`` False) takes each row's argmax. A sampled one
    runs :func:`sample_prepared` over every row, its settings
    (``sampling``) refilled by :meth:`load`, so one graph serves any mix of
    sampled and greedy rows. Each row draws its noise from a generator the
    graph owns, registered with the capture; a run takes each sampled row's
    state (seed and offset) from the caller's generator and gives it back
    after, so the draws are the ones the caller's generator would make.

    The warm-up step runs with every row at ``seq_len - 1``: it writes cache
    slot ``seq_len - 1``, which every step at that position writes again
    before it attends it, so making a graph changes nothing a later step
    reads. The graph holds its cache weakly (a captured graph holds its
    pointers): a run after the cache was freed raises. ``batch``: the row
    count where the cache's shape does not give it (a paged step)."""

    def __init__(self, step, cache: dict, seq_len: int, sampled: bool, ring_len: int,
                 batch: int | None = None, table_blocks: int = 0):
        k = cache["k"]
        device = k.device
        if batch is None:
            batch = 1 if k.dim() == 4 else k.shape[1]
        self.device, self.seq_len = device, seq_len
        self.table = (torch.zeros((batch, table_blocks), dtype=torch.long, device=device)
                      if table_blocks else None)
        self._cache = {n: weakref.ref(t) for n, t in cache.items()}
        self.tokens = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.full((batch,), seq_len - 1, dtype=torch.int32, device=device)
        self.ok = torch.ones(batch, dtype=torch.bool, device=device)
        self.ring = torch.zeros((ring_len, batch), dtype=torch.long, device=device)
        self.idx = torch.zeros(1, dtype=torch.long, device=device)
        self.poison = torch.zeros(batch, dtype=torch.bool, device=device)
        self._poisoned: tuple = ()  # the host's mirror of ``poison``'s True rows
        self.sampling = (RowSampling.prepare([1.0] * batch, [1.0] * batch, device)
                         if sampled else None)
        self.generators = [torch.Generator(device=device) for _ in range(batch if sampled else 0)]
        self._rows: tuple = ()  # the sampled rows of the loaded settings
        self.graph = None
        self.logits = None
        #: kernel launches per replay, taken at capture
        self.counts: dict = {}
        #: warm-up plus capture, wall ms
        self.capture_ms = 0.0
        self._step = step
        if device.type == "cuda":
            self._capture(cache)

    def _live_cache(self) -> dict:
        cache = {n: ref() for n, ref in self._cache.items()}
        if any(t is None for t in cache.values()):
            raise RuntimeError("the graph's cache was freed: make a graph for the new cache")
        return cache

    def _body(self, cache: dict) -> torch.Tensor:
        inputs = (self.tokens, self.pos) if self.table is None else (
            self.tokens, self.pos, self.table)
        logits = torch.where(self.poison[:, None], float("nan"), self._step(cache, *inputs))
        self.ok &= torch.isfinite(logits).all(dim=-1)
        if self.sampling is None:
            nxt = torch.argmax(logits.float(), dim=-1)
        else:
            nxt = sample_prepared(logits, self.sampling, self.generators)
        self.ring.index_copy_(0, self.idx, nxt[None])
        self.idx += 1
        self.tokens.copy_(nxt)
        self.pos.copy_(torch.clamp(self.pos + 1, max=self.seq_len - 1))
        return logits

    def _capture(self, cache: dict) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        # the warm-up allocates what a capture must not (the arrival
        # counters, library workspaces) and runs the launches for real
        with torch.cuda.stream(side):
            self._body(cache)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with kernels.counted() as captured:
            with torch.cuda.graph(graph):
                self.logits = self._body(cache)
        torch.cuda.synchronize(self.device)
        self.graph, self.counts = graph, captured.counts
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def load(self, tokens, pos, temps: list | None = None, topps: list | None = None,
             poison: tuple = (), table=None) -> None:
        """Set each row's token, position and sampler settings (greedy where
        ``temps`` is None) before a run, with no host sync: ``tokens`` and
        ``pos`` are device tensors ([B]) or one host int for every row.
        ``poison``: the rows whose logits the run sets to NaN (the device
        flags are written only when the set changes). ``table``: a paged
        step's page tables [B, nb] (a tensor on any device)."""
        if table is not None:
            self.table.copy_(table)
        poison = tuple(poison)
        if poison != self._poisoned:
            self.poison.zero_()
            for b in poison:
                self.poison[b].fill_(True)
            self._poisoned = poison
        for dst, src in ((self.tokens, tokens), (self.pos, pos)):
            if isinstance(src, torch.Tensor):
                dst.copy_(src.reshape(dst.shape))
            else:
                dst.fill_(int(src))
        batch = self.tokens.shape[0]
        temps = [0.0] * batch if temps is None else temps
        self._rows = tuple(b for b, t in enumerate(temps) if t > 0.0)
        if self.sampling is not None:
            self.sampling.set(temps, [1.0] * batch if topps is None else topps)
        elif self._rows:
            raise ValueError("a greedy graph cannot sample: make a sampled one")

    def run(self, n: int, generators: list | None = None) -> tuple:
        """``n`` steps, no host sync: one replay each on the card. Returns
        (tokens [n, B], ok [B]), views of the static ring and flag that the
        next run overwrites. ``generators[b]``: the generator sampled row b
        draws from (its state goes in before and comes back after)."""
        if not 1 <= n <= self.ring.shape[0]:
            raise ValueError(f"a run of {n} steps: the ring holds {self.ring.shape[0]}")
        rows = self._rows
        if rows and (generators is None or any(generators[b] is None for b in rows)):
            raise ValueError("sampled rows need their generators")
        cache = self._live_cache()
        for b in rows:
            self.generators[b].set_state(generators[b].get_state())
        self.idx.zero_()
        self.ok.fill_(True)
        if self.graph is None:
            for _ in range(n):
                self.logits = self._body(cache)
        else:
            for _ in range(n):
                self.graph.replay()
            kernels.add_launches(self.counts, n)
        for b in rows:
            generators[b].set_state(self.generators[b].get_state())
        return self.ring[:n], self.ok


class GraphCache:
    """An engine's step graphs, keyed by the cache they were captured on
    (its storage) and by what else fixes a capture (B, greedy or sampled,
    the ring). A graph leaves when its cache is freed (a weakref finalizer
    on the cache tensor), so a new cache at the same address is captured
    anew; a live cache keeps at most one graph per key."""

    def __init__(self):
        self._graphs: dict = {}
        #: graphs made so far
        self.made = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, owner: torch.Tensor, key: tuple, make) -> StepGraph:
        """The graph for ``owner`` (the cache tensor) and ``key``, made by
        ``make()`` if there is none."""
        full = (owner.data_ptr(), *key)
        g = self._graphs.get(full)
        if g is None:
            g = self._graphs[full] = make()
            self.made += 1
            weakref.finalize(owner, self._drop, full, weakref.ref(g))
        return g

    def drop(self, owner: torch.Tensor) -> None:
        """Forget every graph captured on ``owner`` now (its private
        memory goes with it), before the cache itself is freed."""
        ptr = owner.data_ptr()
        for key in [k for k in self._graphs if k[0] == ptr]:
            del self._graphs[key]

    def _drop(self, key: tuple, ref) -> None:
        if self._graphs.get(key) is ref():
            self._graphs.pop(key, None)
