"""Host-side bookkeeping for the paged KV pool: a page allocator (free list
+ per-page refcounts) and a radix prefix tree over page-sized token blocks.

The device side of paging lives in ``runtime.generate`` (one preallocated
arena ``[L, P, page, kv, hd]``, per-row page tables, gather-based decode);
this module is the pure-Python accounting it trusts:

* :class:`PageAllocator` — every arena page is in exactly one logical state:
  FREE (on the free list), ROW-HELD (refcount >= 1: some row's page table
  maps it), or EVICTABLE (refcount 0 but retained by the prefix tree, its
  contents reusable by a future admit). Aliasing a cached page under a new
  row is a refcount bump, never a copy; the tree's retention is a separate
  ``cached`` bit so a released row's prompt pages survive as cache instead
  of being zeroed-and-lost like the old bucketed slabs.
* :class:`RadixPrefixCache` — a tree keyed by page-sized token tuples.
  ``match`` walks the longest cached block-aligned prefix of a prompt,
  ``insert`` publishes a row's fully-prompt-covered blocks at go-live, and
  ``evict`` drops LRU refcount-zero leaves back to the free list when an
  allocation needs room.

Admission soundness: rows *reserve* their worst-case private page count up
front (``reserve``/``alloc(reserved=True)``) and ``can_reserve`` admits only
while reservations fit in free + evictable pages. Because a row aliases a
*contiguous* prefix chain from the root, a pinned node's ancestors are
always pinned by the same row — so every refcount-zero cached page sits in a
fully refcount-zero subtree and is genuinely reachable by leaf-LRU eviction:
free + evictable is an exact availability count, and a reserved allocation
can never dead-end mid-decode.

No jax/numpy imports: the serving layer (``lifecycle.KVBudget``) embeds the
allocator directly — the free list and refcounts literally live there —
while the runtime session drives it duck-typed, preserving "the runtime
never imports serving".
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from ..analysis.sanitize import check_invariants, guarded_by

#: arena page index reserved as the garbage scratch slot: page tables are
#: padded with it, and pinned/done rows write their discarded K/V there —
#: it is never allocated, never cached, never read by a live query.
SCRATCH_PAGE = 0


def pages_for(tokens: int, page: int) -> int:
    """Pages needed to hold token positions [0, tokens)."""
    return max(0, (tokens + page - 1) // page)


@guarded_by(None, "_free", "_ref", "_cached", "_evictable", "_reserved")
@check_invariants("check", "reserve", "unreserve", "alloc", "ref", "unref",
                  "hold", "drop")
class PageAllocator:
    """Free list + per-page refcounts for a ``num_pages``-page KV arena.

    Page 0 is the scratch page (see :data:`SCRATCH_PAGE`) and is excluded
    from allocation. All operations are O(1); ``check()`` is the O(P) fuzz
    oracle. Not thread-safe by itself — the serving wrapper (KVBudget)
    provides the lock, the in-process session runs on one scheduler thread.
    """

    def __init__(self, num_pages: int, page_tokens: int,
                 on_stats: Optional[Callable[[dict], None]] = None):
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (scratch + 1 usable), got {num_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        # pop() hands out low page ids first (cosmetic determinism: the fuzz
        # and bit-identity tests get stable page layouts run to run)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = [0] * num_pages
        self._cached = [False] * num_pages
        self._evictable = 0  # cached pages at refcount 0
        self._reserved = 0  # admitted-but-not-yet-allocated private pages
        self._on_stats = on_stats

    # -- introspection ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def evictable_count(self) -> int:
        return self._evictable

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    def refcount(self, p: int) -> int:
        return self._ref[p]

    def is_cached(self, p: int) -> bool:
        return self._cached[p]

    def stats(self) -> dict:
        return {
            "pages_total": self.num_pages - 1,  # scratch excluded
            "pages_free": len(self._free),
            "pages_cached": self._evictable,
            "pages_held": (self.num_pages - 1 - len(self._free)
                           - self._evictable),
            "pages_reserved": self._reserved,
            "page_tokens": self.page_tokens,
        }

    def _publish(self) -> None:
        if self._on_stats is not None:
            self._on_stats(self.stats())

    # -- reservation ------------------------------------------------------
    def can_reserve(self, n: int) -> bool:
        """True when ``n`` more private pages can be promised on top of the
        outstanding reservations. Exact, not heuristic: every evictable
        page is reachable by leaf-LRU (see module docstring)."""
        return self._reserved + n <= len(self._free) + self._evictable

    def reserve(self, n: int) -> None:
        self._reserved += n
        self._publish()

    def unreserve(self, n: int) -> None:
        self._reserved = max(0, self._reserved - n)
        self._publish()

    # -- page lifecycle ---------------------------------------------------
    def alloc(self, reserved: bool = True) -> Optional[int]:
        """Pop a free page (refcount becomes 1, owned by the caller's row).
        Returns None when the free list is empty — the caller evicts from
        the prefix tree and retries. ``reserved`` burns one outstanding
        reservation (the admission promised this page)."""
        if not self._free:
            return None
        p = self._free.pop()
        self._ref[p] = 1
        if reserved:
            self._reserved = max(0, self._reserved - 1)
        self._publish()
        return p

    def ref(self, p: int) -> None:
        """Alias an existing (cached or row-held) page under one more row."""
        if p == SCRATCH_PAGE or self._ref[p] == 0 and not self._cached[p]:
            raise ValueError(f"page {p} is not aliasable (free or scratch)")
        if self._ref[p] == 0:
            self._evictable -= 1
        self._ref[p] += 1
        self._publish()

    def unref(self, p: int) -> None:
        """Drop one row's hold. At refcount 0 the page returns to the free
        list — unless the prefix tree retains it, where it becomes
        evictable cache instead."""
        if self._ref[p] <= 0:
            raise ValueError(f"unref of page {p} at refcount 0")
        self._ref[p] -= 1
        if self._ref[p] == 0:
            if self._cached[p]:
                self._evictable += 1
            else:
                self._free.append(p)
        self._publish()

    def hold(self, p: int) -> None:
        """The prefix tree retains ``p`` (insert at go-live). Idempotent."""
        if self._cached[p]:
            return
        if self._ref[p] == 0:
            # a free page can't be holding valid KV
            raise ValueError(f"cache hold of unowned page {p}")
        self._cached[p] = True
        self._publish()

    def drop(self, p: int) -> None:
        """The prefix tree released ``p`` (eviction). At refcount 0 it goes
        straight to the free list."""
        if not self._cached[p]:
            raise ValueError(f"cache drop of uncached page {p}")
        self._cached[p] = False
        if self._ref[p] == 0:
            self._evictable -= 1
            self._free.append(p)
        self._publish()

    # -- fuzz oracle ------------------------------------------------------
    def check(self) -> None:
        """Full-state invariant scan; raises AssertionError on corruption.
        The randomized fuzz test calls this after every operation."""
        assert self._ref[SCRATCH_PAGE] == 0 and not self._cached[SCRATCH_PAGE]
        assert SCRATCH_PAGE not in self._free, "scratch page leaked to free"
        seen = set(self._free)
        assert len(seen) == len(self._free), "duplicate page on free list"
        evictable = 0
        for p in range(1, self.num_pages):
            assert self._ref[p] >= 0, f"negative refcount on page {p}"
            in_free = p in seen
            live = self._ref[p] > 0 or self._cached[p]
            assert in_free != live, (
                f"page {p} state corrupt: in_free={in_free} "
                f"ref={self._ref[p]} cached={self._cached[p]}")
            if self._cached[p] and self._ref[p] == 0:
                evictable += 1
        assert evictable == self._evictable, (
            f"evictable counter drift: {self._evictable} != {evictable}")
        assert self._reserved <= len(self._free) + self._evictable, (
            f"reservations ({self._reserved}) exceed available pages "
            f"({len(self._free)} free + {self._evictable} evictable)")


class _Node:
    """One cached page-block: ``key`` is its page-sized token tuple, edges
    hang off ``children`` keyed the same way. ``ready`` is False while the
    publishing row's chunked prefill has not yet written the page's KV —
    the node exists (publish-at-admit) so concurrent admits of the same
    prefix converge on one chain, but ``match`` refuses to alias it until
    the owner flips it ready."""

    __slots__ = ("key", "page", "children", "parent", "last_use", "ready")

    def __init__(self, key: Optional[tuple], page: int,
                 parent: Optional["_Node"], last_use: int,
                 ready: bool = True):
        self.key = key
        self.page = page
        self.children: dict = {}
        self.parent = parent
        self.last_use = last_use
        self.ready = ready


@guarded_by(None, "_root", "_clock", "_count")
class RadixPrefixCache:
    """Token-block prefix tree over arena pages.

    Block-aligned on purpose: a node caches exactly one page's worth of
    tokens, so "alias the matched prefix" is a per-page refcount bump with
    no partial-page bookkeeping. Matching is longest-prefix over full
    blocks; the sub-page boundary remainder is the admitting row's private
    (copy-on-write) page.
    """

    def __init__(self, page_tokens: int):
        self.page_tokens = page_tokens
        self._root = _Node(None, -1, None, 0)
        self._clock = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def _block(self, tokens: Sequence[int], b: int) -> tuple:
        p = self.page_tokens
        return tuple(tokens[b * p:(b + 1) * p])

    def match(self, tokens: Sequence[int]) -> List[_Node]:
        """Nodes caching the longest block-aligned prefix of ``tokens``
        (root-first). Touches the whole path for LRU. Stops at the first
        non-``ready`` node: its KV is still being prefilled by the
        publishing row and MUST NOT be aliased yet."""
        self._clock += 1
        path: List[_Node] = []
        node = self._root
        for b in range(len(tokens) // self.page_tokens):
            child = node.children.get(self._block(tokens, b))
            if child is None or not child.ready:
                break
            child.last_use = self._clock
            path.append(child)
            node = child
        return path

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[int]:
        """Publish blocks 0..len(pages)-1 of ``tokens`` into the tree,
        mapping block ``b`` to physical page ``pages[b]``. Blocks already
        cached keep their existing page (the caller's copy stays a private
        duplicate); missing blocks get nodes. Returns the pages of the
        NEWLY created nodes — the caller marks those held
        (:meth:`PageAllocator.hold`)."""
        self._clock += 1
        created: List[int] = []
        node = self._root
        for b, page in enumerate(pages):
            key = self._block(tokens, b)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, node, self._clock)
                node.children[key] = child
                self._count += 1
                created.append(page)
            else:
                child.last_use = self._clock
            node = child
        return created

    def publish_pending(self, tokens: Sequence[int],
                        pages: Sequence[int]) -> List[Optional[_Node]]:
        """Publish-at-admit: like :meth:`insert` but NEW nodes are created
        ``ready=False`` (invisible to ``match`` until the publishing row's
        prefill fills their pages and flips them). Returns a list aligned
        with ``pages`` whose entry ``b`` is the node CREATED for block b,
        or None where a node already existed (that block's page in
        ``pages`` stays the caller's private, uncached duplicate). The
        caller marks each created node's page held."""
        self._clock += 1
        out: List[Optional[_Node]] = []
        node = self._root
        for b, page in enumerate(pages):
            key = self._block(tokens, b)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, node, self._clock, ready=False)
                node.children[key] = child
                self._count += 1
                out.append(child)
            else:
                child.last_use = self._clock
                out.append(None)
            node = child
        return out

    def unpublish(self, nodes: Sequence[_Node],
                  alloc: PageAllocator) -> int:
        """Retract nodes a cancelled/abandoned admission published (its
        never-filled ``ready=False`` ones are garbage no admit may ever
        alias). Deepest-first so a chain removes cleanly; a node that
        grew children under it (a longer concurrent publish) is left in
        place — unreachable to ``match`` while not ready, reclaimed by
        leaf-LRU eviction once its subtree goes. Returns nodes removed."""
        removed = 0
        for node in reversed(list(nodes)):
            if node is None or node.children or node.parent is None:
                continue
            if node.parent.children.get(node.key) is not node:
                continue  # already evicted/replaced
            del node.parent.children[node.key]
            node.parent = None
            self._count -= 1
            alloc.drop(node.page)
            removed += 1
        return removed

    def evict(self, n: int, alloc: PageAllocator) -> int:
        """Free up to ``n`` pages by dropping LRU refcount-zero *leaves*
        (an interior node's children would dangle; by prefix-chain pinning
        its refcount-zero subtree is itself leaf-reachable). Returns pages
        actually freed. O(nodes) scan per victim — the tree is bounded by
        the arena page count, far below where this matters on the host."""
        freed = 0
        while freed < n:
            victim: Optional[_Node] = None
            for node in self._iter():
                if node.children or alloc.refcount(node.page) > 0:
                    continue
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._count -= 1
            alloc.drop(victim.page)
            freed += 1
        return freed

    def _iter(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def cached_pages(self) -> List[Tuple[int, int]]:
        """(page, refcount-agnostic) listing for tests/introspection."""
        return [(n.page, n.last_use) for n in self._iter()]
