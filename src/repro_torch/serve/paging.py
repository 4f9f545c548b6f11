"""Host-side paged-KV management: page pool, radix prefix index, offload
(a copy of `repro.serve.paging`, pure numpy; the port imports nothing of
the JAX package).

The device side (models.paged) is pure data movement — pools, block tables,
tab-mapped scatters. Everything stateful lives here, on the host, in the
`Pager` the engine consults at admission/release time:

  * `PagePool` — the physical free list + per-page refcounts. Page 0 is the
    reserved null page and is never allocated.
  * `RadixPrefixIndex` — a page-granular radix trie over prompt prefixes:
    each edge is one page_size-token chunk, each node owns (one refcount of)
    the physical page holding that chunk's KV. `Engine.add` walks it so a
    request sharing a prompt prefix is admitted at near-zero prefill cost —
    its block table simply points at the shared pages (full-page-only
    sharing, the vLLM copy-on-write discipline: a divergence below page
    granularity recomputes the partial page into a private fresh page, so
    no literal KV copy is ever needed).
  * Host-RAM offload — when the pool runs dry, cold index pages (LRU,
    refcount 1 = held only by the index) are paged out to host memory
    instead of being dropped, and paged back in on the next prefix hit.
    `host_offload_pages` bounds the tier; 0 disables it (cold pages are
    then dropped outright, childless-first so the trie stays rooted).

Allocation policy: admission reserves the request's full worst-case page
budget up front (prompt + max_new - 1 + draft window, minus shared prefix
pages). That makes mid-decode exhaustion impossible by construction — the
out-of-pages condition surfaces exactly once, at admission, where the
scheduler can queue the request (`OutOfPages` → `Engine.add` returns False)
instead of deadlocking a half-decoded slot.

Safety: freshly allocated pages still hold their previous owner's content.
GQA pools scrub `slot_pos = -1` on allocation (`pending_scrub`, flushed by
the engine before its next step). Shared prefix pages are never scrubbed
and never written: every cache write targets logical positions >= the
slot's admission idx, which is >= the matched prefix length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np


class OutOfPages(Exception):
    """Admission-time pool exhaustion: no free page and nothing evictable.
    The engine turns this into a queue-for-pages admission deferral (a
    transient condition), never a hard rejection."""


@dataclasses.dataclass
class PagedKVConfig:
    """Engine-facing paged-KV knobs (Engine(paged_kv=PagedKVConfig(...))).

    `scrub_batch` is kept for parity with the JAX config only: JAX scrubs
    fresh pages in fixed-width batches so that its jitted scrub never
    recompiles, while the port scrubs every fresh page of a flush in one
    indexed write and ignores the field."""

    page_size: int = 16          # tokens per KV page (must divide max_len)
    n_pages: int = 0             # pool size incl. null page; 0 = auto:
                                 #   max_slots * (max_len/page_size) + 1
    prefix_sharing: bool = True  # radix prompt-prefix index + CoW refcounts
    host_offload_pages: int = 0  # host-RAM tier capacity in pages (0 = off)
    scrub_batch: int = 32        # JAX's scrub width; unused here


class PagePool:
    """Free list + refcounts over physical pages 1..n_pages-1 (0 = null)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: list[int] = list(range(n_pages - 1, 0, -1))
        self.refs = np.zeros(n_pages, np.int64)

    @property
    def free_pages(self) -> int:
        return len(self.free)

    def alloc(self) -> int | None:
        if not self.free:
            return None
        page = self.free.pop()
        self.refs[page] = 1
        return page

    def retain(self, page: int) -> None:
        self.refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True if the page returned to the free list."""
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self.free.append(page)
            return True
        return False


class _RadixNode:
    __slots__ = ("children", "parent", "key", "page", "host_data", "last_used")

    def __init__(self, parent: "_RadixNode | None", key: tuple | None):
        self.children: dict[tuple, _RadixNode] = {}
        self.parent = parent
        self.key = key
        self.page = -1           # live physical page, or -1 (offloaded/root)
        self.host_data: Any = None
        self.last_used = 0


class RadixPrefixIndex:
    """Page-granular radix trie over prompt prefixes. Each node below the
    root represents one page_size-token chunk and holds one refcount of the
    page with that chunk's KV (or its host copy when offloaded)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode(None, None)
        self.live_nodes = 0       # nodes with a device-resident page
        self.offloaded_nodes = 0  # nodes whose page lives in host RAM

    def walk(self, prompt: np.ndarray, limit_tokens: int):
        """Yield the trie nodes matching `prompt`'s leading full-page chunks,
        stopping at `limit_tokens` or the first miss."""
        ps = self.page_size
        node = self.root
        off = 0
        while off + ps <= limit_tokens:
            child = node.children.get(tuple(int(t) for t in prompt[off:off + ps]))
            if child is None:
                return
            yield child
            node = child
            off += ps

    def child_for(self, node: _RadixNode, chunk: tuple) -> "_RadixNode | None":
        return node.children.get(chunk)

    def insert(self, node: _RadixNode, chunk: tuple) -> _RadixNode:
        child = _RadixNode(node, chunk)
        node.children[chunk] = child
        return child

    def remove(self, node: _RadixNode) -> None:
        node.parent.children.pop(node.key, None)

    def evictable(self, refs: np.ndarray, *, droppable_only: bool):
        """LRU-ordered nodes whose page only the index holds (refcount 1).
        droppable_only restricts to childless nodes — dropping an interior
        node would orphan its (still reachable only through it) subtree."""
        best = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.page < 0 or refs[n.page] != 1:
                continue
            if droppable_only and n.children:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        return best


class Pager:
    """The engine's paged-KV authority: block-table bookkeeping, prefix
    matching, reservation-based admission, and eviction/offload.

    page_out(page) -> host data and page_in(page, data) are engine-provided
    device callbacks (models.paged.gather_page / restore_page)."""

    def __init__(
        self,
        cfg: PagedKVConfig,
        *,
        max_slots: int,
        max_len: int,
        n_pages: int,
        page_out: Callable[[int], Any] | None = None,
        page_in: Callable[[int, Any], None] | None = None,
    ):
        if max_len % cfg.page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({cfg.page_size})"
            )
        self.cfg = cfg
        self.page_size = cfg.page_size
        self.max_slots = max_slots
        self.max_len = max_len
        self.cap = max_len // cfg.page_size     # block-table row width
        self.pool = PagePool(n_pages)
        self.index = RadixPrefixIndex(cfg.page_size)
        self._page_out = page_out
        self._page_in = page_in
        self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self.slot_shared = [0] * max_slots      # leading shared-page count
        self.pending_scrub: list[int] = []      # fresh pages awaiting scrub
        self.dirty = False                      # block tables need a flush
        self._clock = 0
        # counters (the obs layer and ServeStats read these)
        self.prefix_hit_tokens = 0
        self.prefix_hit_requests = 0
        self.pages_paged_out = 0
        self.pages_paged_in = 0
        self.pages_dropped = 0

    # -- stats ---------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.pool.n_pages

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def total_pages(self) -> int:
        """Allocatable pages (the reserved null page excluded)."""
        return self.pool.n_pages - 1

    @property
    def shared_pages(self) -> int:
        """Device-resident pages held by the prefix index."""
        return self.index.live_nodes

    @property
    def offloaded_pages(self) -> int:
        return self.index.offloaded_nodes

    # -- internals -----------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _evict_one(self) -> bool:
        """Free one cold index page: offload it to host RAM when the tier
        has room (any refcount-1 node, LRU), otherwise drop a childless
        refcount-1 node outright. False when nothing is evictable."""
        can_offload = (
            self._page_out is not None
            and self.index.offloaded_nodes < self.cfg.host_offload_pages
        )
        if can_offload:
            victim = self.index.evictable(self.pool.refs, droppable_only=False)
            if victim is not None:
                victim.host_data = self._page_out(victim.page)
                self.pool.release(victim.page)
                victim.page = -1
                self.index.live_nodes -= 1
                self.index.offloaded_nodes += 1
                self.pages_paged_out += 1
                return True
        victim = self.index.evictable(self.pool.refs, droppable_only=True)
        if victim is None:
            return False
        self.pool.release(victim.page)
        self.index.remove(victim)
        self.index.live_nodes -= 1
        self.pages_dropped += 1
        return True

    def _alloc(self) -> int | None:
        page = self.pool.alloc()
        if page is None and self._evict_one():
            page = self.pool.alloc()
        return page

    def _release_page(self, page: int) -> None:
        if self.pool.release(page):
            # the page may still be queued for a scrub it no longer needs —
            # harmless (scrubbing a free page invalidates garbage), keep it.
            pass

    # -- admission / release -------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray, need_tokens: int) -> int:
        """Reserve slot `slot`'s full page budget for a request needing
        `need_tokens` cache positions, reusing shared prefix pages where the
        radix index matches (paging offloaded ones back in). Returns the
        matched prefix length in tokens. Raises OutOfPages (with every
        reservation rolled back) when the pool cannot cover the remainder.
        """
        ps = self.page_size
        need_pages = -(-need_tokens // ps)
        matched_pages: list[int] = []
        if self.cfg.prefix_sharing:
            # cap the match below the full prompt: at least one prompt token
            # must still run through the model to produce first-token logits
            limit = min(len(prompt) - 1, need_tokens)
            for node in self.index.walk(prompt, limit):
                if node.page < 0:
                    if self._page_in is None:
                        break
                    page = self._alloc()
                    if page is None:
                        break               # partial prefix is still a win
                    self._page_in(page, node.host_data)
                    node.host_data = None
                    node.page = page
                    # _alloc gave the page one ref — that is the index's
                    self.index.live_nodes += 1
                    self.index.offloaded_nodes -= 1
                    self.pages_paged_in += 1
                self.pool.retain(node.page)     # the slot's reference
                matched_pages.append(node.page)
                node.last_used = self._tick()
        fresh: list[int] = []
        for _ in range(need_pages - len(matched_pages)):
            page = self._alloc()
            if page is None:
                for p in fresh:
                    self._release_page(p)
                for p in matched_pages:
                    self._release_page(p)
                raise OutOfPages(
                    f"KV page pool exhausted: need {need_pages} pages "
                    f"({need_tokens} positions), "
                    f"{len(matched_pages)} shared + {self.free_pages} free"
                )
            fresh.append(page)
        self.pending_scrub.extend(fresh)
        self.slot_pages[slot] = matched_pages + fresh
        self.slot_shared[slot] = len(matched_pages)
        matched = len(matched_pages) * ps
        self.prefix_hit_tokens += matched
        if matched:
            self.prefix_hit_requests += 1
        self.dirty = True
        return matched

    def release(self, slot: int, prompt: np.ndarray) -> None:
        """Return slot `slot`'s pages: full-page prompt-prefix pages are
        inserted into (or merged with) the radix index so the next request
        with this prefix admits at near-zero prefill cost; the rest
        (partial prompt tail + generated tokens) go back to the free list.
        """
        pages = self.slot_pages[slot]
        if not pages:
            return
        ps = self.page_size
        n_prefix = min(len(prompt) // ps, len(pages)) if self.cfg.prefix_sharing else 0
        node = self.index.root
        for i in range(n_prefix):
            chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            child = self.index.child_for(node, chunk)
            if child is None:
                # transfer the slot's reference to the new index node
                child = self.index.insert(node, chunk)
                child.page = pages[i]
                self.index.live_nodes += 1
            elif child.page < 0:
                # offloaded node: adopt the slot's live page (it holds the
                # exact same chunk KV) and drop the stale host copy
                child.page = pages[i]
                child.host_data = None
                self.index.live_nodes += 1
                self.index.offloaded_nodes -= 1
            else:
                # index already holds this chunk (shared admission, or a
                # concurrent duplicate) — drop the slot's reference
                self._release_page(pages[i])
            child.last_used = self._tick()
            node = child
        for page in pages[n_prefix:]:
            self._release_page(page)
        self.slot_pages[slot] = []
        self.slot_shared[slot] = 0
        self.dirty = True

    # -- device sync ----------------------------------------------------
    def tables(self) -> np.ndarray:
        """(max_slots, cap) int32 block tables; 0 = unmapped (null page)."""
        tab = np.zeros((self.max_slots, self.cap), np.int32)
        for slot, pages in enumerate(self.slot_pages):
            tab[slot, :len(pages)] = pages
        return tab

    def take_flush(self) -> tuple[np.ndarray, list[int]]:
        """→ (block tables, fresh pages to scrub); clears the dirty state.
        The engine pushes both to the device before its next step."""
        scrub, self.pending_scrub = self.pending_scrub, []
        self.dirty = False
        return self.tables(), scrub
