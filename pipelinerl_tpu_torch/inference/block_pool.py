"""Host-side KV page allocator and prefix cache for the paged layout.

A copy of the JAX package's ``inference/block_pool.py`` (the port imports
nothing of that package): fixed-size pages from a shared pool, reference
counts for prefix sharing (a GRPO group's forks share the prompt's full
pages; only the partial tail page is copied), free-list reuse, and an LRU
cache of finished transcripts' full pages. Allocation order, refcounts, the
``-1`` marker for unused table entries and eviction order are the same, so
both engines make the same page choices. Pure host bookkeeping: the device
sees only the ``[S, MAX_BLOCKS]`` block table this class maintains.

Fork sharing is append-safe by construction: decode appends go to pages the
slot allocated itself (the copied tail or fresh pages), never to a shared
full page, so no copy-on-write machinery is needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class OutOfBlocks(RuntimeError):
    """Pool exhausted — callers should defer admission until frees happen."""


@dataclass
class BlockPool:
    n_blocks: int
    block_size: int
    max_blocks_per_slot: int
    n_slots: int
    refs: np.ndarray = field(init=False)  # [n_blocks] int32 refcounts
    table: np.ndarray = field(init=False)  # [n_slots, max_blocks] int32, -1 unused
    slot_blocks: np.ndarray = field(init=False)  # [n_slots] blocks in use
    _free: list = field(init=False)

    def __post_init__(self):
        self.refs = np.zeros(self.n_blocks, np.int32)
        self.table = np.full((self.n_slots, self.max_blocks_per_slot), -1, np.int32)
        self.slot_blocks = np.zeros(self.n_slots, np.int32)
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop() = lowest id last

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens)
        return need <= len(self._free) and need <= self.max_blocks_per_slot

    # ------------------------------------------------------------------
    def allocate(self, slot: int, n_tokens: int) -> np.ndarray:
        """Fresh pages for a new admission of ``n_tokens``; returns the
        physical ids (the caller writes prefill K/V into them)."""
        assert self.slot_blocks[slot] == 0, f"slot {slot} still holds blocks"
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_slot:
            raise OutOfBlocks(
                f"{n_tokens} tokens need {need} pages > max {self.max_blocks_per_slot}"
            )
        if need > len(self._free):
            raise OutOfBlocks(f"need {need} pages, {len(self._free)} free")
        ids = np.asarray([self._free.pop() for _ in range(need)], np.int32)
        self.refs[ids] += 1
        self.table[slot, :need] = ids
        self.slot_blocks[slot] = need
        return ids

    def extend(self, slot: int, n_tokens_total: int) -> np.ndarray:
        """Grow a slot's table to cover ``n_tokens_total``; returns any NEW
        page ids (decode windows call this before appending)."""
        have = int(self.slot_blocks[slot])
        need = self.blocks_for(n_tokens_total)
        if need <= have:
            return np.empty(0, np.int32)
        grow = need - have
        if need > self.max_blocks_per_slot:
            raise OutOfBlocks(
                f"{n_tokens_total} tokens need {need} pages > max "
                f"{self.max_blocks_per_slot}"
            )
        if grow > len(self._free):
            raise OutOfBlocks(f"need {grow} pages, {len(self._free)} free")
        ids = np.asarray([self._free.pop() for _ in range(grow)], np.int32)
        self.refs[ids] += 1
        self.table[slot, have:need] = ids
        self.slot_blocks[slot] = need
        return ids

    def fork(self, src_slot: int, dst_slot: int, n_tokens: int) -> tuple[np.ndarray, int]:
        """Share ``src_slot``'s FULL pages with ``dst_slot`` (refcount++) and
        allocate a fresh tail page for the partial remainder. Returns
        ``(tail_page_ids, n_shared_tokens)`` — the caller copies the source's
        partial-tail K/V rows into the fresh page on device. If the length
        lands exactly on a page boundary there is no tail to copy."""
        assert self.slot_blocks[dst_slot] == 0, f"slot {dst_slot} still holds blocks"
        full = n_tokens // self.block_size
        tail_tokens = n_tokens - full * self.block_size
        need_tail = 1 if tail_tokens else 0
        if full + need_tail > self.max_blocks_per_slot:
            raise OutOfBlocks("fork exceeds max pages per slot")
        if need_tail > len(self._free):
            raise OutOfBlocks("no free page for fork tail")
        shared = self.table[src_slot, :full]
        self.refs[shared] += 1
        self.table[dst_slot, :full] = shared
        tail = np.empty(0, np.int32)
        if need_tail:
            tail = np.asarray([self._free.pop()], np.int32)
            self.refs[tail] += 1
            self.table[dst_slot, full] = tail[0]
        self.slot_blocks[dst_slot] = full + need_tail
        return tail, full * self.block_size

    def release(self, slot: int) -> None:
        """Drop the slot's references; pages hit the free list at refcount 0."""
        n = int(self.slot_blocks[slot])
        for b in self.table[slot, :n]:
            b = int(b)
            self.refs[b] -= 1
            assert self.refs[b] >= 0, f"negative refcount on page {b}"
            if self.refs[b] == 0:
                self._free.append(b)
        self.table[slot, :] = -1
        self.slot_blocks[slot] = 0

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Debug: every page is either free or referenced, never both."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        for b in range(self.n_blocks):
            if b in free:
                assert self.refs[b] == 0, f"free page {b} has refs"
        live = self.table[self.table >= 0]
        counts = np.bincount(live, minlength=self.n_blocks)
        # refs may exceed table counts: the prefix cache holds pages that
        # appear in no slot's table (PrefixCache entries own one ref each)
        assert (counts <= self.refs).all(), "refcounts diverge from table"

    # ------------------------------------------------------------------
    def attach(self, slot: int, pages: np.ndarray) -> None:
        """Reference an existing page run as the slot's prefix (cross-turn
        prefix reuse): refcount++ each page, table rows 0..len(pages). The
        slot must not append into these pages — appends start at the first
        position past the attached prefix, which lands in a NEW page."""
        assert self.slot_blocks[slot] == 0, f"slot {slot} still holds blocks"
        n = len(pages)
        if n > self.max_blocks_per_slot:
            raise OutOfBlocks("prefix exceeds max pages per slot")
        self.refs[pages] += 1
        self.table[slot, :n] = pages
        self.slot_blocks[slot] = n

    def ref_pages(self, pages: np.ndarray) -> None:
        self.refs[pages] += 1

    def unref_pages(self, pages: np.ndarray) -> None:
        for b in pages:
            b = int(b)
            self.refs[b] -= 1
            assert self.refs[b] >= 0, f"negative refcount on page {b}"
            if self.refs[b] == 0:
                self._free.append(b)


class PrefixCache:
    """Page-aligned prefix reuse across requests. A finished
    request's full pages are registered under a hash of their token prefix;
    a later request whose prompt extends that transcript reattaches the
    pages and prefills only the tail — turn N+1 of a multi-turn rollout
    stops re-prefilling turns 1..N.

    Reused KV was computed under the weights current at ITS decode time —
    exactly the in-flight-update staleness PipelineRL embraces within one
    generation (a reattached conversation behaves like one long generation
    spanning weight versions).

    Entries hold one refcount on each page (via the pool) and are evicted
    LRU when the pool runs dry or the cache exceeds ``max_pages``."""

    def __init__(self, pool: BlockPool, max_pages: int | None = None):
        from collections import OrderedDict

        self.pool = pool
        self.max_pages = max_pages if max_pages is not None else pool.n_blocks // 2
        self._entries: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._pages_held = 0
        self.hits = 0
        self.reused_tokens = 0

    @staticmethod
    def _key(tokens, n_pages: int, block_size: int) -> tuple:
        return (n_pages, hash(tuple(tokens[: n_pages * block_size])))

    def register(self, tokens, table_row: np.ndarray) -> None:
        """Register the longest full-page prefix of a finished sequence.
        ``table_row`` is the slot's page table (still referenced by the slot
        — call before pool.release)."""
        BT = self.pool.block_size
        n_pages = len(tokens) // BT
        if n_pages == 0:
            return
        key = self._key(tokens, n_pages, BT)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        pages = np.asarray(table_row[:n_pages], np.int32).copy()
        self.pool.ref_pages(pages)
        self._entries[key] = pages
        self._pages_held += n_pages
        while self._pages_held > self.max_pages and len(self._entries) > 1:
            self._evict_one()

    def lookup(self, tokens) -> tuple[np.ndarray, int] | None:
        """Longest registered page-aligned proper prefix of ``tokens``.
        Returns (pages, n_prefix_tokens); at least one token is left for the
        tail prefill (the new request needs last-position logits)."""
        BT = self.pool.block_size
        max_pages = (len(tokens) - 1) // BT
        for n_pages in range(max_pages, 0, -1):
            key = self._key(tokens, n_pages, BT)
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self.reused_tokens += n_pages * BT
                return entry, n_pages * BT
        return None

    def _evict_one(self) -> int:
        key, pages = self._entries.popitem(last=False)
        self.pool.unref_pages(pages)
        self._pages_held -= len(pages)
        return len(pages)

    def evict_for(self, n_pages_needed: int) -> bool:
        """Evict LRU entries until the pool has ``n_pages_needed`` free.
        Returns True if satisfied."""
        while self.pool.free_blocks < n_pages_needed and self._entries:
            self._evict_one()
        return self.pool.free_blocks >= n_pages_needed

    @property
    def pages_held(self) -> int:
        return self._pages_held
