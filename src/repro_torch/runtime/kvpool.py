"""Shared paged KV pool — host-side allocator, prefix cache and per-slot
page tables (the port of `repro.runtime.kvpool`, host numpy throughout).

* `PagePool` — a free list over pages ``1..n_pages-1`` with refcounts;
  page 0 is the reserved *trash page* that retired slots' tables point
  at (the session steps every slot while any is live, so a finished
  slot keeps writing at its frozen position). `alloc` raises the typed
  `PoolExhausted` without taking anything.
* `PrefixCache` — copy-on-write prefix sharing: completed requests
  publish their fully written prompt pages under a hash chain of
  page-aligned token prefixes; a later request with the same preamble
  maps them read-only and skips their prefill. Cold entries are evicted
  LRU-first under memory pressure.
* `PagedKV` — the session's façade: `admit` builds a slot's table row
  (shared + fresh pages, prefill skip, pending COW copies), `publish`
  seeds the prefix cache, `release` returns the pages.

Page checksums, the integrity scrub, quarantine and snapshots belong to
durable serving (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

TRASH_PAGE = 0


class PoolExhausted(RuntimeError):
    """The pool has fewer free pages than the request needs."""

    def __init__(self, needed: int, free: int):
        super().__init__(f"KV pool exhausted: need {needed} pages, "
                         f"{free} free")
        self.needed = needed
        self.free = free


class PagePool:
    """Free-list page allocator with per-page refcounts."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is reserved), "
                             f"got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(n_pages, np.int32)
        self.refcount[TRASH_PAGE] = 1          # pinned forever
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self.allocs = 0
        self.alloc_failures = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take `n` fresh pages (refcount 1 each) or raise `PoolExhausted`
        without taking any."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            self.alloc_failures += 1
            raise PoolExhausted(n, len(self._free))
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            if self.refcount[p] != 0:
                raise RuntimeError(f"page {p} double-allocated")
            self.refcount[p] = 1
        self.allocs += n
        return pages

    def ref(self, pages) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise RuntimeError(f"ref of free page {p}")
            self.refcount[p] += 1

    def release(self, pages) -> list[int]:
        """Drop one reference per page; returns the pages that became free."""
        freed = []
        for p in pages:
            if p == TRASH_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise RuntimeError(f"release of free page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "used_pages": self.used_pages,
                "free_pages": self.free_pages,
                "occupancy_pct": 100.0 * self.used_pages /
                max(self.n_pages - 1, 1),
                "allocs": self.allocs,
                "alloc_failures": self.alloc_failures}


def _page_key(prev_key: bytes, tokens: np.ndarray) -> bytes:
    """Rolling hash chain: key of page k = H(key of page k-1 || tokens)."""
    h = hashlib.blake2b(prev_key, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class _PrefixEntry:
    page: int
    tokens: np.ndarray         # the page's token content (page_size,)
    parent: bytes = b"root"    # chain key of the previous page's entry
    hits: int = 0
    last_used: int = 0         # logical tick of the last insert/match


class PrefixCache:
    """Hash-chained map from page-aligned token prefixes to pool pages."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._chain: dict[bytes, _PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._tick = 0

    def _touch(self) -> int:
        self._tick += 1
        return self._tick

    def __len__(self) -> int:
        return len(self._chain)

    def insert(self, tokens: np.ndarray, pages) -> int:
        """Publish the fully covered prompt pages (each gains a cache
        reference). Returns how many new pages were published."""
        ps = self.pool.page_size
        tokens = np.asarray(tokens, np.int32)
        n_full = min(tokens.size // ps, len(pages))
        key = b"root"
        published = 0
        for k in range(n_full):
            page_toks = tokens[k * ps:(k + 1) * ps]
            parent, key = key, _page_key(key, page_toks)
            if key in self._chain:
                self._chain[key].last_used = self._touch()
                continue
            page = int(pages[k])
            if page == TRASH_PAGE:
                break
            self.pool.ref([page])
            self._chain[key] = _PrefixEntry(page, page_toks.copy(), parent,
                                            last_used=self._touch())
            published += 1
        return published

    def _walk(self, tokens: np.ndarray):
        """Entries of the longest cached chain covering a prefix of
        `tokens` (bit-exact token match, not just hash match)."""
        ps = self.pool.page_size
        tokens = np.asarray(tokens, np.int32)
        key = b"root"
        for k in range(tokens.size // ps):
            page_toks = tokens[k * ps:(k + 1) * ps]
            key = _page_key(key, page_toks)
            e = self._chain.get(key)
            if e is None or not np.array_equal(e.tokens, page_toks):
                return
            yield e

    def match(self, tokens: np.ndarray) -> list[int]:
        """Pages of the longest cached prefix of `tokens`. Refcounts are
        not bumped here — the caller refs the pages it installs."""
        out = []
        for e in self._walk(tokens):
            e.hits += 1
            e.last_used = self._touch()
            out.append(e.page)
        if out:
            self.hits += 1
        else:
            self.misses += 1
        return out

    def match_len(self, tokens: np.ndarray) -> int:
        """Reusable prefix length in tokens (peek: no hit accounting)."""
        return sum(1 for _ in self._walk(tokens)) * self.pool.page_size

    def evict(self, n_pages: int) -> list[int]:
        """Drop entries, coldest first and sole-owner pages before pages a
        running slot still maps, until `n_pages` pages were freed or the
        cache is empty. Dropping an entry drops its chain descendants.
        Returns the freed pages."""
        freed: list[int] = []
        while self._chain and len(freed) < n_pages:
            key = min(self._chain, key=lambda k: (
                int(self.pool.refcount[self._chain[k].page]) > 1,
                self._chain[k].last_used))
            freed += self._drop_chain(key)
        return freed

    def _drop_chain(self, key: bytes) -> list[int]:
        doomed = {key}
        changed = True
        while changed:
            changed = False
            for k, e in self._chain.items():
                if k not in doomed and e.parent in doomed:
                    doomed.add(k)
                    changed = True
        freed: list[int] = []
        for k in doomed:
            e = self._chain.pop(k)
            self.evictions += 1
            freed += self.pool.release([e.page])
        return freed


@dataclasses.dataclass
class SlotAlloc:
    """What `PagedKV.admit` hands the session for one slot."""

    table: np.ndarray            # (pages_per_slot,) int32 page ids
    prefill_skip: int            # prompt tokens covered by shared pages
    shared_pages: int            # pages mapped read-only from the cache
    cow_copies: list[tuple[int, int]]   # (src, dst) device page copies


class PagedKV:
    """Per-session paged-KV manager: pool + prefix cache + slot tables."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int, *, prefix_cache: bool = True):
        self.pool = PagePool(n_pages, page_size)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.n_slots = int(n_slots)
        self.pages_per_slot = int(pages_per_slot)
        # owned: the references the slot drops on release (including a
        # COW fork's source page); table: the pages the device addresses
        self._slot_owned: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_table: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_prompt: list[np.ndarray | None] = [None] * n_slots
        self.pages_shared_total = 0
        self.prefill_skipped_tokens = 0
        self.cow_forks = 0

    def admit(self, slot: int, prompt: np.ndarray,
              max_new: int) -> SlotAlloc:
        """Build the slot's page table for `prompt` + up to `max_new`
        output tokens: shared prefix pages read-only, the rest fresh.
        Raises `PoolExhausted` (allocating nothing) when the pool cannot
        cover the fresh pages even after evicting prefix-cache entries."""
        if self._slot_owned[slot]:
            raise RuntimeError(f"slot {slot} already mapped")
        ps = self.pool.page_size
        prompt = np.asarray(prompt, np.int32)
        n_total = -(-(prompt.size + max_new) // ps)       # ceil
        if n_total > self.pages_per_slot:
            raise ValueError(
                f"request needs {n_total} pages > pages_per_slot "
                f"{self.pages_per_slot} (prompt {prompt.size} + "
                f"max_new {max_new}, page_size {ps})")
        shared = self.prefix.match(prompt) if self.prefix else []
        # the final prompt token is always re-fed (its forward pass emits
        # the first token); an exact full-coverage hit COW-forks the page
        # that token writes into
        skip = min(len(shared) * ps, max(prompt.size - 1, 0))
        fork_last = bool(shared) and len(shared) * ps > skip
        n_fresh = n_total - len(shared) + (1 if fork_last else 0)

        self.pool.ref(shared)       # hold the matches across an eviction
        try:
            fresh = self.pool.alloc(n_fresh)
        except PoolExhausted:
            if self.prefix is not None:
                self.prefix.evict(n_fresh - self.pool.free_pages)
            try:
                fresh = self.pool.alloc(n_fresh)
            except PoolExhausted:
                self.pool.release(shared)
                raise

        cow: list[tuple[int, int]] = []
        mapped = list(shared)
        if fork_last:
            src, dst = mapped[-1], fresh[0]
            mapped[-1] = dst
            cow.append((src, dst))
            self.cow_forks += 1
        pages = mapped + fresh[(1 if fork_last else 0):]
        table = np.full(self.pages_per_slot, TRASH_PAGE, np.int32)
        table[:len(pages)] = pages
        self._slot_owned[slot] = shared + fresh
        self._slot_table[slot] = pages
        self._slot_prompt[slot] = prompt
        self.pages_shared_total += len(shared)
        self.prefill_skipped_tokens += skip
        return SlotAlloc(table=table, prefill_skip=skip,
                         shared_pages=len(shared), cow_copies=cow)

    def publish(self, slot: int) -> int:
        """Seed the prefix cache with the slot's fully written prompt
        pages (on clean completion, before `release`)."""
        if self.prefix is None or self._slot_prompt[slot] is None:
            return 0
        return self.prefix.insert(self._slot_prompt[slot],
                                  self._slot_table[slot])

    def release(self, slot: int) -> list[int]:
        """Return the slot's pages (shared pages survive while referenced).
        Returns the freed page ids."""
        owned = self._slot_owned[slot]
        self._slot_owned[slot] = []
        self._slot_table[slot] = []
        self._slot_prompt[slot] = None
        return self.pool.release(owned)

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._slot_table[slot])

    def match_len(self, prompt) -> int:
        return self.prefix.match_len(prompt) if self.prefix else 0

    def stats(self) -> dict:
        out = dict(self.pool.stats())
        out.update(pages_shared=self.pages_shared_total,
                   prefill_skipped_tokens=self.prefill_skipped_tokens,
                   cow_forks=self.cow_forks)
        if self.prefix is not None:
            out.update(prefix_entries=len(self.prefix),
                       prefix_hits=self.prefix.hits,
                       prefix_misses=self.prefix.misses,
                       evictions=self.prefix.evictions)
        return out
