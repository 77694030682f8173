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
  seeds the prefix cache (stamping each published page's content
  checksum), `release` returns the pages (marking them dirty when they
  come from a corrupted slot, so that the session scrubs them before
  reuse), `verify` / `quarantine_page` / `scrub_candidates` are the
  integrity layer, and `snapshot` / `load_snapshot` round-trip every
  host-side structure through JSON for session snapshots.

Reads from stale pages are harmless (masked attention gives them
exactly-zero weight); only NaN survives the mask (0 * NaN), which is why
pages freed from a corrupted slot are scrubbed on device before reuse.
Page digests (`page_digests`) follow the port's own cache leaf order, so
they are compared within one package only.
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
        # pages that may hold NaN (freed from a corrupted slot): scrubbed
        # on device before they are handed out again
        self.dirty: set[int] = set()
        # pages whose content failed an integrity check: never re-enter
        # the free list (they count as used capacity)
        self.quarantined: set[int] = set()
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
                if p in self.quarantined:
                    continue               # fenced off: never reallocated
                self._free.append(p)
                freed.append(p)
        return freed

    def quarantine(self, page: int) -> None:
        """Fence a page off permanently: it never re-enters the free list
        (current holders drop their references normally)."""
        page = int(page)
        if page == TRASH_PAGE:
            return
        self.quarantined.add(page)
        if self.refcount[page] == 0 and page in self._free:
            self._free.remove(page)

    def mark_dirty(self, pages) -> None:
        self.dirty.update(int(p) for p in pages if p != TRASH_PAGE)

    def take_dirty_free(self) -> list[int]:
        """Dirty pages that are currently free — the scrub set. Clears
        the returned pages' dirty marks."""
        out = [p for p in sorted(self.dirty) if self.refcount[p] == 0]
        self.dirty.difference_update(out)
        return out

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "used_pages": self.used_pages,
                "free_pages": self.free_pages,
                "occupancy_pct": 100.0 * self.used_pages /
                max(self.n_pages - 1, 1),
                "allocs": self.allocs,
                "alloc_failures": self.alloc_failures,
                "quarantined_pages": len(self.quarantined)}


def _page_key(prev_key: bytes, tokens: np.ndarray) -> bytes:
    """Rolling hash chain: key of page k = H(key of page k-1 || tokens)."""
    h = hashlib.blake2b(prev_key, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def page_digests(arrays, n: int) -> list[bytes]:
    """Content checksum per page from a page-major host readback: `arrays`
    holds one numpy array per pool leaf, page axis first (what the
    session's `page_read_fn` returns). The digest of page j folds page j
    of every leaf, so any single leaf's corruption changes it."""
    host = [np.asarray(a) for a in arrays]
    out = []
    for j in range(n):
        h = hashlib.blake2b(digest_size=16)
        for a in host:
            h.update(np.ascontiguousarray(a[j]).tobytes())
        out.append(h.digest())
    return out


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
            if page == TRASH_PAGE or page in self.pool.quarantined:
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

    def drop_page(self, page: int) -> list[int]:
        """Remove every chain entry routed through `page`, and every entry
        downstream of one (a suffix is meaningless without its prefix).
        Releases their cache references; returns the pages that became
        free. Not an eviction: the eviction counter is left alone."""
        doomed = {k for k, e in self._chain.items() if e.page == page}
        changed = bool(doomed)
        while changed:
            changed = False
            for k, e in self._chain.items():
                if k not in doomed and e.parent in doomed:
                    doomed.add(k)
                    changed = True
        freed: list[int] = []
        for k in doomed:
            e = self._chain.pop(k)
            freed += self.pool.release([e.page])
        return freed

    def clear(self) -> list[int]:
        return self.evict(len(self._chain))


@dataclasses.dataclass
class SlotAlloc:
    """What `PagedKV.admit` hands the session for one slot."""

    table: np.ndarray            # (pages_per_slot,) int32 page ids
    prefill_skip: int            # prompt tokens covered by shared pages
    shared_pages: int            # pages mapped read-only from the cache
    cow_copies: list[tuple[int, int]]   # (src, dst) device page copies


class PagedKV:
    """Per-session paged-KV manager: pool + prefix cache + slot tables.

    The session calls `admit` at refill boundaries (may raise
    `PoolExhausted`), `release` whenever a slot retires and `publish`
    when a request completes cleanly. Host-side numpy throughout; the
    device only sees the table rows."""

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
        # per-page content checksums, stamped at publish (integrity)
        self.checksums: dict[int, bytes] = {}
        self.integrity_checks = 0
        self.integrity_violations = 0
        self.integrity_repairs = 0
        self._scrub_cursor = 0

    def admit(self, slot: int, prompt: np.ndarray, max_new: int, *,
              verify=None) -> SlotAlloc:
        """Build the slot's page table for `prompt` + up to `max_new`
        output tokens: shared prefix pages read-only, the rest fresh.
        Raises `PoolExhausted` (allocating nothing) when the pool cannot
        cover the fresh pages even after evicting prefix-cache entries.

        `verify(pages) -> bad_pages` is the integrity hook: matched pages
        are checked against their publish checksums before they are
        shared. A corrupt page is quarantined (its chain dropped), the
        match is retried (it now stops at the clean prefix) and the rest
        is prefilled anew: repair by recompute."""
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
        if shared and verify is not None:
            bad = list(verify(shared))
            if bad:
                for p in bad:
                    self.quarantine_page(p)
                shared = self.prefix.match(prompt) if self.prefix else []
                self.integrity_repairs += 1
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
                evicted = self.prefix.evict(n_fresh - self.pool.free_pages)
                self._purge_checksums(evicted)
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

    def publishable_pages(self, slot: int) -> list[int]:
        """The slot's fully written prompt pages: what `publish` would
        seed the prefix cache with, and what the session digests for the
        integrity stamp."""
        if self.prefix is None or self._slot_prompt[slot] is None:
            return []
        ps = self.pool.page_size
        prompt = self._slot_prompt[slot]
        n_full = min(prompt.size // ps, len(self._slot_table[slot]))
        return [p for p in self._slot_table[slot][:n_full]
                if p != TRASH_PAGE]

    def publish(self, slot: int, *,
                digests: "dict[int, bytes] | None" = None) -> int:
        """Seed the prefix cache with the slot's fully written prompt
        pages (on clean completion, before `release`). `digests` stamps
        each page's content checksum; a page that already carries a stamp
        keeps it (re-stamping a shared page from possibly corrupted
        content would mask the corruption)."""
        if self.prefix is None or self._slot_prompt[slot] is None:
            return 0
        published = self.prefix.insert(self._slot_prompt[slot],
                                       self._slot_table[slot])
        for page, digest in (digests or {}).items():
            if int(page) not in self.pool.quarantined:
                self.checksums.setdefault(int(page), digest)
        return published

    def release(self, slot: int, *, dirty: bool = False) -> list[int]:
        """Return the slot's pages (shared pages survive while referenced).
        `dirty=True` marks the freed pages for a device scrub before reuse
        (NaN corruption). Returns the freed page ids."""
        owned = self._slot_owned[slot]
        self._slot_owned[slot] = []
        self._slot_table[slot] = []
        self._slot_prompt[slot] = None
        freed = self.pool.release(owned)
        self._purge_checksums(freed)
        if dirty:
            self.pool.mark_dirty(freed)
        return freed

    # -- integrity -----------------------------------------------------------
    def _purge_checksums(self, pages) -> None:
        """Stamps die with the content: a freed page's next occupant has
        other bytes, and a stale stamp would read as corruption."""
        for p in pages:
            self.checksums.pop(int(p), None)

    def verify(self, pages, digests) -> list[int]:
        """The pages whose current digest differs from its publish stamp
        (unstamped pages are skipped)."""
        bad = []
        for p, d in zip(pages, digests):
            want = self.checksums.get(int(p))
            if want is None:
                continue
            self.integrity_checks += 1
            if d != want:
                bad.append(int(p))
        return bad

    def quarantine_page(self, page: int) -> list[int]:
        """Detected corruption on `page`: fence it off in the pool, drop
        every prefix chain routed through it and purge dead stamps. Slots
        mapping it keep running (new sharers are what this protects).
        Returns the pages the chain drop freed."""
        page = int(page)
        self.integrity_violations += 1
        self.pool.quarantine(page)         # before the drop: release()
        freed = []                         # then routes around the free list
        if self.prefix is not None:
            freed = self.prefix.drop_page(page)
        self._purge_checksums(freed)
        self.checksums.pop(page, None)
        return freed

    def scrub_candidates(self, limit: int) -> list[int]:
        """A round-robin slice of the stamped pages for the background
        integrity scrub (a few a chunk boundary: bounded cost, every
        published page re-checked in turn)."""
        pages = sorted(self.checksums)
        if not pages or limit <= 0:
            return []
        n = min(int(limit), len(pages))
        out = [pages[(self._scrub_cursor + i) % len(pages)]
               for i in range(n)]
        self._scrub_cursor = (self._scrub_cursor + n) % len(pages)
        return out

    def reset(self) -> None:
        """Forget everything (wedge recovery: the device pool was rebuilt,
        so every table, page and prefix entry is void)."""
        for s in range(self.n_slots):
            self._slot_owned[s] = []
            self._slot_table[s] = []
            self._slot_prompt[s] = None
        self.pool = PagePool(self.pool.n_pages, self.pool.page_size)
        if self.prefix is not None:
            evictions = self.prefix.evictions   # lifetime counter survives
            self.prefix = PrefixCache(self.pool)
            self.prefix.evictions = evictions
        self.checksums = {}
        self._scrub_cursor = 0

    def slot_pages(self, slot: int) -> list[int]:
        """The page ids the slot's device table addresses (table order)."""
        return list(self._slot_table[slot])

    def match_len(self, prompt) -> int:
        """Reusable prefix length in tokens: the scheduler's page-level
        admission score (peek only)."""
        return self.prefix.match_len(prompt) if self.prefix else 0

    def match_pages(self, prompt) -> int:
        """`match_len` in pages."""
        return self.match_len(prompt) // self.pool.page_size

    # -- durability ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able image of every host-side structure (the reference's
        keys): pool refcounts, free list, dirty and quarantine sets, slot
        tables and prompts, the prefix chain, checksums, counters.
        Bit-exact round trip with `load_snapshot`."""
        pre = self.prefix
        return {
            "refcount": self.pool.refcount.tolist(),
            "free": list(self.pool._free),
            "dirty": sorted(self.pool.dirty),
            "quarantined": sorted(self.pool.quarantined),
            "allocs": self.pool.allocs,
            "alloc_failures": self.pool.alloc_failures,
            "slot_owned": [list(o) for o in self._slot_owned],
            "slot_table": [list(t) for t in self._slot_table],
            "slot_prompt": [None if p is None else p.tolist()
                            for p in self._slot_prompt],
            "chain": None if pre is None else [
                {"key": k.hex(), "parent": e.parent.hex(), "page": e.page,
                 "tokens": e.tokens.tolist(), "hits": e.hits,
                 "last_used": e.last_used}
                for k, e in pre._chain.items()],
            "prefix_hits": 0 if pre is None else pre.hits,
            "prefix_misses": 0 if pre is None else pre.misses,
            "prefix_evictions": 0 if pre is None else pre.evictions,
            "prefix_tick": 0 if pre is None else pre._tick,
            "checksums": {str(p): d.hex()
                          for p, d in sorted(self.checksums.items())},
            "pages_shared_total": self.pages_shared_total,
            "prefill_skipped_tokens": self.prefill_skipped_tokens,
            "cow_forks": self.cow_forks,
            "integrity_checks": self.integrity_checks,
            "integrity_violations": self.integrity_violations,
            "integrity_repairs": self.integrity_repairs,
            "scrub_cursor": self._scrub_cursor,
        }

    def load_snapshot(self, d: dict) -> None:
        """Rebuild the pool, cache and tables in place from `snapshot()`."""
        pool = self.pool
        pool.refcount = np.asarray(d["refcount"], np.int32)
        pool._free = [int(p) for p in d["free"]]
        pool.dirty = {int(p) for p in d["dirty"]}
        pool.quarantined = {int(p) for p in d.get("quarantined", [])}
        pool.allocs = int(d["allocs"])
        pool.alloc_failures = int(d["alloc_failures"])
        self._slot_owned = [[int(p) for p in o] for o in d["slot_owned"]]
        self._slot_table = [[int(p) for p in t] for t in d["slot_table"]]
        self._slot_prompt = [None if p is None else np.asarray(p, np.int32)
                             for p in d["slot_prompt"]]
        pre = self.prefix
        if pre is not None:
            pre._chain = {
                bytes.fromhex(rec["key"]): _PrefixEntry(
                    int(rec["page"]), np.asarray(rec["tokens"], np.int32),
                    bytes.fromhex(rec["parent"]), int(rec["hits"]),
                    last_used=int(rec.get("last_used", 0)))
                for rec in (d["chain"] or [])}
            pre.hits = int(d.get("prefix_hits", 0))
            pre.misses = int(d.get("prefix_misses", 0))
            pre.evictions = int(d.get("prefix_evictions", 0))
            pre._tick = int(d.get("prefix_tick", 0))
        self.checksums = {int(p): bytes.fromhex(h)
                          for p, h in d.get("checksums", {}).items()}
        self.pages_shared_total = int(d["pages_shared_total"])
        self.prefill_skipped_tokens = int(d["prefill_skipped_tokens"])
        self.cow_forks = int(d["cow_forks"])
        self.integrity_checks = int(d.get("integrity_checks", 0))
        self.integrity_violations = int(d.get("integrity_violations", 0))
        self.integrity_repairs = int(d.get("integrity_repairs", 0))
        self._scrub_cursor = int(d.get("scrub_cursor", 0))

    def stats(self) -> dict:
        out = dict(self.pool.stats())
        out.update(pages_shared=self.pages_shared_total,
                   prefill_skipped_tokens=self.prefill_skipped_tokens,
                   cow_forks=self.cow_forks,
                   integrity_checks=self.integrity_checks,
                   integrity_violations=self.integrity_violations,
                   integrity_repairs=self.integrity_repairs)
        if self.prefix is not None:
            out.update(prefix_entries=len(self.prefix),
                       prefix_hits=self.prefix.hits,
                       prefix_misses=self.prefix.misses,
                       evictions=self.prefix.evictions)
        return out
