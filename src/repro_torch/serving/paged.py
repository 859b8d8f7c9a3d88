"""Host-side page-pool allocator for the paged NxFP KV cache.

The port's own copy of the reference's ``serving/paged.py`` (no import of
it): a free-list allocator with refcounted pages, a content-keyed
shared-prefix registry and copy-on-write bookkeeping. Nothing here touches
torch. The device half (pool buffers, the block table, writes and the
gathered view through it) lives in ``models/kvcache.py`` and
``models/lm.py``; ``serving/paged_engine.py`` mirrors every allocator
decision into the device block table.

Layout invariants the allocator relies on:

- Physical page 0 is the NULL page: permanently reserved, never
  allocated, never legitimately read. Block-table entries of unreserved
  logical pages point at it, and every device write that resolves to it
  is dropped, so garbage can only be read where attention gives it an
  exactly zero share.
- A page holds ``page_size`` whole KV rows. NxFP pack blocks run along
  head_dim within a row, so a row's packed bytes and meta move with it.
- Pages are refcounted. ``refs[p]`` counts holders: slots whose block
  table maps p, plus one per prefix-registry entry listing p. A page
  returns to the free list when its count reaches zero.

Prefix sharing is memory dedupe, not compute dedupe: a claimant's own
prefill rewrites claimed pages with byte-identical rows (KV rows are
deterministic functions of the token prefix, the weights and the rope
positions), so no skip-this-page flag reaches a kernel. Registered pages
stay pristine because any holder about to diverge (a sliding-window slot
wrapping its ring into shared pages) is copy-on-write-broken onto fresh
pages first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PagePool", "auto_page_size", "NULL_PAGE"]

# Physical page index reserved as the never-allocated null target.
NULL_PAGE = 0


def auto_page_size(rows: int, preferred: int = 32) -> int:
    """Largest divisor of ``rows`` that is ≤ ``preferred``.

    The paged layout requires the per-slot row capacity (sliding window
    or max_len) to be a whole number of pages; this picks the page size
    closest to the preferred granularity that tiles exactly.
    """
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    for cand in range(min(preferred, rows), 0, -1):
        if rows % cand == 0:
            return cand
    return 1  # unreachable: 1 divides everything


class PagePool:
    """Free-list page allocator with refcounts, prefix registry, and COW.

    One pool per engine. All indices are physical page numbers of the
    engine's pool buffers; page 0 is the null page.

    ``allocate``/``release`` are the slot lifecycle; ``register_prefix``
    publishes a finished allocation's page-aligned prompt prefix for
    future claims; ``cow_break`` privatizes a slot's shared pages before
    a divergent write.  Counters feed the ``pool`` / ``prefix-hit`` /
    ``cow-break`` JSONL events and ``pool_stats()`` engine metrics.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null page), "
                f"got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list; page 0 excluded for good (null page).
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._refs: List[int] = [0] * self.n_pages
        self._refs[NULL_PAGE] = 1  # pinned
        # How many of each page's refs are registry holds (for
        # freeable-under-eviction accounting).
        self._registry_holds: List[int] = [0] * self.n_pages
        # slot -> physical pages in logical order.
        self._slots: Dict[int, List[int]] = {}
        # slot -> pages held aside for a guaranteed future COW break
        # (a wrap-capable SWA claimant reserves one replacement per
        # claimed shared page at allocation, so privatizing at the wrap
        # can never hit an exhausted pool).
        self._cow_reserve: Dict[int, List[int]] = {}
        # token-tuple -> physical pages of that page-aligned prefix.
        # Insertion-ordered; claims re-touch entries so eviction is LRU.
        self._registry: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        # Counters (exposed via stats()).
        self.high_watermark = 0
        self.cow_breaks = 0
        self.prefix_hits = 0
        self.prefix_pages_shared = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # accounting

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the null page)."""
        return self.n_pages - 1

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    @property
    def free(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        """In-use fraction of allocatable pages, in [0, 1]."""
        return self.used / self.capacity if self.capacity else 1.0

    def pages_for_rows(self, rows: int) -> int:
        return -(-max(int(rows), 0) // self.page_size)

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's physical pages in logical order (copy)."""
        return list(self._slots.get(slot, ()))

    def holds(self, slot: int) -> bool:
        """Does ``slot`` currently hold an allocation (possibly empty)?"""
        return slot in self._slots

    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "used": self.used,
            "free": self.free,
            "occupancy": self.occupancy(),
            "high_watermark": self.high_watermark,
            "cow_breaks": self.cow_breaks,
            "prefix_hits": self.prefix_hits,
            "prefix_pages_shared": self.prefix_pages_shared,
            "registry_entries": len(self._registry),
            "evictions": self.evictions,
            "live_slots": len(self._slots),
            "cow_reserved": sum(len(r) for r in self._cow_reserve.values()),
        }

    # ------------------------------------------------------------------
    # ref plumbing

    def _incref(self, page: int) -> None:
        self._refs[page] += 1

    def _decref(self, page: int) -> None:
        assert page != NULL_PAGE, "null page is never released"
        self._refs[page] -= 1
        assert self._refs[page] >= 0, f"page {page} over-released"
        if self._refs[page] == 0:
            self._free.append(page)

    def _freeable(self, exclude: Sequence[int] = ()) -> int:
        """Pages recoverable by evicting every EVICTABLE registry entry.

        Eviction is entry-granular: an entry listing any page in
        ``exclude`` (pages a pending claim is about to pin) cannot be
        evicted, so its holds pin ALL its pages.  A page is freeable iff
        every ref on it comes from an evictable entry — mirroring what
        ``_evict_for`` can actually recover, so ``would_fit`` never
        promises an allocation ``allocate`` would refuse.
        """
        ex = set(exclude)
        evictable_holds = [0] * self.n_pages
        for pages in self._registry.values():
            if ex.intersection(pages):
                continue
            for p in pages:
                evictable_holds[p] += 1
        return sum(1 for p in range(1, self.n_pages)
                   if self._refs[p] > 0
                   and self._refs[p] == evictable_holds[p])

    # ------------------------------------------------------------------
    # prefix registry

    def _claim_lookup(self, tokens: Sequence[int],
                      max_pages: int) -> Tuple[int, List[int]]:
        """Longest registered page-aligned prefix of ``tokens``.

        Returns (n_pages, pages) without taking refs; (0, []) on miss.
        """
        ps = self.page_size
        top = min(len(tokens) // ps, max_pages)
        for m in range(top, 0, -1):
            key = tuple(tokens[:m * ps])
            pages = self._registry.get(key)
            if pages is not None:
                # LRU touch: move to the end of the eviction order.
                del self._registry[key]
                self._registry[key] = pages
                return m, list(pages)
        return 0, []

    def claimable(self, tokens: Optional[Sequence[int]],
                  max_pages: int) -> int:
        """Pages a claim on ``tokens`` would cover, without side effects."""
        if tokens is None:
            return 0
        ps = self.page_size
        top = min(len(tokens) // ps, max_pages)
        for m in range(top, 0, -1):
            if tuple(tokens[:m * ps]) in self._registry:
                return m
        return 0

    def register_prefix(self, tokens: Sequence[int], slot: int) -> int:
        """Publish the slot's page-aligned prompt prefix for future claims.

        One registry entry per prefix length (so a later prompt sharing
        only part of the prefix still hits), each holding its own ref on
        the pages it lists.  Already-registered prefixes are skipped.
        Returns the number of new entries.
        """
        row = self._slots.get(slot)
        if row is None:
            return 0
        ps = self.page_size
        added = 0
        for m in range(1, len(tokens) // ps + 1):
            if m > len(row):
                break
            key = tuple(tokens[:m * ps])
            if key in self._registry:
                continue
            pages = tuple(row[:m])
            self._registry[key] = pages
            for p in pages:
                self._incref(p)
                self._registry_holds[p] += 1
            added += 1
        return added

    def _evict_entry(self, key: Tuple[int, ...]) -> None:
        for p in self._registry.pop(key):
            self._registry_holds[p] -= 1
            self._decref(p)
        self.evictions += 1

    def drop_prefixes(self) -> int:
        """Evict every registry entry (frees registry-only pages)."""
        n = len(self._registry)
        for key in list(self._registry):
            self._evict_entry(key)
        return n

    def _evict_for(self, need: int, protect: Sequence[int] = ()) -> bool:
        """Evict LRU registry entries until ``need`` pages are free.

        Entries whose pages are in ``protect`` (a pending claim) are
        skipped.  Returns True once satisfied.
        """
        if len(self._free) >= need:
            return True
        guard = set(protect)
        for key in list(self._registry):  # insertion order == LRU order
            if guard.intersection(self._registry[key]):
                continue
            self._evict_entry(key)
            if len(self._free) >= need:
                return True
        return len(self._free) >= need

    # ------------------------------------------------------------------
    # slot lifecycle

    def would_fit(self, n_logical: int,
                  tokens: Optional[Sequence[int]] = None,
                  reserve: bool = False) -> bool:
        """Could ``allocate(slot, n_logical, tokens, reserve)`` succeed?

        Counts shared-prefix credit and registry-evictable pages; takes
        no refs and evicts nothing.  With ``reserve`` the claim yields
        no capacity credit — every claimed page is matched by a held-
        aside COW replacement, so the physical need stays ``n_logical``.
        """
        if n_logical <= 0:
            return True
        m, pages = (0, [])
        if tokens is not None:
            m = self.claimable(tokens, n_logical)
            if m:
                pages = list(self._registry[tuple(tokens[:m * self.page_size])])
        fresh = n_logical if reserve else n_logical - m
        return len(self._free) + self._freeable(exclude=pages) >= fresh

    def allocate(self, slot: int, n_logical: int,
                 tokens: Optional[Sequence[int]] = None,
                 reserve: bool = False) -> Optional[List[int]]:
        """Reserve ``n_logical`` pages for ``slot``; None if it can't fit.

        Claims the longest registered prefix of ``tokens`` first (those
        pages are shared, refcount bumped), then draws the rest from the
        free list, evicting LRU registry entries on shortage.  With
        ``reserve`` (a claimant that WILL diverge — an SWA ring that
        outlives its window) one replacement page per claimed page is
        additionally drawn and held aside, making the later
        ``cow_break`` exhaustion-proof at the cost of the claim's
        capacity credit.  On success returns the slot's physical pages
        in logical order; on failure the pool is left exactly as it was
        (modulo LRU evictions probed on the way).
        """
        if slot in self._slots:
            raise RuntimeError(f"slot {slot} already holds pages")
        if n_logical <= 0:
            self._slots[slot] = []
            return []
        claimed: List[int] = []
        m = 0
        if tokens is not None:
            m, claimed = self._claim_lookup(tokens, n_logical)
        fresh_needed = (n_logical - m) + (m if reserve else 0)
        if not self._evict_for(fresh_needed, protect=claimed):
            return None  # no refs were taken; lookup touch is harmless
        for p in claimed:
            self._incref(p)
        row = claimed + [self._free.pop() for _ in range(n_logical - m)]
        for p in row[m:]:
            assert self._refs[p] == 0
            self._refs[p] = 1
        if reserve and m:
            held = [self._free.pop() for _ in range(m)]
            for p in held:
                assert self._refs[p] == 0
                self._refs[p] = 1
            self._cow_reserve[slot] = held
        self._slots[slot] = row
        if m:
            self.prefix_hits += 1
            self.prefix_pages_shared += m
        self.high_watermark = max(self.high_watermark, self.used)
        return list(row)

    def release(self, slot: int) -> int:
        """Drop the slot's holds; pages with no other holder return to
        the free list.  Returns the number of pages released."""
        row = self._slots.pop(slot, None)
        if row is None:
            return 0
        for p in self._cow_reserve.pop(slot, ()):
            self._decref(p)
        for p in row:
            self._decref(p)
        return len(row)

    # ------------------------------------------------------------------
    # copy-on-write

    def shared_pages(self, slot: int) -> List[Tuple[int, int]]:
        """(logical_index, physical_page) pairs the slot shares.

        A page is shared when some other holder (another slot or a
        registry entry) also refs it — writing to it would be visible
        outside this slot.
        """
        row = self._slots.get(slot, ())
        return [(i, p) for i, p in enumerate(row) if self._refs[p] > 1]

    def has_shared(self, slot: int) -> bool:
        return bool(self.shared_pages(slot))

    def cow_break(self, slot: int) -> List[Tuple[int, int, int]]:
        """Privatize every shared page of ``slot``.

        For each shared page: allocate a fresh page, remap the slot's
        table entry, and drop the slot's hold on the original (which
        stays alive under its other holders, pristine).  Returns
        (logical_index, old_phys, new_phys) triples — the caller must
        device-copy old→new and update the device block table.  Raises
        RuntimeError if the pool (after registry eviction) can't supply
        the copies; the already-broken prefix of the list is kept.
        """
        broken: List[Tuple[int, int, int]] = []
        row = self._slots.get(slot)
        if row is None:
            return broken
        held = self._cow_reserve.get(slot, [])
        for i, old in enumerate(row):
            if self._refs[old] <= 1:
                continue
            if held:
                new = held.pop()        # pre-reserved: already refs == 1
            else:
                if not self._evict_for(1, protect=row):
                    raise RuntimeError(
                        f"page pool exhausted during COW break of slot "
                        f"{slot} ({len(broken)} of its shared pages "
                        f"already broken)")
                new = self._free.pop()
                assert self._refs[new] == 0
                self._refs[new] = 1
            row[i] = new
            self._decref(old)
            broken.append((i, old, new))
        if not held:
            self._cow_reserve.pop(slot, None)
        if broken:
            self.cow_breaks += len(broken)
            self.high_watermark = max(self.high_watermark, self.used)
        return broken

    # ------------------------------------------------------------------
    # leak checking

    def leaked(self) -> int:
        """Pages still pinned by live slots, plus in-use pages no slot
        or registry entry accounts for (0 unless invariants broke).

        With every slot released and the registry dropped, a healthy
        pool has ``leaked() == 0`` and ``used == 0``.
        """
        slot_held = sum(len(r) for r in self._slots.values())
        slot_held += sum(len(r) for r in self._cow_reserve.values())
        accounted = set()
        for r in self._slots.values():
            accounted.update(r)
        for r in self._cow_reserve.values():
            accounted.update(r)
        for pages in self._registry.values():
            accounted.update(pages)
        orphans = [p for p in range(1, self.n_pages)
                   if self._refs[p] > 0 and p not in accounted]
        return len(orphans) + slot_held

    def assert_empty(self) -> None:
        """Assert no slot holds pages and (post drop_prefixes) all pages
        are free — the leak-on-finish check."""
        if self._slots:
            raise AssertionError(
                f"page leak: slots {sorted(self._slots)} still hold pages")
        self.drop_prefixes()
        if self.used != 0:
            held = [p for p in range(1, self.n_pages) if self._refs[p] > 0]
            raise AssertionError(f"page leak: pages {held} still referenced "
                                 f"with no live slot or registry entry")
