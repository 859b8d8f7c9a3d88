"""Paged NxFP KV cache: the block-table serving engine.

``ContinuousEngine`` preallocates every slot's KV arena at ``max_len`` (or
the sliding window), so device memory is budgeted for the worst case
whether or not a request ever reaches it. ``PagedContinuousEngine`` (the
reference's ``serving/paged_engine.py``) keeps the same host loop, the
same decode and lane graphs and the same bitwise guarantees, but keeps
attention KV in a physical page pool indexed through per-slot block
tables: a request pins only ``ceil(min(prompt + max_new, window) /
page_size)`` pages, so a fixed KV budget holds several times the dense
engine's requests in flight, and requests that share a prompt prefix
share its pages.

The split of responsibilities:

- ``serving/paged.py`` ``PagePool`` (host, no torch): free-list
  allocation, refcounts, the shared-prefix registry, COW accounting.
- ``models/kvcache.py`` and ``models/lm.py`` (device): the pool buffers,
  one (B, P) int32 block table shared by every layer, the K/V writes
  through it (the quantizer's ``block`` argument for a packed cache) and
  the gathered view decode attention reads.
- this module (the glue): every allocator decision is mirrored into the
  device table (``_write_table``: one row, a pinned host row copied
  without blocking on the engine's stream), and every retirement path
  releases its pages through ``_reset_dispatch``.

On CUDA the pools and the table are static buffers that the decode and
lane graphs capture once: a table write is an in-place copy of one row,
a COW an in-place page copy, both on the engine's stream between replays,
so pages move without a recapture.

Bitwise contract: the dense engine stays the oracle. A slot's logical
rows are the dense layout's (window-sized ring or ``max_len``), the
gathered view is the dense cache bit for bit on valid rows, and garbage
rows (null or stale pages) are read only where attention gives them an
exactly zero share, so every stream is the dense engine's, whole and
chunked.

Prefix sharing is memory dedupe, not compute dedupe: a claimant's prefill
computes the shared rows as its own but writes only its private pages.
Until it is armed its table row holds ``NULL_PAGE`` in the claimed
entries, so those rows drop, whole or through the lane (whose attention
reads the lane's scratch, not the cache), and no prefill ever writes a
page another request reads. The claimed pages must then hold the bits
the claimant's own prefill gives them: on the card the GEMMs sum a row in
one order up to 16 rows and in another above (ROADMAP C3), so a
whole-prompt admission of at most ``DENSE_SMALL_M`` tokens neither
registers nor claims a prefix (``_share_terms``), and every lane chunk
runs at the lane's fixed width. A sliding-window claimant that may outlive its
window reserves one replacement page per claimed page at admission and
is copy-on-write-privatized (``_cow_sweep``) before any dispatch whose
write horizon could wrap into shared pages: registry pages are never
overwritten, and the break can never find the pool exhausted.

Families: the pages hold attention K/V only. A hybrid model
(``hymba_1_5b``) shares and copies its attention pages as the dense family
does, while its Mamba state stays per slot: a claimant's prefill still
computes its own state over the whole prompt. An attention-free model
(``falcon_mamba_7b``) has no K/V rows, so it has no pages: the engine
builds no pool (``pool`` is None), no table and no page gate, and keeps
``ContinuousEngine``'s steps (``_PAGE_STEPS``), decided once at
construction.

Speculative rounds (``speculative=``, the dense engine's option, its
graphs and counters): a round's draft and verify write rows ``pos .. pos
+ k`` through the block table, and what the round must put back is saved
and restored on the pools (``kvcache.save_rows``/``restore_rows``, the
table read on the device inside the round's graph). Reservations stay
tenancy-sized: a row past a request's pages maps to the null page, where
the K/V write drops it and nothing is saved or put back. The write
horizon of a dispatch is ``max(chunk, k + 1)`` (``_horizon_bound``), which
a ring claimant's reservation and the COW sweep read. The streams are the
dense engine's; ``spec_stats()`` is too, unless a live round reaches past
a request's pages: its rows there read the null page, and the candidates
it accepts past the budget (counted, never emitted) may differ.

Suspension and checkpoints: a snapshot of a paged slot is read through
its table into the dense layout (``models.read_cache_slot``), so it is the
dense engine's snapshot byte for byte, and a restore (``_restore_dispatch``)
allocates the slot's pages unshared (its rows leave any registered prefix
as soon as it decodes on) and writes the rows through the table; the
zero padding past the allocation drops on null entries. A checkpoint taken
on either layout restores on the other.

Faults: the finite-logits sentinel and quarantine run through the paged
dispatch, plain and speculative; a quarantined slot's pages go back to
the pool through ``_reset_dispatch``. ``kv_integrity`` is refused, as the
reference's: the K/V canary pins a slot-private stable prefix, which
prefix sharing breaks on purpose (and ``flip_kv_bytes`` raises on the
pools).

``ShardedPagedContinuousEngine`` serves the slot-sharded engine
(``serving/sharded.py``) over a page pool a shard: each shard is a paged
engine of its own, its table holding its pool's local page indices and
its own null page 0, and admission goes to the least-loaded shard whose
pool fits the request. It serves no prefix sharing, as the reference's
does not. Paged tiers are left for later (the reference has none).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.qtensor import QuantPolicy
from ..kernels.build import bit_view
from ..kernels.ops import DENSE_SMALL_M
from ..models import init_paged_cache
from ..models.common import ModelConfig
from .paged import NULL_PAGE, PagePool, auto_page_size
from .scheduler import ContinuousEngine, Request, SlotScheduler
from .sharded import ShardedContinuousEngine, _ShardMixin

__all__ = ["PagedContinuousEngine", "ShardedPagedContinuousEngine"]

# the steps the pages change; an attention-free model keeps
# ContinuousEngine's (it has no K/V rows to page)
_PAGE_STEPS = ("_init_slot_cache", "_make_sched", "_reset_dispatch",
               "_admit_dispatch", "_start_prefill", "_arm_slot",
               "_dispatch_chunk", "_restore_dispatch")


def _copy_page_fn(cache, src: int, dst: int):
    """Device copy of one physical page, src -> dst, in every pool buffer
    of every layer (in place): the COW primitive. The new page holds the
    old page's bytes verbatim (packed codes and meta alike), so the
    claimant's gathered view does not change with the remap."""
    for layer in cache["layers"]:
        for name, buf in layer.items():
            if name.startswith("pool_"):
                buf = bit_view(buf)          # uint16 meta copies as int16
                buf[dst].copy_(buf[src])
    return cache


class PagedContinuousEngine(ContinuousEngine):
    """``ContinuousEngine`` over a paged KV cache with prefix sharing.

    Same request semantics and host loop as the dense engine; admission is
    also gated on free pages (``SlotScheduler.admission_gate``), so a free
    slot without free pages queues the request. ``n_pages`` defaults to
    the dense engine's footprint (every slot can hold its full row
    capacity, plus the null page); provision fewer to serve more slots
    than the dense layout could back. ``page_size`` must divide the slot
    row capacity (``auto_page_size`` picks the largest divisor <= 32).

    ``prefix_sharing`` keys page-aligned prompt prefixes by content: an
    admission whose prompt extends a registered prefix maps the shared
    pages instead of drawing fresh ones (refcounted, LRU-evicted,
    COW-broken before any divergent write). The KV pool feeds
    ``DegradeOverBudget(pool_watermark=)`` through
    ``SlotScheduler.pool_monitor``.
    """

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 n_slots: int = 4, max_len: int = 2048,
                 n_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefix_sharing: bool = True, **kw):
        if kw.get("kv_integrity"):
            raise ValueError(
                "kv_integrity is not served by the paged engine: the KV "
                "canary pins a slot-private stable prefix, which prefix "
                "sharing deliberately violates")
        rows = cfg.sliding_window if cfg.sliding_window else max_len
        if page_size is None:
            page_size = auto_page_size(rows)
        if rows % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the slot row capacity "
                f"{rows} (sliding window or max_len)")
        if n_pages is None:
            n_pages = self._default_n_pages(n_slots, rows // page_size)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.prefix_sharing = bool(prefix_sharing)
        self._table_width = rows // self.page_size
        if cfg.attn_free:
            self.pool = None
            for name in _PAGE_STEPS:
                setattr(self, name,
                        getattr(ContinuousEngine, name).__get__(self))
        else:
            self._make_pools()
        super().__init__(cfg, params, policy, n_slots=n_slots,
                         max_len=max_len, **kw)

    # -- pool plumbing --------------------------------------------------------

    def _default_n_pages(self, n_slots: int, per_slot: int) -> int:
        """Dense-equivalent provisioning: every slot can hold its full
        logical capacity, plus the reserved null page."""
        return n_slots * per_slot + 1

    def _make_pools(self) -> None:
        self.pool = PagePool(self.n_pages, self.page_size)
        # slots whose table row still nulls their claimed pages
        self._unarmed_claims = set()

    def _pool_monitor(self) -> float:
        """Pool occupancy in [0, 1], for a shedding policy's watermark."""
        return self.pool.occupancy()

    def pool_stats(self) -> List[Dict[str, Any]]:
        """The allocator's counters (occupancy, high watermark, COW breaks,
        prefix hits, evictions), one dict per pool (the reference's list;
        ``shard`` None: one pool, the sharded engine's are per shard)."""
        st = self.pool.stats()
        st["shard"] = None
        return [st]

    def _emit_pool(self, shard: Optional[int] = None) -> None:
        st = self.pool.stats()
        self._emit("pool", shard=shard, used=st["used"], free=st["free"],
                   occupancy=round(st["occupancy"], 4),
                   hwm=st["high_watermark"], shared=st["prefix_pages_shared"],
                   chunk=self.chunks)

    # -- sizing and sharing policy --------------------------------------------

    def _pages_for(self, tokens_len: int, max_new: int) -> int:
        """Logical pages a request needs for its whole tenancy."""
        rows = tokens_len + max_new
        w = self.cfg.sliding_window
        if w:
            rows = min(rows, w)
        return -(-rows // self.page_size)

    def _horizon_bound(self) -> int:
        """Rows one slot may write past ``pos`` in one decode dispatch,
        overshoot after it finished included: the chunk, and for a
        speculative round the k + 1 rows its verify writes (a chunk of
        ``max(1, chunk // (k + 1))`` rounds writes no further)."""
        if self.speculative is None:
            return self.chunk
        return max(self.chunk, self.speculative.k + 1)

    def _share_terms(self, req: Request):
        """(claim tokens, reserve, register_ok) of one fresh admission.

        A prompt takes part in sharing when sharing is on, it spans at
        least one page, (a sliding window) it fits the window, since a
        wrapping prefill would rewrite claimed pages with other rows, and
        (whole-prompt admission) it has more than ``DENSE_SMALL_M``
        tokens: a shorter prefill runs both GEMMs in their small-M
        regime, so its prompt rows are other bits than a longer prompt's
        (every lane chunk runs at the lane's width, one regime for all).
        ``reserve`` marks a claimant whose decode may wrap (prompt +
        budget + one dispatch's overshoot past the window): it draws one
        COW replacement per claimed page up front, and its own prefix is
        not registered (its pages stop being prefix content at the wrap).
        """
        t = len(req.tokens)
        w = self.cfg.sliding_window
        if not (self.prefix_sharing and t >= self.page_size
                and (not w or t <= w)
                and (self.prefill_mode == "chunked" or t > DENSE_SMALL_M)):
            return None, False, False
        can_wrap = bool(w) and t + req.max_new + self._horizon_bound() > w
        return list(req.tokens), can_wrap, not can_wrap

    def _admission_gate(self, req: Request, shard: Optional[int],
                        resumable: bool) -> bool:
        """Page-availability gate the scheduler consults after its pick."""
        n = self._pages_for(len(req.tokens), req.max_new)
        if resumable:           # restores never share (divergent rows)
            return self.pool.would_fit(n)
        tokens, reserve, _ = self._share_terms(req)
        return self.pool.would_fit(n, tokens=tokens, reserve=reserve)

    # -- allocator <-> device table -------------------------------------------

    def _write_table(self, slot: int, pages: Sequence[int]) -> None:
        """Commit slot ``slot``'s table row (NULL_PAGE past its pages) in
        place: on CUDA a copy from a fresh pinned host row, not blocking,
        on the engine's stream, so it lands after the last replay and
        before the next (the caching host allocator keeps the row until
        the copy has run)."""
        row = np.full((self._table_width,), NULL_PAGE, np.int32)
        row[:len(pages)] = pages
        host = torch.from_numpy(row)
        dst = self.cache["layers"][0]["block"][slot]
        if dst.is_cuda:
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)

    def _alloc_slot(self, slot: int, req: Request, share: bool = True) -> None:
        """Pin a request's pages and mirror them into the block table, the
        claimed entries as ``NULL_PAGE`` until ``_arm_slot`` (the prefill
        writes only the slot's private pages)."""
        pool = self.pool
        n = self._pages_for(len(req.tokens), req.max_new)
        tokens, reserve, _ = (self._share_terms(req) if share
                              else (None, False, False))
        m = pool.claimable(tokens, n) if tokens is not None else 0
        row = pool.allocate(slot, n, tokens=tokens, reserve=reserve)
        if row is None:
            # the gate ran on this request with this pool, and nothing
            # allocates between the gate and here
            raise RuntimeError(
                f"page pool exhausted admitting uid={req.uid} into slot "
                f"{slot} ({n} pages needed, {pool.free} free)")
        self._write_table(slot, [NULL_PAGE] * m + row[m:])
        if m:
            self._unarmed_claims.add(slot)
            self._emit("prefix-hit", uid=req.uid, slot=slot, shard=None,
                       pages=m, rows=m * self.page_size,
                       reserved=m if reserve else 0)
        self._emit_pool()

    # -- engine hooks -----------------------------------------------------------

    def _init_slot_cache(self):
        return init_paged_cache(self.cfg, self.n_slots, self.max_len,
                                self.policy.kv_fmt, self.n_pages,
                                self.page_size, device=self.device)

    def _reclaim_pages(self) -> None:
        """Release what an aborted serve left (an exception mid-flight):
        its pages go back and its table rows are nulled, so that a parked
        slot's writes drop instead of landing in pages a new request may
        be handed."""
        for slot in list(self.pool._slots):
            self.pool.release(slot)
            self._write_table(slot, [])
        self._unarmed_claims.clear()

    def _make_sched(self) -> SlotScheduler:
        sched = super()._make_sched()
        self._reclaim_pages()
        sched.admission_gate = self._admission_gate
        sched.pool_monitor = self._pool_monitor
        return sched

    def _reset_dispatch(self, slot: int) -> None:
        super()._reset_dispatch(slot)
        self._unarmed_claims.discard(slot)
        if self.pool.holds(slot):
            self.pool.release(slot)
            self._write_table(slot, [])
            self._emit_pool()

    def _admit_dispatch(self, slot: int, req: Request) -> int:
        self._alloc_slot(slot, req)
        return super()._admit_dispatch(slot, req)

    def _start_prefill(self, sched: SlotScheduler, slot: int, req: Request,
                       now: float) -> Dict[str, Any]:
        self._alloc_slot(slot, req)
        return super()._start_prefill(sched, slot, req, now)

    def _restore_dispatch(self, slot: int, snap) -> None:
        """A restored slot re-enters unshared (its rows leave any
        registered prefix as soon as it decodes on): its pages are
        allocated fresh, then the snapshot, padded to the slot's capacity,
        is written through the table, and the rows past the allocation
        drop on null entries."""
        self._alloc_slot(slot, snap.req, share=False)
        super()._restore_dispatch(slot, snap)

    def _arm_slot(self, slot: int, req: Request, tok0: int) -> None:
        super()._arm_slot(slot, req, tok0)
        if slot in self._unarmed_claims:    # its prefill is written: map
            self._unarmed_claims.discard(slot)          # the shared pages
            self._write_table(slot, self.pool.slot_pages(slot))
        _, _, register_ok = self._share_terms(req)
        if register_ok and self.pool.register_prefix(req.tokens, slot):
            self._emit_pool()

    def _dispatch_chunk(self, poison: np.ndarray):
        self._cow_sweep()
        return super()._dispatch_chunk(poison)

    def _cow_sweep(self) -> None:
        """Privatize the shared pages of any slot whose next dispatch could
        wrap its ring into them.

        Runs before every decode dispatch with the dispatch's write
        horizon: a slot at ``pos`` may write rows ``pos .. pos + horizon -
        1`` (mod window), so ``pos + horizon > window`` is the first moment
        shared pages are in reach, overshoot after the request finished
        included. Slots without a window never write shared pages (decode
        rows land past the page-aligned shared prefix), so the sweep is
        for sliding windows only. Reads ``pos`` on the host when a slot
        holds shared pages.
        """
        w = self.cfg.sliding_window
        if not w or not self.prefix_sharing:
            return
        holders = [s for s in range(self.n_slots) if self.pool.has_shared(s)]
        if not holders:
            return
        hz = self._horizon_bound()
        pos = self.cache["pos"].cpu().numpy()
        for slot in holders:
            if int(pos[slot]) + hz <= w:
                continue
            pairs = self.pool.cow_break(slot)
            for _, old, new in pairs:
                _copy_page_fn(self.cache, old, new)
            self._unarmed_claims.discard(slot)
            self._write_table(slot, self.pool.slot_pages(slot))
            self._emit("cow-break", slot=slot, shard=None, pages=len(pairs),
                       pos=int(pos[slot]), chunk=self.chunks)
            self._emit_pool()


class _PagedShard(_ShardMixin, PagedContinuousEngine):
    pass


class ShardedPagedContinuousEngine(ShardedContinuousEngine):
    """Slot-sharded serving over a page pool a shard (the reference's
    ``ShardedPagedContinuousEngine``): each shard is a paged engine of its
    slots, its pool of ``n_pages / S`` pages with local page indices and
    its own null page 0 (default: the dense footprint of its slots, plus
    that page). Admission asks the page gate of each candidate shard and
    takes the least-loaded shard whose pool fits the request.
    ``prefix_sharing`` is refused, as the reference refuses it: a
    registry a shard would share only within the shard. ``pool_stats()``
    has one row a shard; ``pools`` are the shards' pools (empty for an
    attention-free model, which has no pages)."""

    _shard_cls = _PagedShard

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy, mesh,
                 n_slots: int = 4, n_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefix_sharing: bool = False, **kw):
        if prefix_sharing:
            raise ValueError(
                "prefix_sharing is not served sharded: the registry and "
                "COW copy are engine-global, pools are per-shard")
        s = int(mesh.shape["data"]) if "data" in mesh.axis_names else 1
        if n_pages is not None and n_pages % s:
            raise ValueError(f"n_pages ({n_pages}) must be divisible by "
                             f"the 'data' axis ({s}): a pool a shard")
        self._pages_kw = dict(
            n_pages=None if n_pages is None else n_pages // s,
            page_size=page_size, prefix_sharing=False)
        super().__init__(cfg, params, policy, mesh, n_slots=n_slots, **kw)
        self.page_size = self.shards[0].page_size
        self.n_pages = sum(sh.n_pages for sh in self.shards)

    def _shard_kw(self) -> Dict[str, Any]:
        return self._pages_kw

    @property
    def pools(self) -> List[PagePool]:
        return [sh.pool for sh in self.shards if sh.pool is not None]

    def pool_stats(self) -> List[Dict[str, Any]]:
        out = []
        for sh in self.shards:
            if sh.pool is not None:
                out.append(dict(sh.pool.stats(), shard=sh.index))
        return out

    def _make_sched(self) -> SlotScheduler:
        sched = super()._make_sched()
        if self.cfg.attn_free:
            return sched
        for sh in self.shards:
            sh._reclaim_pages()
        sched.admission_gate = (lambda req, shard, resumable: self.shards[
            shard]._admission_gate(req, None, resumable))
        sched.pool_monitor = lambda: max(p.occupancy() for p in self.pools)
        return sched

    def _start_prefill(self, sched: SlotScheduler, slot: int, req: Request,
                       now: float) -> Dict[str, Any]:
        if not self.cfg.attn_free:
            eng, loc = self._owner(slot)
            eng._alloc_slot(loc, req)
        return super()._start_prefill(sched, slot, req, now)
