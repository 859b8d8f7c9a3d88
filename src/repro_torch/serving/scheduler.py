"""Continuous batching: admit requests into the live decode slots.

``ServeEngine`` serves fixed batches in lockstep: every sequence waits for
the slowest, and a finished slot idles until the whole batch drains. The
``ContinuousEngine`` here keeps one persistent n-slot cache on the device,
and a ``SlotScheduler`` that, at every chunk boundary, retires finished
slots and admits queued requests into them while the neighbours keep
decoding (the reference's ``serving/scheduler.py``). Which queued request
a free slot takes is a pluggable ``AdmissionPolicy`` (FIFO, shortest
prompt first, priority, TTFT deadline with least slack first).

Admission comes in two modes:

- ``prefill_mode="whole"``: one batch-1 prefill per admitted request
  (``prefill_into_slot``); it stalls every decoding slot for its length.
- ``prefill_mode="chunked"``: the chunked-prefill lane. A prompt goes
  through fixed-shape (1, ``p_chunk``) chunks (``models.prefill_chunk``),
  at most one between two decode chunks, so a decode chunk waits behind
  one lane chunk at most. The slot is PREFILLING meanwhile and rides the
  decode chunk not live; after its final chunk it is DECODING.

The decode chunk is the same on both devices: ``chunk`` ragged decode
steps over every slot, live-gated (a parked or prefilling slot writes no
K/V row and keeps its position), with the per-slot budget, stop and
emission masking of ``mask_chunk_emissions``. On CUDA it is one captured
CUDA graph per (chunk, greedy or sampled) over static buffers and the
engine's cache, and the lane chunk is one captured CUDA graph per
``with_head`` (and, for a sliding-window model's ring lane, per
``wrapped``) over its own static buffers (tokens, slot, offset, n_valid),
the same cache and the lane scratch; admissions and ``reset_slot`` write
into that cache in place between replays, and each decode chunk makes one
host copy (emitted, tok, n_gen, done). A capture that fails raises: there
is no eager path behind it on CUDA. On the CPU the same functions run
eagerly.

The lifecycle: ``Request.deadline_s`` and ``ContinuousEngine.cancel``
end a request at a chunk boundary. A queued one leaves with no tokens and a TTFT of inf, a
decoding one with its partial output, a prefilling one drops the lane
cursor and frees its slot; the neighbours' streams do not change.

The oracle: a request served through the slots emits the same tokens as
the same request served alone by ``ServeEngine(loop="host")`` with the
same ``max_len`` and ``rng_seed=request.seed``, bit for bit, greedy and
sampled, in either admission mode. It holds because a decode row's result
does not depend on the other rows (``decode_step``; the split plans of the
kernels depend on no batch size the engines use), because a lane chunk's
rows are the whole prompt's rows (fixed-shape attention tiles and norms,
``models/attention.py``), and because each slot samples with its own
generator, re-seeded with the request's seed at admission, drawing over
its own (1, V) row as a solo engine does. One exception on CUDA: the
dequant GEMM runs split-K up to 16 rows and wgmma above, and the two sum
a row in different orders, so there the chunked mode holds the oracle for
``p_chunk`` > 16 and prompts longer than 16 tokens (a lane chunk and the
whole prompt then both run wgmma; a bf16 weight's product runs on fixed
128-row tiles above 16 rows, ``kernels/ops.py:_dense_matmul``).

A sliding-window model's slots are rings of ``window`` rows, so a request
may run past ``max_len``; its prompt may be longer than the lane when the
lane is a ring too (``_lane_ring``: R >= window + P), whose chunks past R
rows run the ring lane (``prefill_chunk(wrapped=True)``).

Backpressure: with ``max_queue`` the arrived backlog is bounded at every
chunk boundary (``SlotScheduler.enforce_bounds``); a ``SheddingPolicy``
sheds the overflow (``Status.SHED``: ``RejectNew``, ``DropOldest``) or
admits it degraded (``DegradeOverBudget``: a capped ``max_new``, greedy),
and ``RequestResult.degraded`` marks what it served so. ``p_chunk="auto"``
picks the lane width from a sweep of the engine's own graphs at
construction (``_autotune_p_chunk``, the reference's rule). Per-slot
serving tiers are ``serving/tiers.py``.

The paged engine (``serving/paged_engine.py``) gates admission on free
KV pages through ``SlotScheduler.admission_gate``.

Families: dense, ssm and hybrid. A Mamba block's slot holds recurrent
state (``h``, ``conv``) beside or instead of K/V rows: a not-live slot
keeps it through decode chunks, ``reset_slot`` zeroes it at park and
admission overwrites it, the lane carries it between chunks, and a graph's
warm-up puts it back (``capture_graph(keep=)``). The lane's width must be
a multiple of ``ssm_chunk`` there, so the scan's chunks fall where the
whole prompt's fall.

Self-speculative decoding (``speculative=SpeculativeConfig(...)``,
``serving/speculative.py``): each decode chunk runs ``n_rounds`` rounds of
draft, batched verify and commit instead of ``chunk`` steps; on CUDA one
captured graph per (k, n_rounds, greedy). A greedy stream is the plain
engine's, bit for bit. The paged engine runs the same rounds over its
pools (``serving/paged_engine.py``); the tiered engine refuses
``speculative=``, as the reference's does.

Suspension, preemption and checkpoints (``serving/snapshot.py``): at a
chunk boundary a DECODING slot can be snapshotted (``SlotSnapshot``: its
K/V rows as packed bytes, its Mamba state, ``pos``, the next token, the
slot generator's state, the budget counters, the learned draft length)
and its request requeued as resumable; when the admission policy next
picks it, the snapshot is written into whichever slot is free and the
stream continues bit for bit. ``suspend(uid)`` asks for it; a
``PreemptionPolicy`` (``PriorityPreemption``: interactive overtakes
batch) picks victims for waiting requests; ``checkpoint(path)`` writes
every live slot's snapshot, the queue and the results so far, and a fresh
engine's ``restore(path)`` hands them back to ``serve``, on the dense or
the paged layout alike. ``restore_from_journal`` rebuilds the unfinished
requests from the event log alone. A PREFILLING request that is
suspended aborts its lane and requeues plain.

Faults and containment: ``serve(fault_plan=)`` takes a seeded
``FaultPlan`` (``serving/faults.py``) that poisons a slot's logits, flips
bytes of its packed K/V rows in place or sleeps at a chunk boundary. Every
decode chunk returns ``finite``, each slot's AND of ``isfinite`` over its
logits (the sentinel, always on, riding the chunk's one host copy), and
with ``kv_integrity=True`` two canaries run around it: a fold of each
slot's K/V rows that the chunk cannot write, taken before and checked
after it (``kvcache.kv_slot_checksum``, window-aware for a ring), and a
fold of each slot's Mamba state after a chunk, checked before the next
(``ssm_state_checksum``: nothing but decode may move it at rest; every
path that writes a slot between chunks disarms it first). A slot that
trips one is quarantined before its chunk is harvested: its tokens are
dropped, the slot is reset and freed, and the request is requeued with
``retries - 1`` (a fresh prefill replays it to its full stream) or ends
``FAILED`` with its pre-fault prefix. The neighbours' streams do not
change: decode rows are independent. The poison mask is a static buffer
written before each replay, so the all-False default runs today's graphs
on today's inputs.

Sharding: ``serving/sharded.py``'s ``ShardedContinuousEngine`` runs this
loop over S shards of ``n_slots / S`` slots, each on its own device, with
``ShardedSlotScheduler`` here routing admission to a shard. The hooks it
overrides are the device steps (``_owner`` names the engine and slot index
that hold a slot's state) and the lane cursor (``_park_lane``,
``_lane_busy``, ``_drop_lane_cursor``); a ``shard_down`` fault calls
``drain_shard``, which an unsharded engine refuses.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.qtensor import QuantPolicy, cast_formats, dense_like
from ..models import (decode_loop, init_cache, init_lane, prefill_chunk,
                      prefill_into_slot, read_cache_slot, recurrent_state,
                      reset_slot, write_cache_slot)
from ..models.common import ModelConfig
from ..models.kvcache import (cache_rows, kv_slot_checksum,
                               ssm_state_checksum)
from ..models.lm import STACK_FAMILIES, restore_round, save_round
from .engine import (_sync, capture_graph, load_params,
                     mask_chunk_emissions, sample_tokens)
from .events import Journal, replay
from .faults import FaultPlan, flip_kv_bytes
from .snapshot import (SlotSnapshot, load_checkpoint, pack_device_state,
                       save_checkpoint, slot_row_capacity,
                       unpack_device_state)
from .speculative import (AdaptiveK, SpeculativeConfig, pack_emissions,
                          spec_round)

logger = logging.getLogger("repro_torch.serving.scheduler")

# the families speculative decoding serves: MoE's capacity is resolved per
# dispatch, so a (B, k + 1)-row verify drops other assignments than k + 1
# one-row decode steps (the reference's refusal)
_SPEC_FAMILIES = ("dense", "ssm", "hybrid")


class Status:
    """Terminal request statuses, plain strings (they serialize into the
    event stream unchanged). Every submitted request gets one result with
    one of them: OK (ran to completion), DEADLINE_EXPIRED (its
    ``deadline_s`` passed, or the admission policy found it unservable: a
    queued request leaves with no tokens, a decoding one with its partial
    output), CANCELLED (``ContinuousEngine.cancel``, the same partial-
    output rule), SHED (bounded-queue backpressure turned it away
    unstarted), FAILED (its slot tripped a containment check and its
    retry budget was spent: the tokens are the pre-fault prefix)."""

    OK = "OK"
    DEADLINE_EXPIRED = "DEADLINE_EXPIRED"
    CANCELLED = "CANCELLED"
    SHED = "SHED"
    FAILED = "FAILED"


@dataclasses.dataclass
class Request:
    """One generation request entering the queue.

    ``arrival_time`` is seconds relative to the serve loop's start (0 =
    already waiting); the scheduler admits a request only once its
    arrival has passed. ``seed`` seeds this request's own sampling
    generator: a sampled request reproduces ``ServeEngine(rng_seed=seed)``
    serving it alone. ``deadline_s`` is an end-to-end budget from arrival:
    once it is exceeded the request is ended at the next chunk boundary
    with what it generated so far. ``retries`` is the quarantine budget:
    how many times a containment trip requeues the request instead of
    failing it. ``priority`` (higher = more urgent) feeds
    ``PriorityAdmission``. ``tier`` names a serving tier of a
    ``TieredContinuousEngine`` (None: its default tier); the plain engine
    ignores it.
    """
    uid: int
    tokens: np.ndarray                  # (T,) int prompt
    max_new: int
    temperature: float = 0.0
    stop_token: Optional[int] = None
    arrival_time: float = 0.0
    seed: int = 0
    deadline_s: Optional[float] = None
    retries: int = 0
    priority: int = 0
    tier: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request. ``degraded`` marks a request served
    under a cheaper tier than it asked for: admitted under
    ``DegradeOverBudget`` (capped ``max_new``, greedy), or moved to a
    cheaper KV tier while it decoded (``TieredContinuousEngine``)."""

    uid: int
    tokens: np.ndarray                  # (n_generated,) int32
    n_generated: int
    queue_delay: float                  # arrival -> admission (s)
    ttft: float                         # arrival -> first token (s); inf
    #                                     for a request that got none
    decode_seconds: float               # admission -> finish (s)
    status: str = Status.OK
    degraded: bool = False

    @property
    def ok(self) -> bool:
        return self.status == Status.OK

    @property
    def decode_tok_s(self) -> float:
        return self.n_generated / max(self.decode_seconds, 1e-9)


# ---------------------------------------------------------------------------
# admission policies: which arrived request does a free slot take?
# ---------------------------------------------------------------------------

class AdmissionPolicy:
    """Picks the next request to admit from the waiting queue.

    ``select`` returns an index into ``queue`` (only requests whose
    ``arrival_time`` has passed are eligible) or None to admit nothing.
    The scheduler owns the slots; policies only rank the queue.
    """

    def select(self, queue: Sequence[Request], now: float) -> Optional[int]:
        raise NotImplementedError

    def expired(self, queue: Sequence[Request], now: float) -> List[int]:
        """Indices of arrived requests this policy finds unservable: the
        scheduler ends them with ``Status.DEADLINE_EXPIRED`` instead of
        leaving them at the back of its ranking. Default: none."""
        return []


class FifoPolicy(AdmissionPolicy):
    """First come, first served."""

    def select(self, queue, now):
        for i, r in enumerate(queue):
            if r.arrival_time <= now:
                return i
        return None


class ShortestPromptFirst(AdmissionPolicy):
    """The arrived request with the shortest prompt (ties: FIFO): prefill
    cost grows with the prompt, so short requests stop paying a long
    one's admission stall, at the risk of starving long prompts."""

    def select(self, queue, now):
        arrived = [(len(r.tokens), i) for i, r in enumerate(queue)
                   if r.arrival_time <= now]
        return min(arrived)[1] if arrived else None


class TtftDeadline(AdmissionPolicy):
    """Least slack first against a TTFT deadline.

    Every request owes a first token by ``arrival_time + deadline_s``; its
    slack is that deadline less now and its own estimated prefill time
    (``prefill_s_per_tok`` a prompt token). The arrived request with the
    least slack is admitted: an old long prompt and a fresh short one are
    ranked by which is closer to missing its deadline. A request whose
    slack has gone negative is never selected (its first token would be
    late by construction); ``expired`` reports it for eviction."""

    def __init__(self, deadline_s: float = 0.25,
                 prefill_s_per_tok: float = 0.0):
        self.deadline_s = deadline_s
        self.prefill_s_per_tok = prefill_s_per_tok

    def _slack(self, r: Request, now: float) -> float:
        return (r.arrival_time + self.deadline_s - now
                - len(r.tokens) * self.prefill_s_per_tok)

    def select(self, queue, now):
        arrived = [(self._slack(r, now), i) for i, r in enumerate(queue)
                   if r.arrival_time <= now and self._slack(r, now) >= 0.0]
        return min(arrived)[1] if arrived else None

    def expired(self, queue, now):
        return [i for i, r in enumerate(queue)
                if r.arrival_time <= now and self._slack(r, now) < 0.0]


class PriorityAdmission(AdmissionPolicy):
    """The arrived request with the highest ``Request.priority`` (ties:
    earliest arrival, then FIFO)."""

    def select(self, queue, now):
        arrived = [(-r.priority, r.arrival_time, i)
                   for i, r in enumerate(queue) if r.arrival_time <= now]
        return min(arrived)[2] if arrived else None


# ---------------------------------------------------------------------------
# load shedding: what gives way when the arrived queue exceeds max_queue?
# ---------------------------------------------------------------------------

class SheddingPolicy:
    """Backpressure for a bounded admission queue.

    When the arrived part of the queue (future arrivals are not load yet)
    exceeds ``SlotScheduler.max_queue``, ``over_budget`` decides what gives:
    it returns ``(shed, degrade)``, ``shed`` the queue indices to end with
    ``Status.SHED`` and ``degrade`` ``(index, max_new_cap, force_greedy)``
    triples to serve under a cheaper tier. ``arrived`` comes sorted oldest
    first, so slicing its ends sheds in arrival order."""

    name = "reject-new"

    def over_budget(self, sched: "SlotScheduler", arrived: List[int],
                    n_over: int, now: float
                    ) -> Tuple[List[int], List[Tuple[int, Any, bool]]]:
        raise NotImplementedError


class RejectNew(SheddingPolicy):
    """Shed the newest over-budget arrivals (the default): the queue keeps
    its oldest waiters, and a fresh burst bounces off a full queue."""

    name = "reject-new"

    def over_budget(self, sched, arrived, n_over, now):
        return arrived[-n_over:], []


class DropOldest(SheddingPolicy):
    """Shed the oldest arrivals: under sustained overload they are the
    likeliest to have missed their deadline already, and dropping them
    bounds the survivors' queue delay."""

    name = "drop-oldest"

    def over_budget(self, sched, arrived, n_over, now):
        return arrived[:n_over], []


class DegradeOverBudget(SheddingPolicy):
    """Serve the newest over-budget arrivals degraded instead of shedding
    them: at admission their ``max_new`` is capped at ``max_new_cap`` (None:
    no cap) and, with ``force_greedy``, their sampling made greedy.
    ``hard_cap`` (arrived requests) bounds the degraded backlog itself:
    arrivals past it are shed. ``pool_watermark`` (a fraction in (0, 1])
    adds a memory trigger: when the engine's KV occupancy
    (``SlotScheduler.pool_monitor``) reaches it, every arrived waiter
    counts as over budget; the tiered engine also repacks resident KV at
    it (``TieredContinuousEngine(degrade_kv_to=)``). Results served so
    carry ``degraded=True``."""

    name = "degrade"

    def __init__(self, max_new_cap: Optional[int] = 8,
                 force_greedy: bool = True, hard_cap: Optional[int] = None,
                 pool_watermark: Optional[float] = None):
        self.max_new_cap = max_new_cap
        self.force_greedy = force_greedy
        self.hard_cap = hard_cap
        self.pool_watermark = pool_watermark

    def over_budget(self, sched, arrived, n_over, now):
        shed: List[int] = []
        if self.hard_cap is not None and len(arrived) > self.hard_cap:
            shed = arrived[self.hard_cap:]
            arrived = arrived[:self.hard_cap]
            n_over = max(n_over - len(shed), 0)
        degrade = [(i, self.max_new_cap, self.force_greedy)
                   for i in (arrived[-n_over:] if n_over else [])]
        return shed, degrade


# ---------------------------------------------------------------------------
# preemption: which decoding slot yields when a more urgent request waits?
# ---------------------------------------------------------------------------

class PreemptionPolicy:
    """Decides which DECODING slots to suspend for waiting requests.

    ``victims`` returns the slots to suspend at this chunk boundary; each
    is snapshotted (``SlotSnapshot``) and its request requeued as
    resumable, so a preemption costs a pause and no work: the resumed
    stream is the uninterrupted one, bit for bit. This base policy never
    preempts."""

    name = "none"

    def victims(self, sched: "SlotScheduler", now: float) -> List[int]:
        return []


class PriorityPreemption(PreemptionPolicy):
    """Suspend the lowest-priority decoding slot for a waiter of strictly
    higher priority (interactive overtakes batch).

    Waiters take the free slots first (preemption is the last resort);
    then each remaining arrived waiter, most urgent first, may displace
    the lowest-priority decoding slot if its own priority is strictly
    higher. The strict comparison keeps it from thrashing: a suspended
    request requeues at its old priority and can never preempt its
    preemptor back. A PREFILLING slot is never a victim (its lane would
    restart from chunk 0: there is nothing resumable to save)."""

    name = "priority"

    def victims(self, sched, now):
        waiting = sorted((r for r in sched.queue if r.arrival_time <= now),
                         key=lambda r: (-r.priority, r.arrival_time))
        if not waiting:
            return []
        pool = sorted((r.priority, s) for s, r in sched.active.items()
                      if sched.phase.get(s) == DECODING)
        budget = len(sched.free)
        out: List[int] = []
        for w in waiting:
            if budget > 0:
                budget -= 1
                continue
            if pool and pool[0][0] < w.priority:
                out.append(pool.pop(0)[1])
            else:
                break
        return out


# ---------------------------------------------------------------------------
# slot bookkeeping
# ---------------------------------------------------------------------------

PREFILLING = "PREFILLING"
DECODING = "DECODING"


class SlotScheduler:
    """Queue and free-slot bookkeeping behind a pluggable admission policy:
    ``next_admission`` pairs the first free slot with whichever arrived
    request the policy ranks first. A slot carries a phase: PREFILLING
    while the chunked lane still feeds its prompt, DECODING once its first
    token exists. ``expire_queued`` evicts queued requests whose deadline
    has passed. With ``max_queue`` the arrived queue is bounded: each
    ``enforce_bounds`` call hands the overflow to ``shedding`` (default
    ``RejectNew``), which sheds or degrades it. Pure host Python."""

    def __init__(self, n_slots: int,
                 policy: Optional[AdmissionPolicy] = None,
                 max_queue: Optional[int] = None,
                 shedding: Optional[SheddingPolicy] = None,
                 journal: Optional[Journal] = None):
        self.n_slots = n_slots
        self.policy = policy or FifoPolicy()
        self.max_queue = max_queue
        self.shedding = shedding or RejectNew()
        self.journal = journal or Journal()
        self.queue: List[Request] = []
        self.free: List[int] = list(range(n_slots))
        self.active: Dict[int, Request] = {}
        self.phase: Dict[int, str] = {}
        # uid -> (max_new_cap, force_greedy): degrade markers, applied at
        # admission (``_take``) and popped into RequestResult.degraded
        self.degraded: Dict[int, Tuple[Optional[int], bool]] = {}
        # uid -> SlotSnapshot: queued requests that are resumable (they
        # re-enter by a snapshot restore, not a prefill). Every path that
        # takes a queued request out (admission, shedding, expiry,
        # cancellation) consumes its snapshot with it.
        self.resumable: Dict[int, SlotSnapshot] = {}
        # shards out of rotation (a sharded engine's drain; admission never
        # routes to one): always empty for an unsharded engine
        self.drained: set = set()
        # engine hooks, both optional: admission_gate(req, shard,
        # resumable) -> bool vetoes a policy pick whose KV pages do not fit
        # now (the paged engine: a free slot is no longer enough);
        # pool_monitor() -> KV occupancy in [0, 1] feeds a policy's
        # pool_watermark (the paged and the tiered engine)
        self.admission_gate = None
        self.pool_monitor = None

    def _gate(self, req: Request, shard: Optional[int],
              resumable: bool) -> bool:
        if self.admission_gate is None:
            return True
        return bool(self.admission_gate(req, shard, resumable))

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _take(self, idx: int, slot: int) -> Tuple[int, Request]:
        """Move queue[idx] into ``slot``, applying its degrade marker."""
        self.free.remove(slot)
        req = self.queue.pop(idx)
        mark = self.degraded.get(req.uid)
        if mark is not None:
            cap, greedy = mark
            if cap is not None:
                req = dataclasses.replace(req, max_new=min(req.max_new, cap))
            if greedy:
                req = dataclasses.replace(req, temperature=0.0)
        self.active[slot] = req
        self.phase[slot] = DECODING
        return slot, req

    def next_admission(self, now: float) -> Optional[Tuple[int, Request]]:
        """Pop (slot, request) if a slot is free, the policy picks one and
        the admission gate (pages, for the paged engine) accepts it."""
        if not self.free or not self.queue:
            return None
        idx = self.policy.select(self.queue, now)
        if idx is None:
            return None
        req = self.queue[idx]
        if not self._gate(req, None, req.uid in self.resumable):
            return None
        return self._take(idx, self.free[0])

    def next_resume(self, now: float) -> Optional[Tuple[int, Request]]:
        """Pop (slot, request) only if the policy's pick is resumable.

        A resume is one restore, not a prompt, so the engine drains these
        before lane work; but strictly in the policy's order: a resumable
        request never jumps a request the policy ranks higher."""
        if not self.free or not self.queue or not self.resumable:
            return None
        idx = self.policy.select(self.queue, now)
        if idx is None or self.queue[idx].uid not in self.resumable:
            return None
        if not self._gate(self.queue[idx], None, True):
            return None
        return self._take(idx, self.free[0])

    def pop_queued(self, uid: int) -> Optional[Request]:
        """Remove and return the queued request with ``uid`` (else None)."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                return self.queue.pop(i)
        return None

    def expire_queued(self, now: float) -> List[Request]:
        """Pop the arrived queued requests whose ``deadline_s`` has passed
        or that the policy reports as ``expired``."""
        idx = {i for i, r in enumerate(self.queue)
               if r.deadline_s is not None and r.arrival_time <= now
               and now - r.arrival_time > r.deadline_s}
        idx.update(self.policy.expired(self.queue, now))
        return [self.queue.pop(i) for i in sorted(idx, reverse=True)]

    def enforce_bounds(self, now: float) -> List[Request]:
        """Apply the shedding policy; returns the requests shed.

        The bound is on the backlog: the arrived waiters beyond what the
        free slots take at once (the sweep runs before admission, so
        without the ``free`` credit a first burst would shed requests an
        idle slot was about to serve). Degrade markers are recorded here,
        journaled once per uid, and applied when ``_take`` admits the
        request. A policy's ``pool_watermark`` adds the memory trigger:
        with ``pool_monitor`` at or past it, every arrived waiter is over
        budget."""
        wm = getattr(self.shedding, "pool_watermark", None)
        pressure = (wm is not None and self.pool_monitor is not None
                    and self.pool_monitor() >= wm)
        if self.max_queue is None and not pressure:
            return []
        arrived = sorted((i for i, r in enumerate(self.queue)
                          if r.arrival_time <= now),
                         key=lambda i: (self.queue[i].arrival_time, i))
        n_over = (len(arrived) - self.max_queue - len(self.free)
                  if self.max_queue is not None else 0)
        if pressure:
            n_over = max(n_over, len(arrived))
        if n_over <= 0:
            return []
        shed_idx, degrades = self.shedding.over_budget(self, arrived,
                                                       n_over, now)
        for i, cap, greedy in degrades:
            uid = self.queue[i].uid
            if uid not in self.degraded:
                self.degraded[uid] = (cap, greedy)
                self.journal.emit(logger, "degrade", uid=uid,
                                  max_new_cap=cap, greedy=greedy,
                                  policy=self.shedding.name)
        shed = [self.queue.pop(i) for i in sorted(set(shed_idx),
                                                  reverse=True)]
        for r in shed:
            self.degraded.pop(r.uid, None)
        return shed

    def release(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.phase.pop(slot, None)
        self.free.append(slot)
        return req

    def suspend_to_queue(self, slot: int, snap: SlotSnapshot) -> Request:
        """Release ``slot`` and requeue its request as resumable."""
        req = self.release(slot)
        self.resumable[req.uid] = snap
        self.queue.append(req)
        return req

    def reassign(self, old: int, new: int) -> Request:
        """Move a live request from slot ``old`` to the free slot ``new``
        (a live migration's bookkeeping): its phase goes with it and
        ``old`` returns to the free list (its shard may be drained: the
        routing, not the free list, keeps a drained shard's slots out of
        admission). Moving the slot's state is the engine's work."""
        req = self.active.pop(old)
        phase = self.phase.pop(old)
        self.free.remove(new)
        self.free.append(old)
        self.active[new] = req
        self.phase[new] = phase
        return req

    def mark_prefilling(self, slot: int) -> None:
        self.phase[slot] = PREFILLING

    def mark_decoding(self, slot: int) -> None:
        self.phase[slot] = DECODING

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.queue), default=None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)


class ShardedSlotScheduler(SlotScheduler):
    """Slot bookkeeping over S shards of ``slots_per_shard`` slots: global
    slot ``g`` lives on shard ``g // slots_per_shard`` at local index ``g %
    slots_per_shard`` (the sharded engine's contiguous blocks). The policy
    still ranks the queue (which request); the slot comes from one shard:
    the caller's when it names one (a shard's own lane), else the
    least-loaded shard with a free slot (ties: the lowest id), so early
    traffic spreads over the shards instead of filling shard 0. A drained
    shard is out of rotation. With an admission gate (per-shard page
    pools), a shard whose gate refuses the pick is skipped for the next.
    Pure host bookkeeping."""

    def __init__(self, n_shards: int, slots_per_shard: int,
                 policy: Optional[AdmissionPolicy] = None, **kw):
        super().__init__(n_shards * slots_per_shard, policy, **kw)
        self.n_shards = n_shards
        self.slots_per_shard = slots_per_shard

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def local_slot(self, slot: int) -> int:
        return slot % self.slots_per_shard

    def load(self, shard: int) -> int:
        """Occupied slots on ``shard``, prefilling and decoding alike."""
        return sum(1 for s in self.active if self.shard_of(s) == shard)

    def free_on(self, shard: int) -> List[int]:
        return [s for s in self.free if self.shard_of(s) == shard]

    def healthy_free(self) -> List[int]:
        """The free slots on shards still in rotation."""
        return [s for s in self.free if self.shard_of(s) not in self.drained]

    def _least_loaded(self) -> List[int]:
        """Healthy shards with a free slot, least-loaded first."""
        with_free = {self.shard_of(s) for s in self.free} - self.drained
        return sorted(with_free, key=lambda s: (self.load(s), s))

    def next_admission(self, now: float, shard: Optional[int] = None
                       ) -> Optional[Tuple[int, Request]]:
        """Pop (global slot, request), routed to ``shard`` or, with none,
        to the least-loaded healthy shard whose gate takes the pick. A
        drained ``shard`` admits nothing (its lane is being retired)."""
        if not self.queue or (shard is not None and shard in self.drained):
            return None
        idx = self.policy.select(self.queue, now)
        if idx is None:
            return None
        req = self.queue[idx]
        resum = req.uid in self.resumable
        if shard is not None:
            free = self.free_on(shard)
            if not free or not self._gate(req, shard, resum):
                return None
            return self._take(idx, free[0])
        for sh in self._least_loaded():
            if self._gate(req, sh, resum):
                return self._take(idx, self.free_on(sh)[0])
        return None

    def next_resume(self, now: float) -> Optional[Tuple[int, Request]]:
        """The policy's pick, only if resumable, into the least-loaded
        healthy shard whose gate takes it (a snapshot restores into any
        free slot)."""
        if not self.queue or not self.resumable:
            return None
        shards = self._least_loaded()
        if not shards:
            return None
        idx = self.policy.select(self.queue, now)
        if idx is None or self.queue[idx].uid not in self.resumable:
            return None
        for sh in shards:
            if self._gate(self.queue[idx], sh, True):
                return self._take(idx, self.free_on(sh)[0])
        return None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def continuous_chunk(cfg: ModelConfig, params, kv_fmt: Optional[str],
                     n_steps: int, greedy: bool, gens, buf, cache):
    """One decode chunk of the continuous engine (the reference's
    ``_chunk_fn``): ``n_steps`` decode steps of every slot from the static
    buffers ``buf``, live-gated, then the chunk's emission, stop and
    per-slot budget masking. A sampled chunk (``greedy`` false) draws each
    slot's noise over its own (1, V) row with its own generator, as a solo
    engine does. ``buf["poison"]`` (B,) bool makes a slot's logits NaN at
    every step (the fault hook; all False leaves them bit for bit).
    Returns (emitted (B, n), tok, n_gen, done, pos, finite): ``finite``
    (B,) is each slot's AND of ``isfinite`` over every step's logits, the
    containment sentinel (a NaN at any step trips it)."""
    poison = buf["poison"]

    def sample(logits):
        return sample_tokens(logits, buf["temp"], greedy, gens)

    def inject(logits):
        return torch.where(poison[:, None], float("nan"), logits)

    def probe(logits):
        return torch.isfinite(logits).all(dim=-1)

    toks, tok, new, aux = decode_loop(cfg, params, buf["tok"], cache,
                                      n_steps, kv_fmt, sample,
                                      live=buf["live"], logits_fn=inject,
                                      probe_fn=probe)
    emitted, n_gen, done = mask_chunk_emissions(
        toks, buf["done"], buf["n_gen"], buf["stop"], buf["max_new"])
    return emitted, tok, n_gen, done, new["pos"], aux.all(dim=0)


def speculative_chunk(cfg: ModelConfig, params, draft_params,
                      kv_fmt: Optional[str], k: int, n_rounds: int,
                      greedy: bool, gens, buf, cache, spec_k):
    """The speculative decode chunk (the reference's ``_spec_chunk_fn``):
    ``n_rounds`` rounds of ``spec_round`` from the static buffers ``buf``,
    each slot advancing by its own accepted length (``spec_k`` (B,) caps a
    slot's acceptance), emission, stop and budget masking round by round,
    the rounds' ragged emissions left-packed into each slot's prefix.
    ``buf["poison"]`` NaNs a slot's verify logits in every round. Returns
    (emitted (B, n_rounds * (k+1)), tok, n_gen, done, pos, finite, acc,
    off): ``finite`` is the sentinel over every round's verify logits,
    ``acc`` and ``off`` each slot's accepted and offered candidates over
    the chunk, the adaptive-k signal."""
    tok, done, n_gen = buf["tok"], buf["done"], buf["n_gen"]
    acc = torch.zeros_like(n_gen)
    off = torch.zeros_like(n_gen)
    finite = torch.ones_like(done)
    c = cache
    toks_r, n_r = [], []
    for _ in range(n_rounds):
        live_r = buf["live"] & ~done
        emitted, n_emit, tok, c, done, n_gen, fin_r, a = spec_round(
            cfg, params, draft_params, tok, c, done, n_gen, buf["max_new"],
            buf["temp"], buf["stop"], live_r, buf["poison"], spec_k, gens,
            kv_fmt=kv_fmt, k=k, greedy=greedy)
        finite = finite & fin_r
        acc = acc + torch.where(live_r, a, 0)
        off = off + torch.where(live_r, torch.clamp(spec_k, max=k), 0)
        toks_r.append(emitted)
        n_r.append(n_emit)
    emitted = pack_emissions(torch.stack(toks_r), torch.stack(n_r))
    return emitted, tok, n_gen, done, c["pos"], finite, acc, off


class ContinuousEngine:
    """Continuous batching over one persistent ``n_slots`` cache.

    ``prefill_mode="whole"`` admits with one batch-1 prefill per request,
    written into its slot (``prefill_into_slot``), between decode chunks;
    it stalls every decoding slot for its length. ``prefill_mode=
    "chunked"`` feeds prompts through the lane in (1, ``p_chunk``)
    chunks, one between two decode chunks (on CUDA a replay of one of two
    captured graphs, ``with_head`` false or true), so a decode chunk waits
    behind one lane chunk at most; the first token is sampled after the
    final chunk as a whole admission samples it, and the slot is then
    armed at position T. ``p_chunk="auto"`` picks the width from
    ``p_chunk_candidates`` at construction (``_autotune_p_chunk``).
    Weights are cast at load time as ``ServeEngine``'s are. ``max_queue``
    and ``shedding`` bound the arrived backlog (``SlotScheduler.
    enforce_bounds``). ``serve`` drains a list of requests, honouring
    their arrival times, deadlines and ``cancel`` calls, and returns one
    ``RequestResult`` per request. The bitwise oracle holds up to 16 slots
    (``models.common.ROW_GROUP``): up to 16 rows the dequant GEMM runs
    split-K with one plan whatever the row count (``decode_split``).

    ``speculative`` (a ``SpeculativeConfig``) makes every decode chunk
    ``n_rounds = max(1, chunk // (k + 1))`` rounds of draft, batched
    verify and commit (``speculative_chunk``; k the most live
    ``spec_k``, which ``AdaptiveK`` moves per slot). The draft weights
    are the cast weights decoded to bf16 (``draft="recycled"``, which
    needs a ``weight_fmt``) or the weights cast to ``draft``, on the
    engine's device. Counters: ``spec_accepted`` and ``spec_offered``
    since construction (``spec_stats()``), and for the last ``serve``
    ``spec_rounds`` (each chunk's (k, n_rounds)); a slot's k moving is a
    ``spec-k`` event.

    ``suspend(uid)`` and ``preemption`` (a ``PreemptionPolicy``) park a
    decoding request as a ``SlotSnapshot`` and requeue it resumable; it
    resumes in whichever slot is free, bit for bit, its learned draft
    length kept. ``snapshot_slot`` reads a live slot without disturbing
    it, ``checkpoint(path)`` writes the live serve to a file from a
    ``progress_cb``, and a fresh engine's ``restore(path)`` (or
    ``restore_from_journal``, with the event log alone) returns the
    requests to hand to ``serve``.

    ``serve(fault_plan=)`` injects a seeded ``FaultPlan``; the finite-
    logits sentinel always runs, and ``kv_integrity=True`` adds the K/V
    and SSM-state canaries (``_kv_refresh``, ``_kv_verify``,
    ``_ssm_rearm``). A tripped slot is quarantined (``_quarantine``):
    requeued while ``Request.retries`` lasts, else ``Status.FAILED``.

    Counters for the caller: ``replays`` and ``lane_replays`` (decode and
    lane CUDA graph replays since construction); for the last ``serve``,
    ``chunks`` (decode chunks), ``chunk_times`` (each chunk's live slots
    at dispatch and host-clock seconds, the host copy included),
    ``admit_seconds`` (each whole admission's host-clock seconds, prefill
    and first token), ``lane_chunks`` and ``lane_seconds`` (each lane
    dispatch's host-clock seconds, a final chunk's first token included)
    and ``stall_seconds`` (for each decode chunk that had live slots
    waiting, the seconds of admission or lane work before it). After an
    ``"auto"`` pick, ``p_chunk_sweep`` (seconds of one lane chunk per
    candidate) and ``p_chunk_decode_s`` (one decode chunk's).

    The vision and audio families are refused at construction (a
    ``Request`` carries no memory input, and a slot cache no memory K/V;
    the reference's engines fail at admission): ``ServeEngine`` serves
    them.
    """

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 n_slots: int = 4, max_len: int = 2048, chunk: int = 16,
                 admission_policy: Optional[AdmissionPolicy] = None,
                 prefill_mode: str = "whole", p_chunk=32,
                 p_chunk_candidates: Sequence[int] = (16, 32, 64, 128),
                 max_queue: Optional[int] = None,
                 shedding: Optional[SheddingPolicy] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 preemption: Optional[PreemptionPolicy] = None,
                 kv_integrity: bool = False, device=None):
        if cfg.family not in STACK_FAMILIES:
            raise ValueError(
                f"the continuous engines do not serve family="
                f"{cfg.family!r}: a request carries no memory input "
                "(vision, frames); serve it through ServeEngine")
        if chunk < 1 or n_slots < 1:
            raise ValueError(f"chunk ({chunk}) and n_slots ({n_slots}) "
                             "must be >= 1")
        if prefill_mode not in ("whole", "chunked"):
            raise ValueError(f"prefill_mode {prefill_mode!r}: 'whole' or "
                             "'chunked'")
        if prefill_mode == "chunked" and p_chunk != "auto":
            if not isinstance(p_chunk, int):
                raise ValueError(f"p_chunk={p_chunk!r}: an int or 'auto'")
            if not 1 <= p_chunk <= max_len:
                raise ValueError(f"p_chunk ({p_chunk}) must be in 1.."
                                 f"max_len ({max_len})")
        self.cfg = cfg
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.admission_policy = admission_policy
        self.prefill_mode = prefill_mode
        self.max_queue = max_queue
        self.shedding = shedding
        self.preemption = preemption
        self.kv_integrity = kv_integrity
        self.device = resolve_device(device)
        self.speculative = speculative
        if speculative is not None:
            self._check_speculative(cfg, policy, speculative, max_len)
        self.params = self._load_weights(params)
        if speculative is not None:
            self._init_speculative(params, speculative, n_slots)
        self.cache = self._init_slot_cache()
        self.journal = Journal()
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(n_slots)]
        # host slot state, uploaded into the static buffers every chunk
        self._host = {
            "tok": np.zeros((n_slots,), np.int32),
            "done": np.ones((n_slots,), bool),        # all parked
            "live": np.zeros((n_slots,), bool),
            "n_gen": np.zeros((n_slots,), np.int32),
            "max_new": np.zeros((n_slots,), np.int32),
            "temp": np.zeros((n_slots,), np.float32),
            "stop": np.full((n_slots,), -1, np.int32)}
        self._buf = {k: torch.from_numpy(v.copy()).to(self.device)
                     for k, v in self._host.items()}
        # the fault hook: slots whose logits the next chunk makes NaN
        self._buf["poison"] = torch.zeros((n_slots,), dtype=torch.bool,
                                          device=self.device)
        # the canaries (kv_integrity): the K/V fold pins each slot's rows
        # that a chunk cannot write (vacuous without attention), the SSM
        # fold its Mamba state at rest between chunks
        self._has_attn_kv = not cfg.attn_free
        self._has_ssm = cfg.has_mamba
        self._kv_armed = np.zeros((n_slots,), bool)
        self._kv_sum = np.zeros((n_slots,), np.int64)
        self._kv_upto = np.zeros((n_slots,), np.int64)
        self._kv_horizon = chunk
        self._ssm_armed = np.zeros((n_slots,), bool)
        self._ssm_sum = np.zeros((n_slots,), np.int64)
        self._ssm_bad = np.zeros((n_slots,), bool)
        self._fault_plan: Optional[FaultPlan] = None
        self._graphs: Dict[Any, Any] = {}    # key -> (graph, outputs)
        self.replays = 0
        self.lane_replays = 0
        self._pf: Optional[Dict[str, Any]] = None    # the lane's cursor
        # the live serve, for progress_cb introspection (checkpoint,
        # snapshot_slot): its scheduler, slot states, results and clock
        self._sched: Optional[SlotScheduler] = None
        self._state: Optional[Dict[int, Dict[str, Any]]] = None
        self._results: Optional[List[RequestResult]] = None
        self._clock = None
        self._cancel_uids: set = set()
        self._suspend_uids: set = set()
        # uid -> SlotSnapshot a restore hands to the next serve
        self._pending_resume: Dict[int, SlotSnapshot] = {}
        self.chunks = 0
        self.chunk_times: List[Tuple[int, float]] = []
        self.admit_seconds: List[float] = []
        self.lane_chunks = 0
        self.lane_seconds: List[float] = []
        self.stall_seconds: List[float] = []
        if prefill_mode == "chunked":
            if cfg.family == "moe":
                logger.warning(
                    "family='moe' + prefill_mode='chunked': expert capacity "
                    "is chunk-local, so outputs are NOT bit-identical to "
                    "whole-prompt admission (use prefill_mode='whole' when "
                    "the oracle matters)")
            if p_chunk == "auto":
                p_chunk = self._autotune_p_chunk(p_chunk_candidates)
            else:
                self._build_lane(p_chunk)
        self.p_chunk = p_chunk

    # -- speculative decoding --------------------------------------------------

    @staticmethod
    def _check_speculative(cfg: ModelConfig, policy: QuantPolicy,
                           spec: SpeculativeConfig, max_len: int) -> None:
        """The reference's refusals (a family outside the verify's
        contract; a recycled draft with nothing cast to recycle); and a
        round's k + 1 rows must fit a slot's cache."""
        if cfg.family not in _SPEC_FAMILIES:
            raise ValueError(f"speculative decode does not serve "
                             f"family={cfg.family!r}")
        if spec.draft == "recycled" and not policy.weight_fmt:
            raise ValueError(
                "draft='recycled' dequantizes the engine's cast weights: it "
                "needs a quantized product (policy.weight_fmt)")
        if not cfg.attn_free and spec.k + 1 > cache_rows(cfg, max_len):
            raise ValueError(f"a speculative round's {spec.k + 1} rows do "
                             f"not fit a slot's cache")

    def _init_speculative(self, raw_params, spec: SpeculativeConfig,
                          n_slots: int) -> None:
        """The draft weights (``_load_draft``), the controller, the
        counters (in all and per slot) and the static ``spec_k`` buffer."""
        self.draft_params = self._load_draft(raw_params, spec)
        self._adaptive = AdaptiveK(spec, n_slots)
        self._spec_k = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.spec_accepted = 0        # candidates accepted (all chunks)
        self.spec_offered = 0         # candidates offered (all chunks)
        self._spec_acc_slot = np.zeros((n_slots,), np.int64)
        self._spec_off_slot = np.zeros((n_slots,), np.int64)
        self.spec_rounds: List[Tuple[int, int]] = []

    def _load_draft(self, raw_params, spec: SpeculativeConfig):
        """The draft weights on the engine's device: the cast weights
        decoded to bf16 (``draft="recycled"``), or the f32 weights cast to
        ``spec.draft``."""
        if spec.draft == "recycled":
            return dense_like(self.params)
        if cast_formats(raw_params):
            raise ValueError(
                f"draft={spec.draft!r} is cast from the f32 weights, and "
                f"these are cast to {sorted(cast_formats(raw_params))}: "
                "build them without a policy, or use draft='recycled'")
        return load_params(raw_params, dataclasses.replace(
            self.policy, weight_fmt=spec.draft), self.device)

    def _spec_round_shape(self) -> Tuple[int, int]:
        """(k, n_rounds) of the next speculative chunk: k the most live
        slot's ``spec_k``, and as many rounds as keep a fully accepted
        chunk's advance near ``chunk``."""
        h = self._host
        k = self._adaptive.round_k(h["live"] & ~h["done"])
        return k, max(1, self.chunk // (k + 1))

    def _spec_chunk_fn(self, greedy: bool, k: int, n_rounds: int,
                       warm: bool = False):
        """A speculative chunk of ``n_rounds`` rounds of k. ``warm``: one
        round that then puts back every row and recurrent state it wrote
        (``save_round``/``restore_round``), a graph capture's warm-up: a
        kept row of the round would be one a ring's first replayed round
        still reads."""
        cfg, kv = self.cfg, self.policy.kv_fmt

        def run(rounds):
            return speculative_chunk(cfg, self.params, self.draft_params, kv,
                                     k, rounds, greedy, self._gens,
                                     self._buf, self.cache, self._spec_k)
        if not warm:
            return lambda: run(n_rounds)

        def one_round():
            saved = save_round(cfg, self.cache, k + 1, kv)
            run(1)
            restore_round(cfg, self.cache, saved, kv)
        return one_round

    def _dispatch_spec_chunk(self, greedy: bool, poison: np.ndarray):
        """Run one speculative chunk from the host slot state and fold its
        results and acceptance counts back into the host state and the
        controller. Returns (emitted (B, n_rounds * (k+1)), finite (B,))."""
        k, n_rounds = self._spec_round_shape()
        self.spec_rounds.append((k, n_rounds))
        got = self._chunk_results(poison, greedy, (k, n_rounds))
        emitted, finite = got[:, :-3], got[:, -3] != 0
        acc, off = got[:, -2], got[:, -1]
        self.spec_accepted += int(acc.sum())
        self.spec_offered += int(off.sum())
        self._spec_acc_slot += acc
        self._spec_off_slot += off
        old_k = self._adaptive.k.copy()
        self._adaptive.update(self._host["live"], acc, off)
        for s in np.nonzero(self._adaptive.k != old_k)[0]:
            self._emit("spec-k", slot=int(s), k=int(self._adaptive.k[s]),
                       ema=round(float(self._adaptive.ema[s]), 3),
                       chunk=self.chunks)
        return emitted, finite

    def spec_stats(self) -> Dict[str, Any]:
        """Acceptance over every chunk since construction: accepted and
        offered candidates and their ratio."""
        if self.speculative is None:
            raise ValueError("engine was built without speculative=")
        return {"accepted": self.spec_accepted,
                "offered": self.spec_offered,
                "accept_rate": self.spec_accepted
                / max(self.spec_offered, 1)}

    # -- construction hooks (the tiered engine overrides these) ------------

    def _load_weights(self, params):
        return load_params(params, self.policy, self.device)

    def _init_slot_cache(self):
        return init_cache(self.cfg, self.n_slots, self.max_len,
                          self.policy.kv_fmt, device=self.device)

    def _slot_cache(self, slot: int):
        """The cache arena that holds ``slot``'s rows."""
        return self.cache

    def _owner(self, slot: int):
        """(engine, index) that hold ``slot``'s device state: this engine
        and ``slot`` itself (a sharded engine's shard, and the slot's index
        there)."""
        return self, slot

    def _shard_of(self, slot: int) -> Optional[int]:
        """The shard that owns ``slot``, for the event records (None: an
        unsharded engine, and the field is dropped)."""
        return None

    def _positions(self) -> np.ndarray:
        """Every slot's ``pos`` (B,), on the host."""
        return self.cache["pos"].cpu().numpy()

    def _build_lane(self, p_chunk: int) -> None:
        """The lane for chunks of ``p_chunk``: its scratch and its static
        inputs (tokens, and (slot, offset, n_valid) as (1,) int32 views of
        one buffer); its graphs are captured at first use."""
        # natural-order scratch rows: a longer prompt is refused at submit,
        # unless the lane is a ring (a sliding window, and rows for a whole
        # window plus a chunk: every key a chunk attends is still there)
        self._lane_rows = -(-self.max_len // p_chunk) * p_chunk
        w = self.cfg.sliding_window
        self._lane_ring = bool(w) and self._lane_rows >= w + p_chunk
        self.lane = init_lane(self.cfg, self.max_len, p_chunk,
                              device=self.device)
        self._lane_tok = torch.zeros((1, p_chunk), dtype=torch.int64,
                                     device=self.device)
        self._lane_idx = torch.zeros((3,), dtype=torch.int32,
                                     device=self.device)
        # with_head -> graph; (with_head, "ring") for the ring lane's
        self._lane_graphs: Dict[Any, Any] = {}

    # -- p_chunk="auto" -------------------------------------------------------

    def _time_best(self, fn, n: int = 3) -> float:
        """Seconds of ``fn()``: one warm-up call, then the least of ``n``,
        the device synchronised around each (the reference's
        ``_time_best``)."""
        fn()
        _sync(self.device)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            _sync(self.device)
            times.append(time.perf_counter() - t0)
        return min(times)

    def _decode_probe(self):
        """One greedy decode chunk over the parked slots, as the engine
        runs it: on CUDA a replay of its captured graph (the graph stays for
        serving), on the CPU the eager chunk."""
        self._upload(self._host)
        if self.device.type != "cuda":
            return self._chunk_fn(True)
        if True not in self._graphs:
            self._graphs[True] = capture_graph(
                self._chunk_fn(True), self.device,
                warm=self._chunk_fn(True, 1),
                keep=recurrent_state(self.cache))
        return self._graphs[True][0].replay

    def _lane_probe(self, p_chunk: int):
        """One lane chunk without the head (``p_chunk`` zero tokens into
        slot 0 at offset 0), as the engine runs it: on CUDA a replay of the
        lane's ``with_head=False`` graph. ``_autotune_p_chunk`` clears what
        it writes into slot 0 and the lane."""
        self._lane_tok.zero_()
        self._lane_idx.copy_(torch.tensor([0, 0, p_chunk],
                                          dtype=torch.int32))
        how = self._lane_route(0)[1:]
        fn = self._lane_fn(False, *how)
        if self.device.type != "cuda":
            return fn
        self._lane_graphs[False] = capture_graph(
            fn, self.device, keep=recurrent_state(how[1], self.lane))
        return self._lane_graphs[False][0].replay

    def _autotune_p_chunk(self, candidates: Sequence[int],
                          stall_factor: float = 2.0) -> int:
        """Pick the lane chunk width from a short sweep (``p_chunk="auto"``,
        the reference's rule): time one decode chunk (the stall a lane
        chunk interleaves with) and one lane chunk per candidate, each as
        the engine runs it (CUDA graph replays on the card), then take the
        candidate of the highest ``p / t_p`` among those whose lane chunk
        costs at most ``stall_factor`` decode chunks; if none does, the
        smallest. The winner keeps its lane scratch and graph; the others
        are dropped. Candidates the lane cannot take are dropped first: wider
        than ``max_len`` or the sliding window, or (a Mamba block) not a
        multiple of ``ssm_chunk``, which at full width (256) leaves none of
        the default candidates. On CUDA a pick of 16 or less runs the lane's
        GEMMs split-K, and the chunked oracle then does not hold bitwise
        (the module docstring). Results: ``p_chunk_sweep``,
        ``p_chunk_decode_s``."""
        cfg = self.cfg
        w = cfg.sliding_window
        cands = sorted({int(p) for p in candidates if 1 <= p <= self.max_len
                        and (not w or p <= w)
                        and (not cfg.has_mamba
                             or p % cfg.ssm_chunk == 0)})
        if not cands:
            raise ValueError(f"p_chunk='auto': no candidate in "
                             f"{tuple(candidates)} fits max_len "
                             f"({self.max_len}), the sliding window "
                             f"({w}) and ssm_chunk ({cfg.ssm_chunk})")
        decode_s = self._time_best(self._decode_probe())
        sweep: Dict[int, float] = {}
        lanes: Dict[int, Tuple[Any, ...]] = {}
        for p in cands:
            self._build_lane(p)
            sweep[p] = self._time_best(self._lane_probe(p))
            lanes[p] = (self._lane_rows, self.lane, self._lane_tok,
                        self._lane_idx, self._lane_graphs)
        budget = stall_factor * decode_s
        ok = [p for p in cands if sweep[p] <= budget]
        best = max(ok, key=lambda p: p / sweep[p]) if ok else cands[0]
        (self._lane_rows, self.lane, self._lane_tok, self._lane_idx,
         self._lane_graphs) = lanes[best]
        del lanes                     # the losers' scratch and graphs
        # the probes' rows cleared: the state of an engine built at a fixed
        # p_chunk (buffers zeroed in place, which the graphs keep reading)
        for buf in (self._lane_tok, self._lane_idx, *(
                b for layer in self.lane["layers"] for b in layer.values())):
            buf.zero_()
        for layer in self.cache["layers"]:
            if "block" in layer:      # paged: slot 0 maps no page yet, so
                continue              # the probe's rows were dropped
            for buf in layer.values():
                buf[0].zero_()
        reset_slot(self.cfg, self.cache, 0)
        self.p_chunk_sweep = sweep
        self.p_chunk_decode_s = decode_s
        logger.info("p_chunk autotune: decode chunk %.2fms, sweep {%s} -> %d",
                    decode_s * 1e3, ", ".join(f"{p}: {s * 1e3:.2f}ms"
                                              for p, s in sweep.items()),
                    best)
        return best

    # -- device work ---------------------------------------------------------

    def _chunk_fn(self, greedy: bool, steps: Optional[int] = None):
        """A decode chunk of ``steps`` (default ``chunk``) steps."""
        cfg, params, kv = self.cfg, self.params, self.policy.kv_fmt
        n, gens, buf, cache = steps or self.chunk, self._gens, self._buf, \
            self.cache
        return lambda: continuous_chunk(cfg, params, kv, n, greedy, gens,
                                        buf, cache)

    def _upload(self, host: Dict[str, np.ndarray]) -> None:
        for name, arr in host.items():
            self._buf[name].copy_(torch.from_numpy(arr))

    def _run_chunk(self, key, make_fn, greedy: bool, cache=None):
        """The chunk's outputs: on CUDA a replay of the graph under ``key``
        (captured at first use from ``make_fn()`` after a one-step warm-up,
        ``make_fn(1)``, the slot generators registered with a sampled one,
        the recurrent state of ``cache``, the chunk's arena (default the
        engine's), put back after the warm-up), on the CPU
        ``make_fn()()``."""
        if self.device.type != "cuda":
            return make_fn()()
        if key not in self._graphs:
            self._graphs[key] = capture_graph(
                make_fn(), self.device, () if greedy else self._gens,
                warm=make_fn(1),
                keep=recurrent_state(self.cache if cache is None else cache))
        graph, outs = self._graphs[key]
        graph.replay()
        self.replays += 1
        return outs

    def _fold(self, outs, cache, rows) -> np.ndarray:
        """Fold a chunk's results (emitted (B, n), tok, n_gen, done, pos,
        then the (B,) extra columns: ``finite``, and a speculative chunk's
        acc and off) into ``cache["pos"]`` and the host state of ``rows``
        (a bool mask or a slice), in one host copy. Returns emitted, then
        the extra columns: (B, n + extras)."""
        emitted, tok, n_gen, done, pos, *extra = outs
        cache["pos"].copy_(pos)
        n = emitted.shape[1]
        got = torch.cat([emitted.to(torch.int32), tok[:, None],
                         n_gen[:, None], done[:, None].to(torch.int32)]
                        + [e[:, None].to(torch.int32) for e in extra],
                        dim=1).cpu().numpy()
        h = self._host
        h["tok"][rows] = got[rows, n]
        h["n_gen"][rows] = got[rows, n + 1]
        h["done"][rows] = got[rows, n + 2] != 0
        return np.concatenate([got[:, :n], got[:, n + 3:]], axis=1)

    def _launch(self, poison: np.ndarray, greedy: bool, shape=None,
                spec_k: Optional[np.ndarray] = None):
        """Upload the host slot state, ``poison`` (B,) into its static
        buffer, and run one decode chunk: plain, or speculative of
        ``shape`` (k, n_rounds) with each slot's ``spec_k``. Returns the
        chunk's outputs on the device (``_fold`` reads them)."""
        self._upload(dict(self._host, poison=poison))
        if shape is None:
            return self._run_chunk(
                greedy, lambda steps=None: self._chunk_fn(greedy, steps),
                greedy)
        k, n_rounds = shape
        self._spec_k.copy_(torch.from_numpy(spec_k.astype(np.int32)))
        return self._run_chunk(
            ("spec", k, n_rounds, greedy),
            lambda steps=None: self._spec_chunk_fn(greedy, k, n_rounds,
                                                   warm=steps is not None),
            greedy)

    def _chunk_results(self, poison: np.ndarray, greedy: bool,
                       shape=None) -> np.ndarray:
        """One decode chunk (``_launch``) folded into the host state:
        emitted, then the extra columns (``_fold``)."""
        spec_k = self._adaptive.k if shape is not None else None
        return self._fold(self._launch(poison, greedy, shape, spec_k),
                          self.cache, slice(None))

    def _dispatch_chunk(self, poison: np.ndarray):
        """Run one decode chunk from the host slot state, ``poison`` (B,)
        written into its static buffer, and fold its results back into the
        host state. Returns (emitted (B, chunk), finite (B,)) as numpy."""
        t0 = time.perf_counter()
        h = self._host
        live = int(h["live"].sum())
        greedy = bool((h["temp"] == 0.0).all())
        if self.speculative is not None:
            emitted, finite = self._dispatch_spec_chunk(greedy, poison)
        else:
            got = self._chunk_results(poison, greedy)
            emitted, finite = got[:, :-1], got[:, -1] != 0
        self.chunks += 1
        self.chunk_times.append((live, time.perf_counter() - t0))
        return emitted, finite

    def _first_token(self, slot: int, req: Request, logits) -> int:
        """A request's first token off its prefill logits (1, V), shared by
        whole admission and the lane's final chunk (the reference's
        ``_first_token``): argmax, or a draw from the slot's generator
        re-seeded with ``req.seed``."""
        gen = self._gens[slot]
        gen.manual_seed(req.seed)
        temp = torch.full((1,), req.temperature, dtype=torch.float32,
                          device=self.device)
        tok0 = sample_tokens(logits, temp, req.temperature == 0.0, gen)
        return int(tok0[0])

    def _admit_dispatch(self, slot: int, req: Request) -> int:
        """The batch-1 prefill of ``req`` into ``slot`` and its first token
        (the reference's ``_admit_fn``)."""
        tokens = torch.as_tensor(np.asarray(req.tokens)[None],
                                 dtype=torch.int64).to(self.device)
        logits, _ = prefill_into_slot(self.cfg, self.params,
                                      {"tokens": tokens}, self.cache, slot,
                                      self.max_len, self.policy.kv_fmt)
        return self._first_token(slot, req, logits)

    def _lane_route(self, slot: int):
        """What a lane chunk into ``slot`` runs with: (graph key prefix,
        params, cache, kv_fmt, act_fmt)."""
        return (), self.params, self.cache, self.policy.kv_fmt, None

    def _lane_fn(self, with_head: bool, params, cache, kv_fmt, act_fmt,
                 wrapped: bool = False):
        """One lane chunk from the lane's static buffers (the reference's
        ``_lane_chunk_fn``; ``wrapped``, the ring lane). Returns the logits
        (1, V), or the hidden row (1, D) when ``with_head`` is false."""
        cfg, lane, tok, idx = self.cfg, self.lane, self._lane_tok, \
            self._lane_idx
        return lambda: prefill_chunk(cfg, params, tok, cache, idx[0:1],
                                     idx[1:2], idx[2:3], lane, kv_fmt,
                                     with_head=with_head, act_fmt=act_fmt,
                                     wrapped=wrapped)[0]

    def _lane_dispatch(self, slot: int, tokens, offset: int,
                       final: bool):
        """Advance the lane by one chunk of ``tokens`` (n_valid <= P
        prompt tokens at ``offset``) into ``slot``: the static buffers
        filled from the host, then on CUDA a replay of the chunk's graph
        (captured at its first use), on the CPU the eager chunk. A chunk at
        an offset past the lane's rows runs the ring lane (the reference's
        ``wrapped=off >= lane rows``), a graph of its own. Returns the
        output of ``_lane_fn(final, wrapped)``."""
        toks = np.zeros((1, self.p_chunk), np.int64)
        toks[0, :len(tokens)] = tokens
        self._lane_tok.copy_(torch.from_numpy(toks))
        self._lane_idx.copy_(torch.tensor([slot, offset, len(tokens)],
                                          dtype=torch.int32))
        route, *how = self._lane_route(slot)
        wrapped = offset >= self._lane_rows
        if self.device.type != "cuda":
            return self._lane_fn(final, *how, wrapped)()
        head = (final, "ring") if wrapped else (final,)
        key = route + head if route or wrapped else final
        if key not in self._lane_graphs:
            self._lane_graphs[key] = capture_graph(
                self._lane_fn(final, *how, wrapped), self.device,
                keep=recurrent_state(how[1], self.lane))
        graph, out = self._lane_graphs[key]
        graph.replay()
        self.lane_replays += 1
        return out

    def _reset_dispatch(self, slot: int) -> None:
        self._disarm(slot)
        reset_slot(self.cfg, self._slot_cache(slot), slot)

    # -- host loop -----------------------------------------------------------

    def _emit(self, event: str, **fields) -> None:
        self.journal.emit(logger, event, **fields)

    def _arm_slot(self, slot: int, req: Request, tok0: int) -> None:
        """Host slot state for a freshly admitted, decoding request."""
        h = self._host
        h["tok"][slot] = tok0
        h["done"][slot] = False
        h["live"][slot] = True
        h["n_gen"][slot] = 0
        h["max_new"][slot] = req.max_new
        h["temp"][slot] = req.temperature
        h["stop"][slot] = -1 if req.stop_token is None else req.stop_token
        self._disarm(slot)
        if self.speculative is not None:
            self._adaptive.arm(slot)

    def _park_slot_flags(self, slot: int) -> None:
        """Host flags of a slot leaving service or prefilling in the lane:
        not live, done, greedy (a parked slot never holds the chunk in
        sampled mode), no stop, the canaries disarmed."""
        h = self._host
        h["live"][slot] = False
        h["done"][slot] = True
        h["temp"][slot] = 0.0
        h["stop"][slot] = -1
        self._disarm(slot)

    def _disarm(self, slot: int) -> None:
        """Disarm a slot's canaries: every path that writes its state
        between chunks (admission, the lane, a restore, a reset, a park)
        calls this first, so the write is not taken for corruption."""
        self._kv_armed[slot] = False
        self._ssm_armed[slot] = False

    def _decoding_state(self, req: Request, admit_time: float,
                        clock) -> Dict[str, Any]:
        return {"admit_time": admit_time, "out": [], "prev_n_gen": 0,
                "queue_delay": admit_time - req.arrival_time,
                "ttft": clock() - req.arrival_time, "decode_spent": 0.0}

    def _admit(self, slot: int, req: Request, now: float,
               clock) -> Dict[str, Any]:
        t0 = time.perf_counter()
        tok0 = self._admit_dispatch(slot, req)
        self.admit_seconds.append(time.perf_counter() - t0)
        self._arm_slot(slot, req, tok0)
        self._emit("admit", uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), prompt=len(req.tokens),
                   max_new=req.max_new, queue_delay=now - req.arrival_time)
        return self._decoding_state(req, now, clock)

    def _admit_ready(self, sched: SlotScheduler, state: Dict[int, Any],
                     now: float, clock) -> None:
        """Whole-prompt admission: every (free slot, arrived request) pair.
        A pick with a snapshot resumes from it instead of prefilling."""
        while True:
            adm = sched.next_admission(now)
            if adm is None:
                return
            slot, req = adm
            snap = sched.resumable.pop(req.uid, None)
            if snap is not None:
                self._resume(sched, state, slot, req, snap, clock)
            else:
                state[slot] = self._admit(slot, req, now, clock)

    # the lane cursor: None while the lane is idle (a sharded engine keeps
    # one a shard)
    def _park_lane(self) -> None:
        self._pf = None

    def _lane_busy(self) -> bool:
        return self._pf is not None

    def _drop_lane_cursor(self, slot: int) -> None:
        """Forget the lane cursor feeding ``slot`` (an abort): the lane
        scratch needs no cleanup, since a later prompt reads only rows it
        wrote."""
        if self._pf is not None and self._pf["slot"] == slot:
            self._pf = None

    def _start_prefill(self, sched: SlotScheduler, slot: int, req: Request,
                       now: float) -> Dict[str, Any]:
        """Mark a slot PREFILLING and park its flags (it rides the decode
        chunk not live until armed); returns its lane cursor."""
        sched.mark_prefilling(slot)
        self._park_slot_flags(slot)
        self._emit("prefill-start", uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), prompt=len(req.tokens),
                   chunks=-(-len(req.tokens) // self.p_chunk),
                   queue_delay=now - req.arrival_time)
        return {"slot": slot, "req": req, "offset": 0, "admit_time": now}

    def _advance_lane(self, sched: SlotScheduler, state: Dict[int, Any],
                      clock) -> None:
        """Chunked admission: start or advance the one in-flight prefill by
        one lane chunk (``p_chunk`` prompt tokens at most). After the final
        chunk, the first token and ``pos[slot] = T`` arm the slot as a
        whole admission would."""
        now = clock()
        while self._pf is None:
            adm = sched.next_admission(now)
            if adm is None:
                return
            slot, req = adm
            snap = sched.resumable.pop(req.uid, None)
            if snap is not None:    # a resume takes no lane: admit on
                self._resume(sched, state, slot, req, snap, clock)
                continue
            self._pf = self._start_prefill(sched, slot, req, now)
        t0 = time.perf_counter()
        pf = self._pf
        slot, req, off = pf["slot"], pf["req"], pf["offset"]
        t = len(req.tokens)
        n_valid = min(self.p_chunk, t - off)
        final = off + n_valid >= t
        out = self._lane_dispatch(
            slot, np.asarray(req.tokens[off:off + n_valid]), off, final)
        pf["offset"] = off + n_valid
        if final:
            tok0 = self._first_token(slot, req, out)
            self._slot_cache(slot)["pos"][slot] = t
        self.lane_chunks += 1
        self.lane_seconds.append(time.perf_counter() - t0)
        if not final:
            return
        self._arm_slot(slot, req, tok0)
        sched.mark_decoding(slot)
        state[slot] = self._decoding_state(req, pf["admit_time"], clock)
        self._emit("prefill-done", uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), prompt=t,
                   ttft=state[slot]["ttft"])
        self._pf = None

    # -- the lifecycle: results, cancellation, deadlines, shedding -----------

    _EVENT_OF = {Status.CANCELLED: "cancel",
                 Status.DEADLINE_EXPIRED: "expire",
                 Status.SHED: "shed"}

    def cancel(self, uid: int) -> None:
        """Ask for ``uid`` to be cancelled in the current ``serve``, at the
        next chunk boundary: a queued request is dropped, a prefilling one
        aborts its lane and frees its slot, a decoding one ends with its
        partial output, each with ``Status.CANCELLED``. An unknown or
        finished uid is a no-op. Safe from a ``progress_cb``."""
        self._cancel_uids.add(uid)

    def suspend(self, uid: int) -> None:
        """Ask for ``uid`` to be suspended at the next chunk boundary: a
        decoding request is snapshotted (``SlotSnapshot``) and requeued
        resumable, and when the admission policy next picks it (a slot
        free) it resumes bit for bit as if it had never left; a prefilling
        one aborts its lane and requeues plain (its prompt restarts from
        chunk 0). A queued, unknown or finished uid is a no-op. Safe from
        a ``progress_cb``."""
        self._suspend_uids.add(uid)

    def _unadmitted(self, sched: SlotScheduler, req: Request, status: str,
                    now: float, results: List[RequestResult]) -> None:
        """The result of a request that leaves the queue: one that never
        had a first token, or a suspended one, whose snapshot is consumed
        here into its partial output and realized timings."""
        snap = sched.resumable.pop(req.uid, None)
        out = (np.asarray(snap.out, np.int32) if snap is not None
               else np.zeros((0,), np.int32))
        results.append(RequestResult(
            uid=req.uid, tokens=out, n_generated=len(out),
            queue_delay=(snap.queue_delay if snap is not None
                         else now - req.arrival_time),
            ttft=snap.ttft if snap is not None else float("inf"),
            decode_seconds=snap.decode_spent if snap is not None else 0.0,
            status=status,
            degraded=sched.degraded.pop(req.uid, None) is not None))
        self._emit(self._EVENT_OF[status], uid=req.uid, status=status,
                   queue_delay=now - req.arrival_time)

    def _finish_slot(self, sched: SlotScheduler, state: Dict[int, Any],
                     slot: int, status: str, now: float,
                     results: List[RequestResult]) -> None:
        """Retire a decoding slot with its (possibly partial) output:
        scheduler release, device park (``reset_slot``), host flags, result
        and ``finish`` event, for OK completion and eviction alike."""
        req = sched.release(slot)
        st = state.pop(slot)
        self._reset_dispatch(slot)
        self._park_slot_flags(slot)
        # occupied seconds only: this tenancy's and those before any
        # suspension (the parked wall time never counts)
        res = RequestResult(
            uid=req.uid, tokens=np.asarray(st["out"], np.int32),
            n_generated=len(st["out"]), queue_delay=st["queue_delay"],
            ttft=st["ttft"],
            decode_seconds=st["decode_spent"] + now - st["admit_time"],
            status=status,
            degraded=sched.degraded.pop(req.uid, None) is not None)
        results.append(res)
        self._emit("finish", uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), status=res.status,
                   n=res.n_generated, ttft=res.ttft, tok_s=res.decode_tok_s)

    def _abort_prefill(self, sched: SlotScheduler, slot: int) -> Request:
        """Tear down a PREFILLING slot: its lane cursor dropped, the slot
        parked and freed."""
        self._drop_lane_cursor(slot)
        req = sched.release(slot)
        self._reset_dispatch(slot)
        self._park_slot_flags(slot)
        return req

    def _end_active(self, sched: SlotScheduler, state: Dict[int, Any],
                    slot: int, status: str, now: float,
                    results: List[RequestResult]) -> None:
        if sched.phase.get(slot) == PREFILLING:
            req = self._abort_prefill(sched, slot)
            self._unadmitted(sched, req, status, now, results)
        else:
            self._finish_slot(sched, state, slot, status, now, results)

    # -- slot snapshots: suspend, resume, preempt -----------------------------

    def _snap_dispatch(self, slot: int) -> Dict[str, Any]:
        """Slot ``slot`` of its arena as a batch-1 cache (a device copy,
        a paged slot gathered into the dense layout)."""
        return read_cache_slot(self._slot_cache(slot), slot)

    def _restore_dispatch(self, slot: int, snap: SlotSnapshot) -> None:
        """Write a snapshot's payload into ``slot``: its trimmed rows copied
        to the device, zero-padded there back to the slot's capacity (the
        padding lies past ``pos``), then one ``write_cache_slot`` of the
        whole slot, packed bytes verbatim, no dequantize."""
        self._disarm(slot)
        cache = self._slot_cache(slot)
        dev = snap.device
        dev = {"pos": dev["pos"].to(self.device),
               "layers": [{name: leaf.to(self.device)
                           for name, leaf in layer.items()}
                          for layer in dev["layers"]]}
        write_cache_slot(cache, unpack_device_state(
            dev, slot_row_capacity(cache)), slot)

    def _snapshot_slot(self, sched: SlotScheduler, state: Dict[int, Any],
                       slot: int, clock) -> SlotSnapshot:
        """A read-only ``SlotSnapshot`` of a DECODING slot: the slot goes on
        decoding undisturbed, which lets ``checkpoint`` read a running
        engine. K/V rows are trimmed to ``min(pos, capacity)``: the rows
        below an unwrapped ring pointer, the whole ring once it wrapped."""
        req = sched.active[slot]
        solo = self._snap_dispatch(slot)
        pos = int(solo["pos"][0])
        rows = slot_row_capacity(solo)
        used = min(pos, rows) if rows is not None else 0
        st, h = state[slot], self._host
        return SlotSnapshot(
            req=req, pos=pos, used_rows=used,
            device=pack_device_state(solo, used),
            tok=int(h["tok"][slot]), key=self._gens[slot].get_state(),
            n_gen=int(h["n_gen"][slot]), max_new=int(h["max_new"][slot]),
            temp=float(h["temp"][slot]), stop=int(h["stop"][slot]),
            out=list(st["out"]), queue_delay=st["queue_delay"],
            ttft=st["ttft"],
            decode_spent=st["decode_spent"] + (clock() - st["admit_time"]),
            spec_k=(int(self._adaptive.k[slot])
                    if self.speculative is not None else 0))

    def snapshot_slot(self, slot: int) -> SlotSnapshot:
        """A read-only snapshot of a live decoding slot, mid-serve (from a
        ``progress_cb``)."""
        if self._sched is None or slot not in self._state:
            raise ValueError(f"slot {slot} holds no live request")
        return self._snapshot_slot(self._sched, self._state, slot,
                                   self._clock)

    def _suspend_slot(self, sched: SlotScheduler, state: Dict[int, Any],
                      slot: int, clock, event: str = "suspend") -> None:
        """Snapshot a DECODING slot, park it and requeue its request
        resumable."""
        snap = self._snapshot_slot(sched, state, slot, clock)
        req = sched.suspend_to_queue(slot, snap)
        state.pop(slot, None)
        self._reset_dispatch(slot)
        self._park_slot_flags(slot)
        self._emit(event, uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), n_gen=snap.n_gen,
                   pos=snap.pos, nbytes=snap.nbytes)

    def _resume(self, sched: SlotScheduler, state: Dict[int, Any],
                slot: int, req: Request, snap: SlotSnapshot, clock,
                event: str = "resume") -> None:
        """Restore a snapshot into ``slot`` and rejoin the decode chunk.
        Everything a chunk reads comes back as it was suspended: K/V rows,
        ring pointer, Mamba state, next token, the generator's state (set
        into this slot's generator, which every sampled graph has
        registered: the next replay draws from it), the budget counters,
        the sampling row and the learned draft length."""
        self._restore_dispatch(slot, snap)
        h = self._host
        h["tok"][slot] = snap.tok
        h["done"][slot] = False
        h["live"][slot] = True
        h["n_gen"][slot] = snap.n_gen
        h["max_new"][slot] = snap.max_new
        h["temp"][slot] = snap.temp
        h["stop"][slot] = snap.stop
        self._gens[slot].set_state(snap.key)
        if self.speculative is not None:
            self._adaptive.arm(slot, snap.spec_k)
        sched.mark_decoding(slot)
        state[slot] = {"admit_time": clock(), "out": list(snap.out),
                       "prev_n_gen": snap.n_gen,
                       "queue_delay": snap.queue_delay, "ttft": snap.ttft,
                       "decode_spent": snap.decode_spent}
        self._emit(event, uid=req.uid, slot=slot,
                   shard=self._shard_of(slot), n_gen=snap.n_gen,
                   pos=snap.pos)

    def _resume_ready(self, sched: SlotScheduler, state: Dict[int, Any],
                      clock) -> None:
        """Resume the resumable requests the policy picks, into free slots,
        before any lane or admission work: a resume is one restore, so it
        never waits behind a prompt."""
        now = clock()
        while True:
            adm = sched.next_resume(now)
            if adm is None:
                return
            slot, req = adm
            self._resume(sched, state, slot, req,
                         sched.resumable.pop(req.uid), clock)

    def _preempt_sweep(self, sched: SlotScheduler, state: Dict[int, Any],
                       clock) -> None:
        """Apply the preemption policy at the chunk boundary."""
        if self.preemption is None:
            return
        for slot in self.preemption.victims(sched, clock()):
            self._suspend_slot(sched, state, slot, clock, event="preempt")

    def drain_shard(self, shard: int) -> None:
        """Take ``shard`` out of rotation: sharded engines only
        (``ShardedContinuousEngine.drain_shard``), so an unsharded engine
        refuses a ``shard_down`` fault loudly."""
        raise ValueError("drain_shard needs a sharded engine "
                         "(ShardedContinuousEngine)")

    # -- containment: quarantine, the canaries, fault injection ---------------

    def _quarantine(self, sched: SlotScheduler, state: Dict[int, Any],
                    results: List[RequestResult], bad: np.ndarray,
                    cause: Dict[int, str], clock) -> None:
        """Contain the slots that tripped a detector this chunk.

        Runs before the harvest, so the faulted chunk's tokens are dropped.
        The slot is released, reset and parked, and the victim either
        requeues (``retries`` left: a fresh prefill replays it from its
        prompt, so a one-shot fault yields the full fault-free stream) or
        ends ``FAILED`` with its pre-fault prefix. Healthy slots are not
        touched: decode rows are independent, so their tokens and cache
        are the fault-free run's, bit for bit."""
        for slot in [s for s in list(sched.active) if bad[s]]:
            req = sched.active[slot]
            self._emit("quarantine", uid=req.uid, slot=slot,
                       shard=self._shard_of(slot), cause=cause.get(slot),
                       retries_left=req.retries,
                       chunk=self.chunks - 1)
            if req.retries <= 0:
                self._finish_slot(sched, state, slot, Status.FAILED, clock(),
                                  results)
                continue
            sched.release(slot)
            state.pop(slot)
            self._reset_dispatch(slot)
            self._park_slot_flags(slot)
            sched.submit(dataclasses.replace(req, retries=req.retries - 1))
            self._emit("requeue", uid=req.uid, retries_left=req.retries - 1)

    def _chunk_horizon(self) -> int:
        """The most K/V rows one slot may write in the next decode chunk
        (the K/V canary leaves the ring rows inside it out)."""
        if self.speculative is None:
            return self.chunk
        k, n_rounds = self._spec_round_shape()
        return n_rounds * (k + 1)

    def _kv_check(self) -> np.ndarray:
        return kv_slot_checksum(
            self.cfg, self.cache, torch.from_numpy(self._kv_upto),
            self._kv_horizon).cpu().numpy()

    def _ssm_check(self) -> np.ndarray:
        return ssm_state_checksum(self.cfg, self.cache).cpu().numpy()

    def _kv_refresh(self) -> None:
        """Before the chunk: fold each live slot's K/V rows that the chunk
        cannot write (``kv_slot_checksum``, window-aware: a wrapped ring's
        rows outside the write horizon stay covered; only a horizon
        spanning the whole window disarms). Also the check of the SSM
        at-rest canary: the state folded after the last chunk
        (``_ssm_rearm``) must read back the same, since nothing but decode
        moves an armed slot's state; a trip joins this chunk's
        containment."""
        if self._has_attn_kv:
            pos = self._positions()
            armed = self._host["live"].copy()
            hz = self._chunk_horizon()
            w = self.cfg.sliding_window
            if w and hz >= w:
                armed[:] = False    # the whole ring is writable: vacuous
            self._kv_armed = armed
            self._kv_horizon = hz
            self._kv_upto = np.where(armed, pos, 0).astype(np.int64)
            self._kv_sum = self._kv_check()
        if self._has_ssm:
            self._ssm_bad = ((self._ssm_check() != self._ssm_sum)
                             & self._ssm_armed & self._host["live"])
        else:
            self._ssm_bad[:] = False

    def _kv_verify(self) -> np.ndarray:
        """(B,) bool: armed slots whose pinned K/V rows changed bits."""
        if not self._has_attn_kv:
            return np.zeros((self.n_slots,), bool)
        return (self._kv_check() != self._kv_sum) & self._kv_armed

    def _ssm_rearm(self) -> None:
        """After the chunk: fold the live slots' recurrent state and arm
        them for the next ``_kv_refresh``'s at-rest check."""
        self._ssm_sum = self._ssm_check()
        self._ssm_armed = self._host["live"].copy()

    def _inject_faults(self, sched: SlotScheduler) -> np.ndarray:
        """Apply the due faults of the serve's ``FaultPlan``; returns the
        chunk's (B,) poison mask. Without a plan, all False and nothing
        else. A fault aimed at a request waits, unfired, until that request
        decodes (one aimed at a queued request fires after its admission).
        A K/V flip edits the cache's buffers in place, so the next replay
        reads it."""
        poison = np.zeros((self.n_slots,), bool)
        plan = self._fault_plan
        if plan is None:
            return poison
        ci, live = self.chunks, self._host["live"]
        for i, f in plan.pending("delay", ci):
            plan.fire(i)
            self._emit("fault", kind="delay", shard=f.shard,
                       seconds=f.seconds, chunk=ci)
            time.sleep(f.seconds)
        for i, f in plan.pending("shard_down", ci):
            plan.fire(i)
            self._emit("fault", kind="shard_down", shard=f.shard, chunk=ci)
            self.drain_shard(f.shard)
        uid2slot = {r.uid: s for s, r in sched.active.items()}
        for i, f in plan.pending("nan_logits", ci):
            s = uid2slot.get(f.uid)
            if s is None or not live[s]:
                continue
            plan.fire(i)
            poison[s] = True
            self._emit("fault", kind="nan_logits", uid=f.uid, slot=s,
                       chunk=ci)
        for i, f in plan.pending("kv_flip", ci):
            s = uid2slot.get(f.uid)
            if s is None or not live[s]:
                continue
            eng, loc = self._owner(s)
            n_rows = int(eng._slot_cache(loc)["pos"][loc])
            if n_rows <= 0:
                continue
            plan.fire(i)
            flip_kv_bytes(eng._slot_cache(loc), loc, n_rows, plan.rng(i),
                          n_bytes=f.n_bytes)
            self._emit("fault", kind="kv_flip", uid=f.uid, slot=s,
                       n_bytes=f.n_bytes, chunk=ci)
        return poison

    def _contain(self, sched: SlotScheduler, state: Dict[int, Any],
                 results: List[RequestResult], finite: np.ndarray,
                 clock) -> None:
        """After a chunk, before its harvest: the sentinel (always) and the
        canaries (``kv_integrity``) name the bad live slots, each with its
        first cause, and ``_quarantine`` contains them."""
        live = self._host["live"]
        bad = ~finite & live
        cause = {int(s): "nan_logits" for s in np.nonzero(bad)[0]}
        if self.kv_integrity:
            for name, trip in (("kv_integrity", self._kv_verify()),
                               ("ssm_integrity", self._ssm_bad)):
                trip = trip & live
                for s in np.nonzero(trip & ~bad)[0]:
                    cause[int(s)] = name
                bad = bad | trip
        if bad.any():
            self._quarantine(sched, state, results, bad, cause, clock)

    # -- crash recovery: checkpoint, restore ----------------------------------

    def checkpoint(self, path) -> Dict[str, Any]:
        """Write the running serve's resumable state to ``path``, from a
        ``progress_cb`` (a chunk boundary, the engine's one consistent
        point): a read-only ``SlotSnapshot`` of every decoding slot (the
        slots decode on), the queue with its pending snapshots, the
        prefilling requests as plain restarts, the results so far and the
        journal cursor. The write is atomic (write, then rename). A fresh
        engine's ``restore(path)`` then ``serve`` finishes the work."""
        sched, state = self._sched, self._state
        if sched is None:
            raise RuntimeError("checkpoint() runs mid-serve: call it from a "
                               "progress_cb")
        snaps, restarts = [], []
        for slot in list(sched.active):
            if sched.phase.get(slot) == PREFILLING:
                restarts.append(sched.active[slot])
            else:
                snaps.append(self._snapshot_slot(sched, state, slot,
                                                 self._clock))
        self._emit("checkpoint", path=str(path), live=len(snaps),
                   queued=len(sched.queue), chunk=self.chunks)
        ck = {"version": 1, "cfg": self.cfg.name, "kv": self.policy.kv_fmt,
              "n_slots": self.n_slots, "max_len": self.max_len,
              "seq": self.journal.seq, "chunk_idx": self.chunks,
              "snapshots": snaps, "prefilling": restarts,
              "queued": list(sched.queue),
              "resumable": dict(sched.resumable),
              "results": list(self._results)}
        save_checkpoint(path, ck)
        return ck

    def restore(self, path) -> Tuple[List[Request], List[RequestResult]]:
        """Load a checkpoint into this (fresh) engine. Returns (requests,
        prior results): hand ``requests`` to ``serve`` (the suspended and
        the decoding ones resume from their snapshots, the others admit
        as usual) and join its results to ``prior`` (those that ended
        before the checkpoint). Arrival times are rebased to 0 (their
        waits happened; the snapshots carry the realized timings); the
        journal goes on from the checkpoint's cursor. A checkpoint of
        another model or KV format, or of a larger ``max_len``, is
        refused."""
        ck = load_checkpoint(path)
        if ck["cfg"] != self.cfg.name or ck["kv"] != self.policy.kv_fmt:
            raise ValueError(
                f"checkpoint was taken on cfg={ck['cfg']!r} kv={ck['kv']!r};"
                f" this engine is cfg={self.cfg.name!r} "
                f"kv={self.policy.kv_fmt!r}")
        if ck["max_len"] > self.max_len:
            raise ValueError(f"checkpoint max_len {ck['max_len']} exceeds "
                             f"this engine's {self.max_len}")
        self.journal.seq = ck["seq"]
        self._pending_resume = dict(ck["resumable"])
        reqs: List[Request] = []
        for snap in ck["snapshots"]:
            self._pending_resume[snap.req.uid] = snap
            reqs.append(snap.req)
        reqs.extend(ck["prefilling"])
        reqs.extend(ck["queued"])
        reqs = [dataclasses.replace(r, arrival_time=0.0) for r in reqs]
        self._emit("restore", path=str(path), n=len(reqs),
                   chunk=ck["chunk_idx"])
        return reqs, list(ck["results"])

    # the journal kinds that end a request (a uid that reached one needs
    # no replay): finish covers OK and FAILED; a requeue after a
    # quarantine is not terminal, the retry's later finish is
    _TERMINAL_KINDS = frozenset(("finish", "cancel", "expire", "shed"))

    def restore_from_journal(self, requests: Sequence[Request],
                             messages: Iterable[str]
                             ) -> Tuple[List[Request], List[int]]:
        """Rebuild a crashed serve's pending work from its event log alone
        (no checkpoint). Returns the ``requests`` that reached no terminal
        record, rebased to arrival 0 (each re-enters by a fresh prefill:
        its tokens are generated again, bit for bit), and the sequence gaps
        ``events.replay`` found (a gap means the log lost records, and the
        pending set may serve too much). The journal goes on past the
        highest replayed record."""
        events, gaps = replay(messages)
        done = {e["uid"] for e in events
                if e.get("event") in self._TERMINAL_KINDS and "uid" in e}
        seqs = [e["seq"] for e in events if isinstance(e.get("seq"), int)]
        if seqs:
            self.journal.seq = max(self.journal.seq, max(seqs) + 1)
        pending = [dataclasses.replace(r, arrival_time=0.0)
                   for r in requests if r.uid not in done]
        self._emit("restore", source="journal", n=len(pending),
                   replayed=len(events), gaps=len(gaps))
        return pending, gaps

    def _lifecycle(self, sched: SlotScheduler, state: Dict[int, Any],
                   results: List[RequestResult], clock) -> None:
        """The chunk-boundary sweep (cancels, deadlines, shedding, then
        suspensions), before admission so that a doomed request never
        takes a prefill, and before the decode chunk so that an evicted
        slot spends nothing."""
        now = clock()
        uids = set()
        while self._cancel_uids:            # safe against concurrent adds
            uids.add(self._cancel_uids.pop())
        for uid in uids:
            req = sched.pop_queued(uid)
            if req is not None:
                self._unadmitted(sched, req, Status.CANCELLED, now, results)
                continue
            slot = next((s for s, r in sched.active.items() if r.uid == uid),
                        None)
            if slot is not None:            # else unknown or finished
                self._end_active(sched, state, slot, Status.CANCELLED, now,
                                 results)
        for req in sched.expire_queued(now):
            self._unadmitted(sched, req, Status.DEADLINE_EXPIRED, now,
                             results)
        for slot in list(sched.active):
            req = sched.active[slot]
            if req.deadline_s is not None and \
                    now - req.arrival_time > req.deadline_s:
                self._end_active(sched, state, slot,
                                 Status.DEADLINE_EXPIRED, now, results)
        for req in sched.enforce_bounds(now):
            self._unadmitted(sched, req, Status.SHED, now, results)
        uids = set()
        while self._suspend_uids:           # safe against concurrent adds
            uids.add(self._suspend_uids.pop())
        for uid in uids:
            slot = next((s for s, r in sched.active.items() if r.uid == uid),
                        None)
            if slot is None:                # queued, unknown or finished
                continue
            if sched.phase.get(slot) == PREFILLING:
                sched.queue.append(self._abort_prefill(sched, slot))
                self._emit("suspend", uid=uid, slot=slot,
                           shard=self._shard_of(slot), resumable=False)
            else:
                self._suspend_slot(sched, state, slot, clock)

    def _check_request(self, r: Request) -> None:
        """A request the engine cannot serve right is refused at submit:
        a prompt and budget that overflow the cache (its slot would run
        past the last row; a sliding-window ring wraps instead), or a
        prompt longer than the lane's scratch (unless the lane is a ring
        too, ``_lane_ring``)."""
        if not self.cfg.sliding_window and \
                len(r.tokens) + r.max_new > self.max_len:
            raise ValueError(
                f"request uid={r.uid}: prompt ({len(r.tokens)}) + "
                f"max_new ({r.max_new}) exceeds max_len ({self.max_len})")
        if self.prefill_mode == "chunked" and not self._lane_ring and \
                len(r.tokens) > self._lane_rows:
            raise ValueError(
                f"request uid={r.uid}: prompt ({len(r.tokens)}) exceeds "
                f"the prefill-lane scratch ({self._lane_rows} rows)")

    def _make_sched(self) -> SlotScheduler:
        sched = SlotScheduler(self.n_slots, policy=self.admission_policy,
                              max_queue=self.max_queue,
                              shedding=self.shedding, journal=self.journal)
        self._seed_sched(sched)
        return sched

    def _seed_sched(self, sched: SlotScheduler) -> None:
        """Hand a restore's pending snapshots to the serve's scheduler."""
        sched.resumable.update(self._pending_resume)
        self._pending_resume = {}

    def serve(self, requests: List[Request], progress_cb=None,
              fault_plan: Optional[FaultPlan] = None) -> List[RequestResult]:
        """Drain ``requests`` through the slots, honouring arrival times.

        Per iteration: the lifecycle sweep (cancels, deadlines, shedding,
        suspensions); the preemption policy's victims suspended; the
        resumable requests the policy picks resumed; admission into free
        slots of the requests that have arrived (one batch-1 prefill each,
        or one lane chunk in chunked mode); the canaries' fold before the
        chunk (``kv_integrity``), the plan's due faults, one decode chunk
        over all slots, the containment checks and quarantine; harvest of
        each decoding slot's new tokens; retirement of finished slots; the
        SSM canary's fold after the chunk; then ``progress_cb(engine,
        sched)`` when given. When nothing is live and the lane is idle, the
        loop sleeps until the next arrival. Returns one result per request,
        in the order they ended (check ``status``). ``fault_plan`` (a
        ``FaultPlan``, re-armed here) injects seeded faults; None leaves
        every hook a no-op and the streams bit for bit today's.
        """
        if fault_plan is not None:
            fault_plan.reset()
            requests = fault_plan.apply_arrivals(requests)
        self._fault_plan = fault_plan
        self._cancel_uids.clear()           # cancels and suspensions of a
        self._suspend_uids.clear()          # past serve
        sched = self._make_sched()
        for r in requests:
            self._check_request(r)
            sched.submit(r)
        self._park_lane()
        for slot in range(self.n_slots):      # every slot parked at entry
            self._park_slot_flags(slot)
        self.chunks = 0
        self.chunk_times = []
        self.admit_seconds = []
        self.lane_chunks = 0
        self.lane_seconds = []
        self.stall_seconds = []
        if self.speculative is not None:
            self.spec_rounds = []
        chunked = self.prefill_mode == "chunked"
        t0 = time.time()

        def clock():
            return time.time() - t0

        state: Dict[int, Dict[str, Any]] = {}
        results: List[RequestResult] = []
        self._sched, self._state = sched, state
        self._results, self._clock = results, clock
        while True:
            self._lifecycle(sched, state, results, clock)
            if not sched.has_work:
                break
            self._preempt_sweep(sched, state, clock)
            self._resume_ready(sched, state, clock)
            waiting = bool(self._host["live"].any())
            marks = len(self.admit_seconds), len(self.lane_seconds)
            if chunked:
                self._advance_lane(sched, state, clock)
            else:
                self._admit_ready(sched, state, clock(), clock)
            if not self._host["live"].any():
                if not self._lane_busy():
                    nxt = sched.next_arrival()
                    if nxt is not None:
                        time.sleep(max(nxt - clock(), 0.0))
                continue
            if waiting:                     # decoders waited on this
                self.stall_seconds.append(
                    sum(self.admit_seconds[marks[0]:])
                    + sum(self.lane_seconds[marks[1]:]))
            if self.kv_integrity:
                self._kv_refresh()
            poison = self._inject_faults(sched)
            emitted, finite = self._dispatch_chunk(poison)
            now = clock()
            self._contain(sched, state, results, finite, clock)
            n_gen, done = self._host["n_gen"], self._host["done"]
            for slot in list(sched.active):
                st = state.get(slot)
                if st is None:              # prefilling: nothing to harvest
                    continue
                delta = int(n_gen[slot]) - st["prev_n_gen"]
                st["out"].extend(emitted[slot, :delta].tolist())
                st["prev_n_gen"] = int(n_gen[slot])
                if done[slot]:
                    self._finish_slot(sched, state, slot, Status.OK, now,
                                      results)
            if self.kv_integrity and self._has_ssm:
                self._ssm_rearm()
            if progress_cb is not None:
                progress_cb(self, sched)
        self._fault_plan = None
        self._sched = self._state = self._results = self._clock = None
        return results

