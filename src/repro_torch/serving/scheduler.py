"""Continuous batching: admit requests into the live decode slots.

``ServeEngine`` serves fixed batches in lockstep: every sequence waits for
the slowest, and a finished slot idles until the whole batch drains. The
``ContinuousEngine`` here keeps one persistent n-slot cache on the device,
and a ``SlotScheduler`` that, at every chunk boundary, retires finished
slots and prefills queued requests into them while the neighbours keep
decoding (the reference's ``serving/scheduler.py``, whole-prompt
admission). Which queued request a free slot takes is a pluggable
``AdmissionPolicy`` (FIFO, shortest prompt first, priority).

The decode chunk is the same on both devices: ``chunk`` ragged decode
steps over every slot, live-gated (a parked slot writes no K/V row and
keeps its position), with the per-slot budget, stop and emission masking
of ``mask_chunk_emissions``. On CUDA it is one captured CUDA graph per
(chunk, greedy or sampled) over static buffers and the engine's cache;
admission prefills and ``reset_slot`` write into that cache in place
between replays, and each chunk makes one host copy (emitted, tok, n_gen,
done). A capture that fails raises: there is no eager path behind it on
CUDA. On the CPU the same chunk function runs eagerly.

The oracle: a request served through the slots emits the same tokens as
the same request served alone by ``ServeEngine(loop="host")`` with the
same ``max_len`` and ``rng_seed=request.seed``, bit for bit, greedy and
sampled. It holds because a decode row's result does not depend on the
other rows (``decode_step``; the split plans of the kernels depend on no
batch size the engines use) and because each slot samples with its own
generator, re-seeded with the request's seed at admission, drawing over
its own (1, V) row as a solo engine does.

Left for later slices: the chunked-prefill lane (``prefill_mode=
"chunked"``), deadlines, cancellation, shedding, quarantine, preemption,
snapshots, tiers, paging, speculation and sharding.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.qtensor import QuantPolicy
from ..models import decode_loop, init_cache, prefill_into_slot, reset_slot
from ..models.common import ModelConfig
from .engine import (capture_graph, load_params, mask_chunk_emissions,
                     sample_tokens)
from .events import Journal

logger = logging.getLogger("repro_torch.serving.scheduler")


class Status:
    """Terminal request statuses, plain strings (they serialize into the
    event stream unchanged). This slice ends every request OK; the
    lifecycle's statuses (deadline expired, cancelled, shed, failed) come
    with it."""

    OK = "OK"


@dataclasses.dataclass
class Request:
    """One generation request entering the queue.

    ``arrival_time`` is seconds relative to the serve loop's start (0 =
    already waiting); the scheduler admits a request only once its
    arrival has passed. ``seed`` seeds this request's own sampling
    generator: a sampled request reproduces ``ServeEngine(rng_seed=seed)``
    serving it alone. ``priority`` (higher = more urgent) feeds
    ``PriorityAdmission``.
    """
    uid: int
    tokens: np.ndarray                  # (T,) int prompt
    max_new: int
    temperature: float = 0.0
    stop_token: Optional[int] = None
    arrival_time: float = 0.0
    seed: int = 0
    priority: int = 0


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request."""

    uid: int
    tokens: np.ndarray                  # (n_generated,) int32
    n_generated: int
    queue_delay: float                  # arrival -> admission (s)
    ttft: float                         # arrival -> first token (s)
    decode_seconds: float               # admission -> finish (s)
    status: str = Status.OK

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


class PriorityAdmission(AdmissionPolicy):
    """The arrived request with the highest ``Request.priority`` (ties:
    earliest arrival, then FIFO)."""

    def select(self, queue, now):
        arrived = [(-r.priority, r.arrival_time, i)
                   for i, r in enumerate(queue) if r.arrival_time <= now]
        return min(arrived)[2] if arrived else None


# ---------------------------------------------------------------------------
# slot bookkeeping
# ---------------------------------------------------------------------------

class SlotScheduler:
    """Queue and free-slot bookkeeping behind a pluggable admission policy:
    ``next_admission`` pairs the first free slot with whichever arrived
    request the policy ranks first. Pure host Python."""

    def __init__(self, n_slots: int,
                 policy: Optional[AdmissionPolicy] = None):
        self.n_slots = n_slots
        self.policy = policy or FifoPolicy()
        self.queue: List[Request] = []
        self.free: List[int] = list(range(n_slots))
        self.active: Dict[int, Request] = {}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def next_admission(self, now: float) -> Optional[Tuple[int, Request]]:
        """Pop (slot, request) if a slot is free and the policy picks one."""
        if not self.free or not self.queue:
            return None
        idx = self.policy.select(self.queue, now)
        if idx is None:
            return None
        slot = self.free.pop(0)
        req = self.queue.pop(idx)
        self.active[slot] = req
        return slot, req

    def release(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.free.append(slot)
        return req

    def next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.queue), default=None)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def continuous_chunk(cfg: ModelConfig, params, kv_fmt: Optional[str],
                     n_steps: int, greedy: bool, gens, buf, cache):
    """One decode chunk of the continuous engine (the reference's
    ``_chunk_fn`` without its fault hooks): ``n_steps`` decode steps of
    every slot from the static buffers ``buf``, live-gated, then the
    chunk's emission, stop and per-slot budget masking. A sampled chunk
    (``greedy`` false) draws each slot's noise over its own (1, V) row
    with its own generator, as a solo engine does. Returns (emitted
    (B, n), tok, n_gen, done, pos)."""
    def sample(logits):
        return sample_tokens(logits, buf["temp"], greedy, gens)

    toks, tok, new = decode_loop(cfg, params, buf["tok"], cache, n_steps,
                                 kv_fmt, sample, live=buf["live"])
    emitted, n_gen, done = mask_chunk_emissions(
        toks, buf["done"], buf["n_gen"], buf["stop"], buf["max_new"])
    return emitted, tok, n_gen, done, new["pos"]


class ContinuousEngine:
    """Continuous batching over one persistent ``n_slots`` cache.

    Whole-prompt admission: one batch-1 prefill per admitted request,
    written into its slot (``prefill_into_slot``), between decode chunks;
    it stalls every decoding slot for its length. Weights are cast at
    load time as ``ServeEngine``'s are. ``serve`` drains a list of
    requests, honouring their arrival times, and returns one
    ``RequestResult`` per request. The bitwise oracle holds up to 16 slots
    (``models.common.ROW_GROUP``, the decode GEMM's regime).

    Counters for the caller: ``replays`` (CUDA graph replays since
    construction); for the last ``serve``, ``chunks`` (decode chunks),
    ``chunk_times`` (each chunk's live slots at dispatch and host-clock
    seconds, the host copy included) and ``admit_seconds`` (each
    admission's host-clock seconds, prefill and first token).
    """

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 n_slots: int = 4, max_len: int = 2048, chunk: int = 16,
                 admission_policy: Optional[AdmissionPolicy] = None,
                 device=None):
        if chunk < 1 or n_slots < 1:
            raise ValueError(f"chunk ({chunk}) and n_slots ({n_slots}) "
                             "must be >= 1")
        self.cfg = cfg
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.admission_policy = admission_policy
        self.device = resolve_device(device)
        self.params = load_params(params, policy, self.device)
        self.cache = init_cache(cfg, n_slots, max_len, policy.kv_fmt,
                                device=self.device)
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
        self._graphs: Dict[bool, Any] = {}   # greedy -> (graph, outputs)
        self.replays = 0
        self.chunks = 0
        self.chunk_times: List[Tuple[int, float]] = []
        self.admit_seconds: List[float] = []

    # -- device work ---------------------------------------------------------

    def _chunk_fn(self, greedy: bool):
        cfg, params, kv = self.cfg, self.params, self.policy.kv_fmt
        n, gens, buf, cache = self.chunk, self._gens, self._buf, self.cache
        return lambda: continuous_chunk(cfg, params, kv, n, greedy, gens,
                                        buf, cache)

    def _dispatch_chunk(self) -> np.ndarray:
        """Run one decode chunk from the host slot state and fold its
        results back into it. Returns emitted (B, chunk) as numpy."""
        t0 = time.perf_counter()
        h = self._host
        live = int(h["live"].sum())
        for name, arr in h.items():
            self._buf[name].copy_(torch.from_numpy(arr))
        greedy = bool((h["temp"] == 0.0).all())
        if self.device.type == "cuda":
            if greedy not in self._graphs:
                self._graphs[greedy] = capture_graph(
                    self._chunk_fn(greedy), self.device,
                    () if greedy else self._gens)
            graph, outs = self._graphs[greedy]
            graph.replay()
            self.replays += 1
        else:
            outs = self._chunk_fn(greedy)()
        emitted, tok, n_gen, done, pos = outs
        self.cache["pos"].copy_(pos)
        n = self.chunk
        got = torch.cat([emitted, tok[:, None], n_gen[:, None],
                         done[:, None].to(torch.int32)], dim=1).cpu().numpy()
        h["tok"] = got[:, n].copy()
        h["n_gen"] = got[:, n + 1].copy()
        h["done"] = got[:, n + 2] != 0
        self.chunks += 1
        self.chunk_times.append((live, time.perf_counter() - t0))
        return got[:, :n]

    def _admit_dispatch(self, slot: int, req: Request) -> int:
        """The batch-1 prefill of ``req`` into ``slot`` and its first token
        (the reference's ``_admit_fn`` and ``_first_token``): argmax, or a
        draw from the slot's generator re-seeded with ``req.seed``."""
        tokens = torch.as_tensor(np.asarray(req.tokens)[None],
                                 dtype=torch.int64).to(self.device)
        logits, _ = prefill_into_slot(self.cfg, self.params,
                                      {"tokens": tokens}, self.cache, slot,
                                      self.max_len, self.policy.kv_fmt)
        gen = self._gens[slot]
        gen.manual_seed(req.seed)
        temp = torch.full((1,), req.temperature, dtype=torch.float32,
                          device=self.device)
        tok0 = sample_tokens(logits, temp, req.temperature == 0.0, gen)
        return int(tok0[0])

    # -- host loop -----------------------------------------------------------

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

    def _park_slot_flags(self, slot: int) -> None:
        """Host flags of a slot leaving service: not live, done, greedy (a
        parked slot never holds the chunk in sampled mode), no stop."""
        h = self._host
        h["live"][slot] = False
        h["done"][slot] = True
        h["temp"][slot] = 0.0
        h["stop"][slot] = -1

    def _admit(self, slot: int, req: Request, now: float,
               clock) -> Dict[str, Any]:
        t0 = time.perf_counter()
        tok0 = self._admit_dispatch(slot, req)
        self.admit_seconds.append(time.perf_counter() - t0)
        self._arm_slot(slot, req, tok0)
        admit_done = clock()
        self.journal.emit(logger, "admit", uid=req.uid, slot=slot,
                          prompt=len(req.tokens), max_new=req.max_new,
                          queue_delay=now - req.arrival_time)
        return {"admit_time": now, "out": [], "prev_n_gen": 0,
                "queue_delay": now - req.arrival_time,
                "ttft": admit_done - req.arrival_time}

    def _admit_ready(self, sched: SlotScheduler, state: Dict[int, Any],
                     now: float, clock) -> None:
        """Whole-prompt admission: every (free slot, arrived request) pair."""
        while True:
            adm = sched.next_admission(now)
            if adm is None:
                return
            slot, req = adm
            state[slot] = self._admit(slot, req, now, clock)

    def _finish_slot(self, sched: SlotScheduler, state: Dict[int, Any],
                     slot: int, now: float,
                     results: List[RequestResult]) -> None:
        """Retire a slot whose request is done: scheduler release, device
        park (``reset_slot``), host flags, result and ``finish`` event."""
        req = sched.release(slot)
        st = state.pop(slot)
        reset_slot(self.cfg, self.cache, slot)
        self._park_slot_flags(slot)
        res = RequestResult(
            uid=req.uid, tokens=np.asarray(st["out"], np.int32),
            n_generated=len(st["out"]), queue_delay=st["queue_delay"],
            ttft=st["ttft"], decode_seconds=now - st["admit_time"])
        results.append(res)
        self.journal.emit(logger, "finish", uid=req.uid, slot=slot,
                          status=res.status, n=res.n_generated,
                          ttft=res.ttft, tok_s=res.decode_tok_s)

    def _check_request(self, r: Request) -> None:
        """A request whose prompt and budget overflow the cache is refused
        at submit: its slot would run past the last row."""
        if len(r.tokens) + r.max_new > self.max_len:
            raise ValueError(
                f"request uid={r.uid}: prompt ({len(r.tokens)}) + "
                f"max_new ({r.max_new}) exceeds max_len ({self.max_len})")

    def serve(self, requests: List[Request]) -> List[RequestResult]:
        """Drain ``requests`` through the slots, honouring arrival times.

        Per iteration: admit into free slots the requests that have
        arrived (one batch-1 prefill each), run one decode chunk over all
        slots, harvest each slot's new tokens, retire finished slots.
        When nothing is live and the queue waits on a future arrival, the
        loop sleeps until it. Returns one result per request, in the
        order they finished.
        """
        sched = SlotScheduler(self.n_slots, policy=self.admission_policy)
        for r in requests:
            self._check_request(r)
            sched.submit(r)
        for slot in range(self.n_slots):      # every slot parked at entry
            self._park_slot_flags(slot)
        self.chunks = 0
        self.chunk_times = []
        self.admit_seconds = []
        t0 = time.time()

        def clock():
            return time.time() - t0

        state: Dict[int, Dict[str, Any]] = {}
        results: List[RequestResult] = []
        while sched.has_work:
            self._admit_ready(sched, state, clock(), clock)
            if not self._host["live"].any():
                nxt = sched.next_arrival()
                time.sleep(max(nxt - clock(), 0.0))
                continue
            emitted = self._dispatch_chunk()
            now = clock()
            n_gen, done = self._host["n_gen"], self._host["done"]
            for slot in list(sched.active):
                st = state[slot]
                delta = int(n_gen[slot]) - st["prev_n_gen"]
                st["out"].extend(emitted[slot, :delta].tolist())
                st["prev_n_gen"] = int(n_gen[slot])
                if done[slot]:
                    self._finish_slot(sched, state, slot, now, results)
        return results
