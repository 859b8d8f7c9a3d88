"""Slot-sharded continuous serving (the reference's ``serving/sharded.py``).

``ContinuousEngine`` runs one host loop over one device's slot cache. The
sharded engine runs the same loop over S shards: the ``n_slots`` slots
are S contiguous blocks of ``n_slots / S``, and shard ``s`` owns block
``s`` on its own device (``launch/mesh.py:make_serving_mesh``; a device
may hold several shards). The reference runs every shard inside one
``shard_map``'d program, and a slot write is committed by its owner alone
(value-gated updates, ``n_valid=0`` riders on the shards a dispatch does
not concern); it has no collective. Here each shard is an engine of its
own (``_Shard``: the cache slice, the static buffers, the batch-1 prefill
lane, the CUDA graphs per (chunk, greedy) and per lane chunk, the slot
generators), and every dispatch goes to the shard that owns the slot, so
nothing is gated and no shard runs work that is not its own. A decode
chunk launches each shard's graph in shard order, then folds each
shard's one host copy.

The oracle: every stream is the unsharded engine's, bit for bit. A decode
row does not depend on its neighbours (``ContinuousEngine``'s docstring),
a lane chunk is the same batch-1 program on any shard, and a slot's
generator is re-seeded from its request at admission. On CUDA it holds
while every decode row runs one GEMM regime on both sides: split-K up to
16 rows, wgmma above (``kernels/nxfp_matmul.py``), so up to 16 slots on
each side.

Weights are placed once per distinct device and shared by the shards on
it (the speculative draft too). Admission goes to the least-loaded shard
(``ShardedSlotScheduler``); in chunked mode each shard has its own lane,
so S prompts are mid-prefill at once. ``drain_shard`` (and the fault
plan's ``shard_down``) takes a shard out of rotation at the next chunk
boundary: its decoding requests migrate to the least-loaded healthy
shard's free slots through a snapshot and its restore (or suspend to the
queue when none is free), its prefilling one requeues plain.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.qtensor import QuantPolicy
from ..models.common import ModelConfig
from ..models.kvcache import kv_slot_checksum, ssm_state_checksum
from ..sharding import mesh_fingerprint
from .engine import _sync, load_params
from .scheduler import (PREFILLING, ContinuousEngine, ShardedSlotScheduler,
                        SlotScheduler)

__all__ = ["ShardedContinuousEngine"]


def _parent_attr(name: str):
    """A shard's counter that is its sharded engine's."""
    return property(lambda self: getattr(self._parent, name),
                    lambda self, v: setattr(self._parent, name, v))


class _ShardMixin:
    """One shard of a sharded engine: an engine of ``slots_per_shard``
    slots on its device, driven by the sharded engine with the shard's own
    slot indices (``lo`` is its first global slot). Its host slot state is
    a view of the sharded engine's, its generators are the sharded
    engine's, and its records and counters are the sharded engine's."""

    replays = _parent_attr("replays")
    lane_replays = _parent_attr("lane_replays")
    chunks = _parent_attr("chunks")

    def __init__(self, parent, index: int, *args, **kw):
        self._parent = parent
        self.index = index
        self.lo = index * parent.slots_per_shard
        super().__init__(*args, **kw)

    def _emit(self, event: str, **fields) -> None:
        if fields.get("slot") is not None:
            fields["slot"] += self.lo
        fields["shard"] = self.index
        self._parent._emit(event, **fields)

    def _load_weights(self, params):
        return params                 # placed once a device by the parent

    def _load_draft(self, raw_params, spec):
        return self._parent._draft_on(self, spec)


class _Shard(_ShardMixin, ContinuousEngine):
    pass


def _data_shards(mesh, n_slots: int) -> int:
    """The number of slot shards of ``mesh``, after the reference's checks:
    a ``'data'`` axis, no other axis of size > 1, ``n_slots`` divisible."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"slot sharding needs a 'data' mesh axis, got "
                         f"{mesh.axis_names}")
    extra = [a for a in mesh.axis_names
             if a != "data" and mesh.shape[a] != 1]
    if extra:
        raise ValueError(f"slot sharding supports a data-only mesh; "
                         f"non-trivial axes {extra}")
    s = int(mesh.shape["data"])
    if n_slots % s:
        raise ValueError(f"n_slots ({n_slots}) must be divisible by the "
                         f"'data' axis ({s})")
    if len(mesh.devices) != s:
        raise ValueError(f"{len(mesh.devices)} devices for {s} shards")
    return s


class ShardedContinuousEngine(ContinuousEngine):
    """``ContinuousEngine`` with its slots sharded over the ``'data'`` axis
    of ``mesh`` (``launch.mesh.make_serving_mesh``): S shards of
    ``n_slots / S`` slots, one a mesh device. Same host loop, request
    semantics and streams as the unsharded engine; every other argument
    is ``ContinuousEngine``'s (the mesh places the shards: no ``device``).
    ``shards`` are the shard engines (``shards[s].cache`` is shard ``s``'s
    cache slice); ``mesh_key`` is ``sharding.mesh_fingerprint(mesh)``.

    Beyond the unsharded engine: ``drain_shard``, ``spec_shard_stats``,
    and ``migrate_seconds`` (each live migration of the last ``serve``,
    host clock, the target's device synchronised). ``p_chunk="auto"``
    times shard 0's own decode chunk and lanes, and every shard builds its
    lane at the pick."""

    _shard_cls = _Shard

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 mesh, n_slots: int = 4, **kw):
        s = _data_shards(mesh, n_slots)
        if "device" in kw:
            raise ValueError("the mesh places the shards: pass its devices "
                             "to make_serving_mesh, not device=")
        self.mesh = mesh
        self.mesh_key = mesh_fingerprint(mesh)
        self.n_shards = s
        self.slots_per_shard = n_slots // s
        # a drained shard stays out of rotation until a new engine is built
        self._drained: set = set()
        self._drain_req: set = set()
        self.migrate_seconds: List[float] = []
        self._build_shards(cfg, params, policy, kw)
        super().__init__(cfg, params, policy, n_slots=n_slots,
                         device=mesh.devices[0], **kw)
        n = self.slots_per_shard
        self._gens = [g for sh in self.shards for g in sh._gens]
        for sh in self.shards:
            sh._host = {k: v[sh.lo:sh.lo + n] for k, v in self._host.items()}

    def _shard_kw(self) -> Dict[str, Any]:
        """Arguments every shard engine takes beyond the sharded engine's
        (the paged engine's pool a shard)."""
        return {}

    def _build_shards(self, cfg, params, policy, kw) -> None:
        """The shard engines, the weights (and draft) placed once a
        distinct device; shard 0 picks an ``"auto"`` lane width and the
        others take it."""
        placed: Dict[str, Any] = {}
        self._raw_params, self._drafts = params, {}
        self.shards: List[ContinuousEngine] = []
        for i, dev in enumerate(self.mesh.devices):
            if str(dev) not in placed:
                placed[str(dev)] = load_params(params, policy, dev)
            kw_i = dict(kw, **self._shard_kw())
            if i and kw_i.get("p_chunk") == "auto":
                kw_i["p_chunk"] = self.shards[0].p_chunk
            self.shards.append(self._shard_cls(
                self, i, cfg, placed[str(dev)], policy,
                n_slots=self.slots_per_shard, device=dev, **kw_i))
        del self._raw_params, self._drafts

    def _draft_on(self, shard: ContinuousEngine, spec):
        """The draft weights on ``shard``'s device, built by its first
        shard there."""
        key = str(shard.device)
        if key not in self._drafts:
            self._drafts[key] = ContinuousEngine._load_draft(
                shard, self._raw_params, spec)
        return self._drafts[key]

    # -- construction hooks: the device state lives on the shards -----------

    def _load_weights(self, params):
        return self.shards[0].params

    def _load_draft(self, raw_params, spec):
        return None

    def _init_slot_cache(self):
        return None

    def _build_lane(self, p_chunk: int) -> None:
        self._lane_rows = self.shards[0]._lane_rows
        self._lane_ring = self.shards[0]._lane_ring

    def _autotune_p_chunk(self, candidates) -> int:
        first = self.shards[0]
        self.p_chunk_sweep = first.p_chunk_sweep
        self.p_chunk_decode_s = first.p_chunk_decode_s
        self._build_lane(first.p_chunk)
        return first.p_chunk

    # -- device steps, each on the slot's owner ------------------------------

    def _owner(self, slot: int):
        sh = self.shards[slot // self.slots_per_shard]
        return sh, slot - sh.lo

    def _shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def _positions(self) -> np.ndarray:
        return np.concatenate([sh._positions() for sh in self.shards])

    def _chunk_results(self, poison: np.ndarray, greedy: bool,
                       shape=None) -> np.ndarray:
        """Every shard's chunk launched in shard order, then each folded
        (one host copy a shard)."""
        n = self.slots_per_shard
        k = self._adaptive.k if shape is not None else None
        outs = [sh._launch(poison[sh.lo:sh.lo + n], greedy, shape,
                           None if k is None else k[sh.lo:sh.lo + n])
                for sh in self.shards]
        return np.concatenate([sh._fold(o, sh.cache, slice(None))
                               for sh, o in zip(self.shards, outs)])

    def _admit_dispatch(self, slot: int, req) -> int:
        eng, loc = self._owner(slot)
        return eng._admit_dispatch(loc, req)

    def _reset_dispatch(self, slot: int) -> None:
        self._disarm(slot)
        eng, loc = self._owner(slot)
        eng._reset_dispatch(loc)

    def _snap_dispatch(self, slot: int) -> Dict[str, Any]:
        eng, loc = self._owner(slot)
        return eng._snap_dispatch(loc)

    def _restore_dispatch(self, slot: int, snap) -> None:
        self._disarm(slot)
        eng, loc = self._owner(slot)
        eng._restore_dispatch(loc, snap)

    def _kv_check(self) -> np.ndarray:
        n = self.slots_per_shard
        return np.concatenate([kv_slot_checksum(
            self.cfg, sh.cache,
            torch.from_numpy(self._kv_upto[sh.lo:sh.lo + n]),
            self._kv_horizon).cpu().numpy() for sh in self.shards])

    def _ssm_check(self) -> np.ndarray:
        return np.concatenate([ssm_state_checksum(self.cfg, sh.cache)
                               .cpu().numpy() for sh in self.shards])

    def spec_shard_stats(self) -> List[Dict[str, Any]]:
        """Speculative acceptance a shard since construction: accepted and
        offered candidates and their ratio (a shard whose rate lags serves
        draft-hostile traffic; its slots' k will have backed off)."""
        if self.speculative is None:
            raise ValueError("engine was built without speculative=")
        acc = self._spec_acc_slot.reshape(self.n_shards, -1).sum(axis=1)
        off = self._spec_off_slot.reshape(self.n_shards, -1).sum(axis=1)
        return [{"shard": s, "accepted": int(acc[s]),
                 "offered": int(off[s]),
                 "accept_rate": float(acc[s] / max(off[s], 1))}
                for s in range(self.n_shards)]

    # -- the scheduler -------------------------------------------------------

    def _make_sched(self) -> SlotScheduler:
        sched = ShardedSlotScheduler(self.n_shards, self.slots_per_shard,
                                     policy=self.admission_policy,
                                     max_queue=self.max_queue,
                                     shedding=self.shedding,
                                     journal=self.journal)
        self._seed_sched(sched)
        return sched

    def _seed_sched(self, sched: SlotScheduler) -> None:
        super()._seed_sched(sched)
        sched.drained |= self._drained

    # -- the lanes: one a shard ------------------------------------------------

    def _park_lane(self) -> None:
        self._pf = {}                 # shard -> its lane's cursor

    def _lane_busy(self) -> bool:
        return bool(self._pf)

    def _drop_lane_cursor(self, slot: int) -> None:
        self._pf = {sh: pf for sh, pf in self._pf.items()
                    if pf["slot"] != slot}

    def _advance_lane(self, sched: SlotScheduler, state: Dict[int, Any],
                      clock) -> None:
        """Advance every shard's lane by one chunk. First the idle lanes
        take work: a shard with a free slot and no prompt in flight admits
        from the shared queue, the least-loaded shard first (the policy
        still picks the request; a resumable pick resumes instead). Then
        each busy lane runs its chunk, in shard order, and a lane whose
        prompt is done samples the first token and arms its slot, as the
        unsharded lane does."""
        now = clock()
        while True:
            idle = [s for s in range(self.n_shards)
                    if s not in self._pf and s not in sched.drained
                    and sched.free_on(s)]
            if not idle:
                break
            shard = min(idle, key=lambda s: (sched.load(s), s))
            adm = sched.next_admission(now, shard=shard)
            if adm is None:
                break
            slot, req = adm
            snap = sched.resumable.pop(req.uid, None)
            if snap is not None:
                self._resume(sched, state, slot, req, snap, clock)
                continue
            self._pf[shard] = self._start_prefill(sched, slot, req, now)
        if not self._pf:
            return
        t0 = time.perf_counter()
        outs = {}
        for shard in sorted(self._pf):
            pf = self._pf[shard]
            slot, req, off = pf["slot"], pf["req"], pf["offset"]
            eng, loc = self._owner(slot)
            n_valid = min(self.p_chunk, len(req.tokens) - off)
            final = off + n_valid >= len(req.tokens)
            outs[shard] = (eng._lane_dispatch(
                loc, np.asarray(req.tokens[off:off + n_valid]), off,
                final), final)
            pf["offset"] = off + n_valid
        done = []
        for shard, (out, final) in outs.items():
            if not final:
                continue
            pf = self._pf.pop(shard)
            slot, req = pf["slot"], pf["req"]
            eng, loc = self._owner(slot)
            done.append((slot, req, pf, eng._first_token(loc, req, out)))
            eng._slot_cache(loc)["pos"][loc] = len(req.tokens)
        self.lane_chunks += 1
        self.lane_seconds.append(time.perf_counter() - t0)
        for slot, req, pf, tok0 in done:
            self._arm_slot(slot, req, tok0)
            sched.mark_decoding(slot)
            state[slot] = self._decoding_state(req, pf["admit_time"], clock)
            self._emit("prefill-done", uid=req.uid, slot=slot,
                       shard=self._shard_of(slot), prompt=len(req.tokens),
                       ttft=state[slot]["ttft"])

    # -- shard drain and live migration ---------------------------------------

    def drain_shard(self, shard: int) -> None:
        """Take ``shard`` out of rotation at the next chunk boundary: its
        decoding requests migrate, each to the least-loaded healthy
        shard's first free slot (snapshot, reset, restore: the stream goes
        on bit for bit), or suspend to the queue when no healthy slot is
        free; its prefilling request aborts its lane and requeues plain;
        admission routes no request there again. Draining the last healthy
        shard is refused here, at the call. Safe from a ``progress_cb``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"no shard {shard} (n_shards={self.n_shards})")
        if not (set(range(self.n_shards)) - self._drained - self._drain_req
                - {shard}):
            raise ValueError(f"draining shard {shard} would leave no "
                             "healthy shards")
        self._drain_req.add(shard)

    def _migration_target(self, sched: ShardedSlotScheduler
                          ) -> Optional[int]:
        """The least-loaded healthy shard's first free slot (None: none
        free)."""
        healthy = {sched.shard_of(s) for s in sched.free} - sched.drained
        if not healthy:
            return None
        return sched.free_on(min(healthy,
                                 key=lambda s: (sched.load(s), s)))[0]

    def _drain_sweep(self, sched: ShardedSlotScheduler,
                     state: Dict[int, Any], clock) -> None:
        while self._drain_req:              # safe against concurrent adds
            shard = self._drain_req.pop()
            if shard in self._drained:
                continue
            self._drained.add(shard)
            sched.drained.add(shard)
            self._emit("drain", shard=shard, live=sched.load(shard),
                       chunk=self.chunks)
            lo = shard * self.slots_per_shard
            for slot in range(lo, lo + self.slots_per_shard):
                if slot not in sched.active:
                    continue
                if sched.phase.get(slot) == PREFILLING:
                    req = self._abort_prefill(sched, slot)
                    sched.queue.append(req)
                    self._emit("suspend", uid=req.uid, slot=slot,
                               shard=shard, resumable=False)
                    continue
                tgt = self._migration_target(sched)
                if tgt is None:
                    self._suspend_slot(sched, state, slot, clock)
                    continue
                t0 = time.perf_counter()
                snap = self._snapshot_slot(sched, state, slot, clock)
                req = sched.reassign(slot, tgt)
                state.pop(slot, None)
                self._reset_dispatch(slot)
                self._park_slot_flags(slot)
                self._resume(sched, state, tgt, req, snap, clock,
                             event="migrate")
                _sync(self._owner(tgt)[0].device)
                self.migrate_seconds.append(time.perf_counter() - t0)

    def _lifecycle(self, sched, state, results, clock) -> None:
        super()._lifecycle(sched, state, results, clock)
        self._drain_sweep(sched, state, clock)

    def serve(self, requests, progress_cb=None, fault_plan=None):
        """``ContinuousEngine.serve``, ``migrate_seconds`` reset first."""
        self.migrate_seconds = []
        return super().serve(requests, progress_cb=progress_cb,
                             fault_plan=fault_plan)
