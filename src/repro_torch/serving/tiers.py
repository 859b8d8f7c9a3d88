"""Per-slot serving tiers: weights x KV x prefill-activation formats (the
reference's ``serving/tiers.py``).

A ``TierSpec`` names one point in {bf16, nxfp6, nxfp4, ...} weights x
{dense, nxfp4, ...} KV x {dense, amxfp4, ...} prefill activations, and
``TieredContinuousEngine`` carries one tier per slot as it carries a
temperature per slot: a request picks one with ``Request.tier``, the
others take the engine's default tier.

- Weights: one set per distinct ``weight_fmt``, loaded once
  (``load_params``: cast, or for ``weight_fmt`` None the castable leaves
  in bf16); ``tok_embed`` and ``lm_head`` stay dense.
- KV: one full ``n_slots`` cache arena per distinct ``kv_fmt``. Slot
  numbers are global (slot s exists in every arena; only its tier's arena
  holds live rows), so the scheduler, the admission and shedding policies
  are the plain engine's. A decode chunk is one dispatch per live
  (``weight_fmt``, ``kv_fmt``) group, each over the full batch with the
  other slots riding done and not live (no K/V row written, ``pos`` kept),
  and only the group's rows fold back into the host state. On CUDA each is
  a replay of a graph captured per (``weight_fmt``, ``kv_fmt``, greedy);
  a lane chunk replays a graph per (``weight_fmt``, ``kv_fmt``,
  ``act_fmt``, ``with_head``): a graph bakes in its weights and cache.
- Prefill activations: a tier with ``act_fmt`` (the economy tier's
  amxfp4) prefills with quantized activations against its packed weights,
  on CUDA through the qq GEMM (``kernels/nxfp_qq_matmul.py``), whole or in
  the lane. (The reference's XLA path prefills against dequantized dense
  copies instead, a backend speed trick; the port keeps the packed set.)
- Sampling: a sampled group's chunk draws noise from every slot's
  generator, so the generators of the slots outside the group are put back
  after its dispatch: each slot's stream stays its solo stream.

Degraded-KV rung: with ``degrade_kv_to=<tier>`` and a
``DegradeOverBudget(pool_watermark=...)`` shedding policy, KV occupancy at
the watermark (each decoding slot's rows priced at its own tier, over
every slot full at the dearest) repacks the oldest resident slot of a
dearer tier into the cheap tier at a chunk boundary: its rows dequantized
and re-encoded (``repack_kv``), moved between arenas, and the slot decodes
on under the cheap tier's weights and KV. Such a request finishes with
``degraded=True`` and a ``kv-repack`` event.

Families: dense, ssm and hybrid. A Mamba block's state (``h``, ``conv``)
lives in its slot's tier arena beside the K/V rows (none in the
attention-free ``ssm`` family): admission writes it there, a park zeroes
it there, a repack moves it bit for bit with the rows, and a group's
graph warm-up puts its arena's state back (``capture_graph(keep=)``). An
attention-free model has no KV to price (``kv_row_bytes`` 0), so its
degrade rung never fires.

Suspension: ``suspend(uid)`` snapshots a slot out of its tier's arena,
and the resume writes it back into the arena of the request's tier (a
request the degrade rung moved comes back in its degraded tier), in
whichever slot is free, bit for bit.

Guarantees (``tests/test_torch_tiers.py``,
``tests/test_torch_tiers_ssm.py``): a tier engine restricted to one tier
emits the plain ``ContinuousEngine``'s tokens at that policy, bit for
bit; each stream of a mixed-tier serve is the stream of its request
served alone at its tier. Refused at init: ``p_chunk="auto"`` (the sweep
times one arena's graphs), ``speculative=``, ``preemption=`` and
``kv_integrity=`` (as the reference's: the canaries fold one arena).

Faults: each group's dispatch takes the poison mask of its own rows
(``poison & mask``) and folds back only its own rows' ``finite``, so the
finite-logits sentinel and quarantine run as in the plain engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.formats import get_format
from ..core.pack import bytes_per_block
from ..core.qtensor import QTensor, QuantPolicy, cast_formats
from ..kernels.ops import quantize_qtensor
from ..models import (init_cache, prefill_into_slot, read_cache_slot,
                      reset_slot, write_cache_slot)
from ..models.common import ModelConfig
from ..models.kvcache import cache_rows
from .engine import load_params
from .scheduler import (DECODING, ContinuousEngine, Request, SlotScheduler,
                        continuous_chunk)
from .snapshot import _ROW_LEAVES

__all__ = ["TierSpec", "TieredContinuousEngine", "default_tiers",
           "repack_kv", "kv_row_bytes"]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One serving tier: weight x KV x prefill-activation formats. None is
    dense (bf16 weights, bf16 KV, dense activations). ``act_fmt`` shapes
    the prefill only: decode runs dense activations on every tier."""

    weight_fmt: Optional[str] = "nxfp4"
    kv_fmt: Optional[str] = "nxfp4"
    act_fmt: Optional[str] = None

    def __post_init__(self):
        for f in (self.weight_fmt, self.act_fmt):
            if f is not None:
                get_format(f)       # raises on an unknown format name
        if self.kv_fmt is not None and \
                get_format(self.kv_fmt).meta_dtype != "uint16":
            raise ValueError(
                f"kv_fmt={self.kv_fmt!r}: KV cache meta buffers are "
                f"uint16 \u2014 asymmetric (uint32-meta) formats serve "
                f"activations, not the cache")


def default_tiers(act_fmt: str = "amxfp4") -> Dict[str, TierSpec]:
    """The three-rung ladder: dense premium, cast standard, and an economy
    rung whose prefill runs quantized x quantized."""
    return {
        "premium": TierSpec(weight_fmt=None, kv_fmt=None, act_fmt=None),
        "standard": TierSpec(weight_fmt="nxfp6", kv_fmt="nxfp4",
                             act_fmt=None),
        "economy": TierSpec(weight_fmt="nxfp4", kv_fmt="nxfp4",
                            act_fmt=act_fmt),
    }


def kv_row_bytes(cfg: ModelConfig, kv_fmt: Optional[str]) -> int:
    """Bytes one token's K and V rows take across all layers of a slot (0
    for the attention-free family: its state does not grow with
    tokens)."""
    kvh, hd, n_layers = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    if cfg.attn_free:
        return 0
    if kv_fmt is None:
        return 2 * n_layers * kvh * hd * (torch.finfo(cfg.dtype).bits // 8)
    fmt = get_format(kv_fmt)
    nb = -(-hd // fmt.block_size)
    bpb = bytes_per_block(fmt.block_size, fmt.bits)
    return 2 * n_layers * kvh * nb * (bpb + 2)      # +2: uint16 meta


def repack_kv(cfg: ModelConfig, solo: Dict[str, Any],
              src_fmt: Optional[str], dst_fmt: Optional[str]):
    """Re-encode a batch-1 cache slice from one KV format to another, on
    the device its tensors lie on: packed rows dequantized to
    ``cfg.dtype`` (dense rows as they are), then encoded by the quantizer.
    Blocks run along head_dim inside one row, so every row is encoded on
    its own. Rows past ``pos`` should be zeros, so that nothing stale is
    encoded. ``pos`` and the Mamba state (``h``, ``conv``) pass through; a
    slice without attention K/V (the ``ssm`` family) is returned as it
    is."""
    if src_fmt == dst_fmt or cfg.attn_free:
        return solo
    kvh, hd = cfg.n_kv_heads, cfg.hd
    layers = []
    for layer in solo["layers"]:
        out = dict(layer)
        for base in ("k", "v"):
            if src_fmt is None:
                val = out.pop(base)
            else:
                packed = out.pop(f"{base}_packed")
                meta = out.pop(f"{base}_meta")
                b, s = packed.shape[:2]
                val = QTensor(packed, meta, src_fmt, (b, s, kvh, hd), -1,
                              hd).dequantize(cfg.dtype)
            if dst_fmt is None:
                out[base] = val.to(cfg.dtype)
            else:
                qt = quantize_qtensor(val, dst_fmt, axis=-1,
                                      device=val.device)
                out[f"{base}_packed"] = qt.packed
                out[f"{base}_meta"] = qt.meta
        layers.append(out)
    return dict(solo, layers=layers)


class TieredContinuousEngine(ContinuousEngine):
    """Continuous batching with a per-slot (weights, KV, prefill-act) tier.

    ``tiers`` maps names to ``TierSpec``; ``Request.tier`` picks one (None:
    ``default_tier``, else the first). ``degrade_kv_to`` names the tier the
    degrade rung repacks into. Other keywords are ``ContinuousEngine``'s.
    Counters beside the plain engine's, for the last ``serve``:
    ``chunk_groups`` (the group dispatches of each decode chunk) and
    ``repacks`` (slots moved by the degrade rung)."""

    def __init__(self, cfg: ModelConfig, params,
                 tiers: Dict[str, TierSpec],
                 default_tier: Optional[str] = None,
                 degrade_kv_to: Optional[str] = None, **kw):
        if not tiers:
            raise ValueError("tiers must name at least one TierSpec")
        for bad in ("speculative", "preemption"):
            if kw.get(bad) is not None:
                raise ValueError(
                    f"tiered serving does not compose with {bad}=")
        if kw.get("kv_integrity"):
            raise ValueError("tiered serving does not run the KV canaries "
                             "(per-arena checksums are a follow-up)")
        if kw.get("p_chunk") == "auto":
            raise ValueError("p_chunk='auto' probes the single-arena "
                             "cache; pick a static p_chunk")
        self.tiers = dict(tiers)
        self.default_tier = (default_tier if default_tier is not None
                             else next(iter(self.tiers)))
        if self.default_tier not in self.tiers:
            raise ValueError(f"default_tier {self.default_tier!r} not in "
                             f"tiers {sorted(self.tiers)}")
        if degrade_kv_to is not None and degrade_kv_to not in self.tiers:
            raise ValueError(f"degrade_kv_to {degrade_kv_to!r} not in "
                             f"tiers {sorted(self.tiers)}")
        self.degrade_kv_to = degrade_kv_to
        # uid -> tier: a repacked request decodes on under the cheap tier
        self._uid_tier: Dict[int, str] = {}
        dspec = self.tiers[self.default_tier]
        super().__init__(cfg, params,
                         QuantPolicy(weight_fmt=dspec.weight_fmt,
                                     kv_fmt=dspec.kv_fmt), **kw)
        # KV occupancy for the degrade rung: host arithmetic only (a
        # decoding slot holds prompt + n_gen rows)
        self._row_bytes = {spec.kv_fmt: kv_row_bytes(cfg, spec.kv_fmt)
                           for spec in self.tiers.values()}
        self._max_row_bytes = max(self._row_bytes.values())
        # a slot's KV rows (a ring's: its window); None without attention
        self._row_cap = (None if cfg.attn_free
                         else cache_rows(cfg, self.max_len))
        self.chunk_groups: List[int] = []
        self.repacks = 0

    # -- construction hooks -------------------------------------------------

    def _load_weights(self, params):
        cast = cast_formats(params)
        other = {spec.weight_fmt for spec in self.tiers.values()} - cast
        if cast and other:
            raise ValueError(
                f"the tiers' weight sets {sorted(map(str, other))} are cast "
                f"from the f32 weights, and these are cast to "
                f"{sorted(cast)}: build them without a policy")
        self._wparams: Dict[Optional[str], Any] = {}
        for spec in self.tiers.values():
            if spec.weight_fmt not in self._wparams:
                self._wparams[spec.weight_fmt] = load_params(
                    params, QuantPolicy(spec.weight_fmt, None), self.device)
        return self._wparams[self.tiers[self.default_tier].weight_fmt]

    def _init_slot_cache(self):
        self._caches: Dict[Optional[str], Dict[str, Any]] = {}
        for spec in self.tiers.values():
            if spec.kv_fmt not in self._caches:
                self._caches[spec.kv_fmt] = init_cache(
                    self.cfg, self.n_slots, self.max_len, spec.kv_fmt,
                    device=self.device)
        # each slot's tier (a parked slot keeps its last one, so that a late
        # reset reaches the right arena)
        self._slot_tier: List[str] = [self.default_tier] * self.n_slots
        return self._caches[self.tiers[self.default_tier].kv_fmt]

    # -- tier resolution ----------------------------------------------------

    def _tier_of(self, req: Request) -> str:
        return self._uid_tier.get(req.uid) or req.tier or self.default_tier

    def _check_request(self, r: Request) -> None:
        super()._check_request(r)
        name = r.tier or self.default_tier
        if name not in self.tiers:
            raise ValueError(f"request uid={r.uid}: unknown tier {name!r} "
                             f"(engine tiers: {sorted(self.tiers)})")

    def _slot_cache(self, slot: int):
        return self._caches[self.tiers[self._slot_tier[slot]].kv_fmt]

    # -- tier-routed dispatches ---------------------------------------------

    def _admit_dispatch(self, slot: int, req: Request) -> int:
        name = self._tier_of(req)
        self._slot_tier[slot] = name
        spec = self.tiers[name]
        tokens = torch.as_tensor(np.asarray(req.tokens)[None],
                                 dtype=torch.int64).to(self.device)
        logits, _ = prefill_into_slot(
            self.cfg, self._wparams[spec.weight_fmt], {"tokens": tokens},
            self._caches[spec.kv_fmt], slot, self.max_len, spec.kv_fmt,
            act_fmt=spec.act_fmt)
        return self._first_token(slot, req, logits)

    def _start_prefill(self, sched: SlotScheduler, slot: int, req: Request,
                       now: float) -> Dict[str, Any]:
        self._slot_tier[slot] = self._tier_of(req)
        return super()._start_prefill(sched, slot, req, now)

    def _restore_dispatch(self, slot: int, snap) -> None:
        """A snapshot goes back into the arena of its request's tier (its
        degraded tier after a repack); the slot takes that tier."""
        self._slot_tier[slot] = self._tier_of(snap.req)
        super()._restore_dispatch(slot, snap)

    def _lane_route(self, slot: int):
        spec = self.tiers[self._slot_tier[slot]]
        return ((spec.weight_fmt, spec.kv_fmt, spec.act_fmt),
                self._wparams[spec.weight_fmt], self._caches[spec.kv_fmt],
                spec.kv_fmt, spec.act_fmt)

    def _group_chunk_fn(self, greedy: bool, weight_fmt, kv_fmt,
                        steps: Optional[int] = None):
        cfg, params, cache = self.cfg, self._wparams[weight_fmt], \
            self._caches[kv_fmt]
        n, gens, buf = steps or self.chunk, self._gens, self._buf
        return lambda: continuous_chunk(cfg, params, kv_fmt, n, greedy, gens,
                                        buf, cache)

    def _dispatch_chunk(self, poison: np.ndarray):
        """One decode dispatch per (weight_fmt, kv_fmt) group among the
        live slots, each over the full batch with the other slots done and
        not live and poisoned only where the group's rows are; only the
        group's rows fold back into the host state (``finite`` included),
        and ``pos`` (which the riders keep) into the group's arena. A
        sampled dispatch draws from every slot's generator: the others'
        are put back after it. A single-tier engine makes exactly the
        plain engine's one dispatch. Returns (emitted, finite)."""
        t0 = time.perf_counter()
        h = self._host
        emitted_all = np.zeros((self.n_slots, self.chunk), np.int32)
        finite_all = np.ones((self.n_slots,), bool)
        groups: Dict[Any, List[int]] = {}
        for s in np.nonzero(h["live"])[0]:
            spec = self.tiers[self._slot_tier[int(s)]]
            groups.setdefault((spec.weight_fmt, spec.kv_fmt),
                              []).append(int(s))
        for wf, kvf in sorted(groups, key=repr):
            mask = np.zeros((self.n_slots,), bool)
            mask[groups[(wf, kvf)]] = True
            greedy = bool((np.where(mask, h["temp"], 0.0) == 0.0).all())
            self._upload(dict(h, done=h["done"] | ~mask,
                              live=h["live"] & mask, poison=poison & mask))
            kept = [] if greedy else [(g, g.get_state()) for g, m in
                                      zip(self._gens, mask) if not m]
            outs = self._run_chunk(
                (wf, kvf, greedy),
                lambda steps=None: self._group_chunk_fn(greedy, wf, kvf,
                                                        steps), greedy,
                self._caches[kvf])
            for g, state in kept:
                g.set_state(state)
            got = self._fold(outs, self._caches[kvf], mask)
            emitted_all[mask] = got[mask, :-1]
            finite_all[mask] = got[mask, -1] != 0
        self.chunks += 1
        self.chunk_groups.append(len(groups))
        self.chunk_times.append((int(h["live"].sum()),
                                 time.perf_counter() - t0))
        return emitted_all, finite_all

    # -- the degraded-KV rung -----------------------------------------------

    def _make_sched(self) -> SlotScheduler:
        self._uid_tier.clear()      # tier overrides are per serve
        self.chunk_groups = []
        self.repacks = 0
        sched = super()._make_sched()
        sched.pool_monitor = self._kv_occupancy
        return sched

    def _kv_occupancy(self) -> float:
        """The share of the KV budget the decoding slots hold, each slot's
        rows priced at its own tier (budget: every slot full at the
        dearest tier)."""
        sched, rows = self._sched, self._row_cap
        if sched is None or rows is None or not self._max_row_bytes:
            return 0.0
        used = 0
        for slot, req in sched.active.items():
            if sched.phase.get(slot) != DECODING:
                continue
            pos = len(req.tokens) + int(self._host["n_gen"][slot])
            kvf = self.tiers[self._slot_tier[slot]].kv_fmt
            used += min(pos, rows) * self._row_bytes[kvf]
        return used / (self.n_slots * rows * self._max_row_bytes)

    def _lifecycle(self, sched, state, results, clock) -> None:
        super()._lifecycle(sched, state, results, clock)
        self._degrade_sweep(sched, state)

    def _degrade_sweep(self, sched: SlotScheduler,
                       state: Dict[int, Any]) -> None:
        """At or over the watermark: repack the resident slots of dearer
        tiers into ``degrade_kv_to``, oldest first, until the occupancy is
        under it or no such slot is left."""
        wm = getattr(self.shedding, "pool_watermark", None)
        if self.degrade_kv_to is None or wm is None:
            return
        dst = self.degrade_kv_to
        dst_cost = self._row_bytes[self.tiers[dst].kv_fmt]
        while self._kv_occupancy() >= wm:
            cands = [(state[s]["admit_time"], s)
                     for s in sched.active
                     if sched.phase.get(s) == DECODING and s in state
                     and self._slot_tier[s] != dst
                     and self._row_bytes[
                         self.tiers[self._slot_tier[s]].kv_fmt] > dst_cost]
            if not cands:
                return
            self._repack_slot(sched, min(cands)[1], dst)

    def _repack_slot(self, sched: SlotScheduler, slot: int,
                     dst_name: str) -> None:
        """Move a decoding slot to ``dst_name`` at a chunk boundary: its
        K/V rows re-encoded into the destination arena, its Mamba state
        moved as it is, the source arena's slot parked, the tier flipped;
        it decodes on under the cheap tier from the next chunk."""
        src_name = self._slot_tier[slot]
        src = self.tiers[src_name].kv_fmt
        dst = self.tiers[dst_name].kv_fmt
        req = sched.active[slot]
        pos = 0
        if src != dst:
            solo = read_cache_slot(self._caches[src], slot)   # a copy
            pos = int(solo["pos"][0])
            for layer in solo["layers"]:     # nothing stale is encoded
                for name, buf in layer.items():
                    if name in _ROW_LEAVES:
                        buf[:, pos:].zero_()
            write_cache_slot(self._caches[dst],
                             repack_kv(self.cfg, solo, src, dst), slot)
            reset_slot(self.cfg, self._caches[src], slot)
        self._slot_tier[slot] = dst_name
        self._uid_tier[req.uid] = dst_name
        sched.degraded.setdefault(req.uid, (None, False))
        self.repacks += 1
        self._emit("kv-repack", uid=req.uid, slot=slot, src=src_name,
                   dst=dst_name, pos=pos,
                   occupancy=round(self._kv_occupancy(), 4))
