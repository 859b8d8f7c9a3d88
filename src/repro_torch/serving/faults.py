"""Seeded fault injection for the continuous serving engines (the
reference's ``serving/faults.py``; the port keeps its own copy).

A ``FaultPlan`` is a declarative, seed-deterministic schedule of faults
that ``ContinuousEngine.serve(fault_plan=)`` consults at chunk boundaries.
With no plan (or a spent one) the serve runs the same graphs on the same
inputs: the ``poison`` buffer stays all False, and ``torch.where`` on an
all-False mask returns the logits bit for bit. The kinds:

- ``nan_logits``: the victim slot's logits become NaN inside the next
  decode chunk (the ``poison`` static buffer, written before the replay).
  Exercises the finite-logits sentinel.
- ``kv_flip``: XOR random bytes of the victim slot's packed K/V rows
  already written (rows ``[0, pos)``), in place on the device buffers.
  Exercises the K/V canary (``kv_integrity=True``); needs a packed KV
  format.
- ``delay``: a host sleep at a chunk boundary (a slow shard, a GC pause).
- ``burst``: rewrites arrival times into ``[t0, t0 + span)``, order kept;
  applied once at ``serve()`` entry.
- ``shard_down``: drains a shard of a sharded engine; an unsharded engine
  refuses it loudly (``ContinuousEngine.drain_shard`` raises).

Faults are one-shot: each fires at the first chunk boundary ``>= chunk``
at which its victim is decoding (a fault aimed at a queued request waits
for its admission). Every draw comes from ``default_rng([seed, i])``, so
the same plan on the same workload corrupts the same bytes every run, and
the same bytes as the reference's plan on the reference's cache.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Fault", "FaultPlan", "flip_kv_bytes", "KINDS"]

KINDS = ("nan_logits", "kv_flip", "delay", "burst", "shard_down")

# the packed K/V leaves a flip may hit, in the reference's draw order
_FLIP_LEAVES = ("k_packed", "v_packed", "k_meta", "v_meta")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind:    one of ``KINDS``.
    chunk:   earliest chunk boundary (0-based, counted per ``serve()``)
             at which the fault may fire.
    uid:     victim request uid for nan_logits / kv_flip.
    shard:   victim shard for shard_down; a tag for delay faults.
    seconds: sleep length for delay faults.
    n_bytes: number of packed K/V bytes to corrupt for kv_flip.
    t0/span: burst window for arrival-time rewrites.
    """
    kind: str
    chunk: int = 0
    uid: Optional[int] = None
    shard: Optional[int] = None
    seconds: float = 0.0
    n_bytes: int = 1
    t0: float = 0.0
    span: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind in ("nan_logits", "kv_flip") and self.uid is None:
            raise ValueError(f"{self.kind} fault needs a victim uid")
        if self.kind == "shard_down" and self.shard is None:
            raise ValueError("shard_down fault needs a victim shard")


@dataclasses.dataclass
class FaultPlan:
    """A seeded schedule of ``Fault``s plus one-shot firing state."""
    faults: Sequence[Fault] = ()
    seed: int = 0

    def __post_init__(self):
        self._fired: set = set()

    def reset(self) -> None:
        """Re-arm every fault (called at ``serve()`` entry)."""
        self._fired.clear()

    def pending(self, kind: str, chunk_idx: int) -> List[Tuple[int, Fault]]:
        """Unfired faults of ``kind`` whose chunk boundary has arrived."""
        return [(i, f) for i, f in enumerate(self.faults)
                if f.kind == kind and i not in self._fired
                and f.chunk <= chunk_idx]

    def fire(self, i: int) -> None:
        self._fired.add(i)

    def rng(self, i: int) -> np.random.Generator:
        """Per-fault generator: deterministic in (plan seed, fault index)."""
        return np.random.default_rng([self.seed, i])

    def apply_arrivals(self, requests):
        """Apply burst faults: re-time arrivals into ``[t0, t0 + span)``,
        their order kept (requests are re-timed, not reordered). Burst
        faults fire here, once, at ``serve()`` entry."""
        reqs = list(requests)
        for i, f in self.pending("burst", chunk_idx=10**9):
            self.fire(i)
            order = sorted(range(len(reqs)),
                           key=lambda j: (reqs[j].arrival_time, j))
            offs = np.sort(self.rng(i).uniform(0.0, max(f.span, 0.0),
                                               size=len(reqs)))
            for rank, j in enumerate(order):
                reqs[j] = dataclasses.replace(
                    reqs[j], arrival_time=f.t0 + float(offs[rank]))
        return reqs


def flip_kv_bytes(cache, slot: int, n_rows: int, rng, n_bytes: int = 1):
    """XOR ``n_bytes`` random bytes of slot ``slot``'s packed K/V rows
    ``[0, n_rows)`` (rows the cache has committed), in place.

    The draws are the reference's, in its order: a leaf name, a row, an
    index over the leaf's shape stacked over the layers (L, B, S, KVH, NB,
    bpb; a meta leaf's u16 as its two bytes, (..., NB, 2)), then the XOR
    byte; the index's first entry picks the layer of the port's per-layer
    cache. So the same plan flips the same bytes in both packages. The
    buffers are edited through a byte view, never replaced: a captured
    decode graph reads their storage, so the next replay sees the flip.
    Dense, SSM-only and paged caches have no packed per-slot leaves and
    raise. Returns ``cache``."""
    layers = cache.get("layers") or []
    names = [n for n in _FLIP_LEAVES if any(n in lc for lc in layers)]
    if not names:
        raise ValueError("kv_flip needs a packed KV cache "
                         "(kv_format with packed k/v leaves)")
    if n_rows <= 0:
        return cache
    for _ in range(n_bytes):
        name = names[int(rng.integers(len(names)))]
        holders = [lc[name] for lc in layers if name in lc]
        buf = holders[0]
        shape = (len(holders),) + tuple(buf.shape)
        if buf.dtype == torch.uint16:   # meta: one byte of the u16
            shape = shape + (2,)
        row = int(rng.integers(min(n_rows, shape[2])))
        idx = tuple(int(rng.integers(d)) for d in shape)
        layer, tail = holders[idx[0]], idx[3:]
        byte = int(rng.integers(1, 256))
        if layer.dtype == torch.uint16:    # (..., NB) -> (..., NB * 2)
            tail = tail[:-2] + (2 * tail[-2] + tail[-1],)
        layer.view(torch.uint8)[(slot, row) + tail] ^= byte
    return cache
