"""Slot snapshots: the resumable state of one live serving request (the
reference's ``serving/snapshot.py``).

A DECODING slot's restartable state is small and already compressed: its
K/V rows ``[0, pos)`` in whatever format the engine serves (packed bytes
stay packed: no dequantize round trip), its Mamba state (``h``, ``conv``)
where the family has one, ``pos``, and a few host scalars (next token,
the slot generator's state, sampling temperature, stop token, budget and
progress, the partial output). Suspension, preemption and checkpoints all
rest on it, and restoring it through ``write_cache_slot`` continues the
request's stream bit for bit.

``pack_device_state`` copies a batch-1 cache slice (``models.
read_cache_slot``, which gathers a paged slot into the dense layout) to
the host, its K/V leaves trimmed to the rows written: a sliding-window
ring ships ``min(pos, window)`` rows, every row once it has wrapped.
``unpack_device_state`` pads them back with zeros to the slot's capacity
(``slot_row_capacity``: the dense layout's rows, or a paged cache's table
width times its page size, so snapshots of either layout interchange).
The port's cache is a list of per-layer dicts whose K/V buffers are (B, S,
...): the row axis is 1 (the reference's stacked layers put it at 2).

``SlotSnapshot.key`` is the slot generator's ``get_state()`` (a CPU
``ByteTensor``): the port samples from a ``torch.Generator`` per slot
where the reference carries a PRNG key. ``take_owner_row`` picks one
shard's row out of a shard-stacked extract (the reference's sharded
engine reads a slot so; the port's reads it on its owner shard alone).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.kvcache import _KV_LEAVES, _POOL_PREFIX
from ..sharding import slot_cache_specs

__all__ = ["SlotSnapshot", "pack_device_state", "unpack_device_state",
           "slot_row_capacity", "save_checkpoint", "load_checkpoint",
           "take_owner_row"]

_ROW_LEAVES = frozenset(_KV_LEAVES)  # leaves with a sequence-row axis (1)


def slot_row_capacity(cache: Dict[str, Any]) -> Optional[int]:
    """Row capacity (the window or ``max_len``) of a slot's K/V: a paged
    cache's table width times its page size, the dense layout's row axis
    otherwise; None for a cache without attention K/V (pure SSM)."""
    for layer in cache.get("layers") or ():
        if "block" in layer:
            pool = next(v for n, v in layer.items()
                        if n.startswith(_POOL_PREFIX))
            return int(layer["block"].shape[1]) * int(pool.shape[1])
        for name in _ROW_LEAVES:
            if name in layer:
                return int(layer[name].shape[1])
    return None


def pack_device_state(solo: Dict[str, Any], used_rows: int) -> Dict[str, Any]:
    """Host copy of a batch-1 cache slice: K/V leaves keep rows
    ``[0, used_rows)``, everything else (``pos``, the Mamba state) is
    copied whole. Bytes are copied verbatim: packed codes and meta never
    pass through a dequantize."""
    return {"pos": solo["pos"].to("cpu", copy=True),
            "layers": [{name: (leaf[:, :used_rows] if name in _ROW_LEAVES
                               else leaf).to("cpu", copy=True)
                        for name, leaf in layer.items()}
                       for layer in solo["layers"]]}


def take_owner_row(stacked: Dict[str, Any], owner: int) -> Dict[str, Any]:
    """One shard's batch-1 slice out of a shard-stacked extract (every
    shard's slice of a slot stacked along the slot axis,
    ``sharding.slot_cache_specs``): the row ``owner`` of every leaf, as
    numpy arrays."""
    axes = slot_cache_specs(stacked)
    return {"pos": np.take(np.asarray(stacked["pos"]), [owner],
                           axis=axes["pos"]),
            "layers": [{name: np.take(np.asarray(leaf), [owner],
                                      axis=ax[name])
                        for name, leaf in layer.items()}
                       for layer, ax in zip(stacked["layers"],
                                            axes["layers"])]}


def unpack_device_state(dev: Dict[str, Any],
                        row_capacity: Optional[int]) -> Dict[str, Any]:
    """Zero-pad trimmed K/V rows back to ``row_capacity``: the padding lies
    past the slot's ``pos``, where attention reads nothing."""
    def pad(name, arr):
        if name not in _ROW_LEAVES or row_capacity is None or \
                arr.shape[1] >= row_capacity:
            return arr
        zeros = torch.zeros((arr.shape[0], row_capacity - arr.shape[1])
                            + tuple(arr.shape[2:]), dtype=arr.dtype,
                            device=arr.device)
        return torch.cat([arr, zeros], dim=1)

    return {"pos": dev["pos"],
            "layers": [{name: pad(name, arr) for name, arr in layer.items()}
                       for layer in dev["layers"]]}


@dataclasses.dataclass
class SlotSnapshot:
    """Everything needed to resume one in-flight request in any free slot
    of any engine with the same model and KV format.

    ``device`` is ``pack_device_state``'s host payload. ``queue_delay`` and
    ``ttft`` are the request's realized values (they happened before the
    suspension and survive a new serve's clock); ``decode_spent`` sums the
    occupied decode seconds before the suspension, so ``decode_tok_s``
    never charges the request for the time it spent parked. Snapshots are
    taken at chunk boundaries only, where every speculative round has
    committed: ``pos`` is always a committed position."""

    req: Any                   # the live Request (after any degrade)
    pos: int                   # rows written, or the ring pointer
    used_rows: int             # K/V rows shipped in ``device``
    device: Dict[str, Any]     # batch-1 host cache slice, rows trimmed
    tok: int                   # next input token (the last one emitted)
    key: torch.Tensor          # the slot generator's get_state() (CPU)
    n_gen: int                 # tokens emitted so far
    max_new: int               # the budget (after any degrade)
    temp: float
    stop: int
    out: List[int]             # partial output (host copy)
    queue_delay: float         # realized at first admission
    ttft: float                # realized at first token
    decode_spent: float        # occupied seconds before this suspension
    # the learned draft length (0: taken on an engine that is not
    # speculative; a speculative engine re-arms its default on resume)
    spec_k: int = 0

    @property
    def nbytes(self) -> int:
        """Bytes of the device payload: what a move or a checkpoint
        ships."""
        dev = self.device
        return int(dev["pos"].nbytes) + sum(
            int(leaf.nbytes) for layer in dev["layers"]
            for leaf in layer.values())


def save_checkpoint(path, ck: Dict[str, Any]) -> None:
    """Write an engine checkpoint atomically (write, then rename): a crash
    while writing leaves the previous checkpoint whole. ``torch.save``
    pickles the host structure and writes each tensor's bytes raw."""
    tmp = str(path) + ".tmp"
    torch.save(ck, tmp)
    os.replace(tmp, str(path))


def load_checkpoint(path) -> Dict[str, Any]:
    """Read a checkpoint ``save_checkpoint`` wrote (its requests and
    snapshots are Python objects, so this unpickles: load only checkpoints
    of your own)."""
    return torch.load(str(path), weights_only=False)
