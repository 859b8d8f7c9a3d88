"""A slot's device state as a host payload (the reference's
``serving/snapshot.py``, its slot-state helpers only).

A slot's restartable state is its K/V rows ``[0, pos)`` in whatever
format the engine serves (packed bytes stay packed: no dequantize round
trip) and ``pos``. ``pack_device_state`` copies a batch-1 cache slice
(``models.read_cache_slot``) to the host, its K/V leaves trimmed to the
rows written; ``unpack_device_state`` pads them back with zeros to the
slot's capacity, so that ``write_cache_slot`` takes it (suspension, A10,
will use the round trip; the degrade rung re-encodes on the device). The
port's cache is a list of per-layer dicts whose K/V buffers are (B, S,
...): the row axis is 1 (the reference's stacked layers put it at 2).
``SlotSnapshot`` and checkpoints come with suspension.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.kvcache import _KV_LEAVES

__all__ = ["pack_device_state", "unpack_device_state", "slot_row_capacity"]

_ROW_LEAVES = frozenset(_KV_LEAVES)  # leaves with a sequence-row axis (1)


def slot_row_capacity(cache: Dict[str, Any]) -> Optional[int]:
    """Row capacity (``max_len``) of the cache's K/V leaves; None for a
    cache without attention K/V."""
    for layer in cache.get("layers") or ():
        for name in _ROW_LEAVES:
            if name in layer:
                return int(layer[name].shape[1])
    return None


def pack_device_state(solo: Dict[str, Any], used_rows: int) -> Dict[str, Any]:
    """Host copy of a batch-1 cache slice: K/V leaves keep rows
    ``[0, used_rows)``, everything else (``pos``) is copied whole. Bytes
    are copied verbatim: packed codes and meta never pass through a
    dequantize."""
    return {"pos": solo["pos"].to("cpu", copy=True),
            "layers": [{name: (leaf[:, :used_rows] if name in _ROW_LEAVES
                               else leaf).to("cpu", copy=True)
                        for name, leaf in layer.items()}
                       for layer in solo["layers"]]}


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
