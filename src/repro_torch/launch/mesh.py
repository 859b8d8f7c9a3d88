"""The slot-sharded serving engines' mesh (the reference's
``launch/mesh.py:make_serving_mesh``).

The reference builds a one-axis ``('data',)`` JAX mesh and runs every
slot shard inside one ``shard_map``'d program. Its sharded serving has no
collective (weights replicated, every slot write made by the shard that
owns the slot), so here a mesh is no more than the devices of one
process, one per shard, in shard order; ``serving/sharded.py`` runs one
host loop over them. Process groups come with the packed gradient wire,
the first code that needs a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import resolve_device

__all__ = ["ServingMesh", "make_serving_mesh"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """Devices over named axes, as a JAX mesh shows them to the sharded
    engines: ``devices`` (one ``torch.device`` a mesh position, in order;
    one may repeat), ``axis_names`` and ``shape`` (axis name -> size)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    shape: Dict[str, int] = dataclasses.field(default_factory=dict)


def _on_card(device) -> torch.device:
    """``device`` resolved (raising without CUDA), a bare ``cuda`` pinned
    to the current card so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_serving_mesh(n_shards: int,
                      devices: Optional[Sequence] = None) -> ServingMesh:
    """A one-axis ``('data',)`` mesh of ``n_shards`` devices: the first
    ``n_shards`` CUDA devices, or ``devices`` when given. An explicit list
    may repeat a device (``["cpu"] * 2`` on the CPU, ``["cuda:0"] * 2`` on
    one card), as the reference forces host devices on the CPU. Raises
    without CUDA unless every device is the CPU, and when there are too
    few devices."""
    if n_shards < 1:
        raise ValueError(f"n_shards ({n_shards}) must be >= 1")
    if devices is None:
        resolve_device(None)
        have = torch.cuda.device_count()
        if have < n_shards:
            raise ValueError(f"need {n_shards} devices for {n_shards} "
                             f"shards, have {have} (pass devices= to "
                             "place several shards on one device)")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    elif len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    devs = tuple(_on_card(d) for d in devices)
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"one device type a mesh, got {devs}")
    return ServingMesh(devs, ("data",), {"data": n_shards})
