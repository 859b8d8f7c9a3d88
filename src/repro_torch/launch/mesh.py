"""Meshes (the reference's ``launch/mesh.py``).

``make_serving_mesh``: the slot-sharded serving engines' mesh. The
reference builds a one-axis ``('data',)`` JAX mesh and runs every slot
shard inside one ``shard_map``'d program. Its sharded serving has no
collective (weights replicated, every slot write made by the shard that
owns the slot), so here a serving mesh is no more than the devices of one
process, one per shard, in shard order; ``serving/sharded.py`` runs one
host loop over them.

``make_mesh`` / ``make_test_mesh``: a mesh of processes, one rank a mesh
position, for code with collectives (the packed gradient wire,
``train/compress.py``). The ranks form the default process group; a
``torch.distributed`` ``DeviceMesh`` of the mesh's shape and axis names
lies over it, row-major as ``jax.make_mesh`` lays out devices, and each
axis has its process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .. import resolve_device

__all__ = ["ServingMesh", "make_serving_mesh", "Mesh", "make_mesh",
           "make_test_mesh"]


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


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh of processes: ``axis_names`` and
    ``shape`` (axis name -> size) as the reference's mesh shows them,
    ``rank`` and its ``coord`` (axis name -> index), the ``device`` the
    rank computes on, the process-group ``backend``, ``device_mesh``
    (``torch.distributed.device_mesh.DeviceMesh``, what
    ``sharding.to_shardings``' placements are for) and ``devices`` (the
    ranks in mesh order, as the reference's mesh lists its devices)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coord: Dict[str, int]
    device: torch.device
    backend: str
    device_mesh: object
    _groups: Dict[tuple, object] = dataclasses.field(default_factory=dict)

    @property
    def devices(self) -> Tuple[int, ...]:
        return tuple(range(math.prod(self.shape.values())))

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank's mesh line over ``axes`` (an
        axis name, or several: the ranks that share every other
        coordinate). Every rank must ask for a group of several axes the
        first time together, as ``torch.distributed.new_group`` needs."""
        import torch.distributed as dist
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            ranks = torch.arange(len(self.devices)).reshape(
                tuple(self.shape[a] for a in self.axis_names))
            order = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in order]
            lines = ranks.permute(*rest, *order).reshape(-1, math.prod(
                self.shape[a] for a in axes))
            for line in lines.tolist():
                g = dist.new_group(line, backend=self.backend)
                if self.rank in line:
                    self._groups[axes] = g
        return self._groups[axes]

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()

    def close(self) -> None:
        """Leave the process group (``destroy_process_group``)."""
        import torch.distributed as dist
        dist.destroy_process_group()


def make_mesh(shape, axes, *, backend: str, device=None,
              devices: Optional[Sequence] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Join the default process group and lay a mesh of ``shape`` with axis
    names ``axes`` over its ranks (rank r at the r-th position of the
    row-major mesh).

    ``init_method`` (``tcp://localhost:<port>``, ``file://<path>``), with
    ``rank`` and ``world_size``, sets the group up explicitly; without it
    the launcher's environment is read (``torchrun``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). A group this
    process has already joined is taken as it is. The world size must be
    the mesh's size.

    ``backend`` names the process-group backend ("gloo" or "nccl"); it is
    never guessed. NCCL wants a card of its own for every rank; gloo
    gathers CPU tensors and, staged through the host, CUDA tensors, so
    several ranks may share one card (``devices=["cuda:0"] * n``).

    The rank computes on ``devices[rank]`` when ``devices`` is given, else
    on ``device``: CUDA unless the caller asks for the CPU (a bare
    ``cuda`` takes card ``LOCAL_RANK`` (else the rank) modulo the cards
    there are). Raises without CUDA unless the device is the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} for axes {axes}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if rank is None or world_size is None:
        if init_method is not None or "RANK" not in os.environ:
            raise ValueError("give init_method, rank and world_size, or run "
                             "under a launcher that sets RANK and "
                             "WORLD_SIZE (torchrun)")
        rank, world_size = int(os.environ["RANK"]), int(
            os.environ["WORLD_SIZE"])
    dev = resolve_device(device if devices is None else devices[rank])
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError(f"the nccl backend needs a card a rank, got {dev}")
    if math.prod(shape) != world_size:
        raise ValueError(f"a {shape} mesh for {world_size} ranks")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise ValueError(f"rank {rank} of {world_size} in a joined group of "
                         f"{dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the joined group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    dmesh = DeviceMesh(dev.type, torch.arange(world_size).reshape(shape),
                       mesh_dim_names=axes)
    coord = dict(zip(axes, (int(c) for c in torch.unravel_index(
        torch.tensor(rank), shape))))
    return Mesh(axes, dict(zip(axes, shape)), rank, coord, dev, backend,
                dmesh)


def make_test_mesh(data: int = 2, model: int = 4, **kw) -> Mesh:
    """A ('data', 'model') mesh (``make_mesh``'s keywords: ``backend``,
    ``device``, the group's address, rank and size)."""
    return make_mesh((data, model), ("data", "model"), **kw)
