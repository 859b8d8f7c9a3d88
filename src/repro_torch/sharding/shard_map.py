"""The port's counterpart of the reference's ``sharding/shard_map.py``.

The reference runs the gradient wire inside a partial-auto ``shard_map``:
manual over 'pod', the other axes left to GSPMD. Here every rank is a
process, and "manual over 'pod'" is the mesh's process group over that
axis (``launch.mesh.Mesh.group("pod")``): the wire's collectives run on
it, and the rest of the step sees the rank's own rows. The reference's
backend gate (an XLA CPU partitioner abort on any partial-auto
``shard_map``) has no torch counterpart; what gates the wire here is
whether its process group's backend can gather.
"""
from __future__ import annotations

# process-group backends the packed gradient wire runs on: gloo (CPU and
# CUDA tensors; a CUDA tensor is staged through the host) and NCCL (a card
# per rank)
SHARD_MAP_WIRE_BACKENDS = ("gloo", "nccl")


def partial_auto_ok(mesh) -> bool:
    """Can the packed wire run over ``mesh``'s 'pod' group?"""
    return mesh.backend in SHARD_MAP_WIRE_BACKENDS


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh (None -> None): its axis names, their
    sizes and its devices in order (a serving mesh's ``torch.device``s, a
    process mesh's ranks). The reference keys its compiled programs with
    it; the port's engines keep their CUDA graphs per shard, so here it
    names the mesh an engine serves on
    (``ShardedContinuousEngine.mesh_key``)."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names),
            tuple(str(d) for d in mesh.devices))
