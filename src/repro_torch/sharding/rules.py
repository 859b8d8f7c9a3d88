"""The slot-sharded serving layout (the reference's
``sharding/rules.py:slot_cache_specs`` and
``sharding/shard_map.py:mesh_fingerprint``)."""
from __future__ import annotations

from typing import Any, Dict


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh (None -> None): its axis names, their
    sizes and its devices in order. The reference keys its compiled
    programs with it; the port's engines keep their CUDA graphs per shard,
    so here it names the mesh an engine serves on
    (``ShardedContinuousEngine.mesh_key``)."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names),
            tuple(str(d) for d in mesh.devices))


def slot_cache_specs(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Which axis of each leaf of a slot cache the shards split: the
    cache's structure with an int a leaf. ``pos`` (B,) and every layer
    leaf of the port's layout (a list of per-layer dicts, no stacked
    layer axis) carry the slot axis first, so every entry is 0; a paged
    layer's pool leaves split their page axis (0) the same way, each
    shard holding a pool of its own. The reference's spec prefixes put
    the slot axis after its stacked layer axis (1; 2 for the vision
    family's self-attention stack, which the continuous engines do not
    serve)."""
    return {"pos": 0,
            "layers": [{name: 0 for name in layer}
                       for layer in cache["layers"]]}
