"""What the slot-sharded serving engines need of the reference's
``sharding`` package: ``mesh_fingerprint`` and ``slot_cache_specs``
(``rules.py``). The rest (the parameter and activation rules, ``ctx.py``,
``shard_map_partial_auto``) waits for the packed gradient wire and the
dry run."""
from .rules import mesh_fingerprint, slot_cache_specs

__all__ = ["mesh_fingerprint", "slot_cache_specs"]
