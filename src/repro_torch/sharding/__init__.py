"""The reference's ``sharding`` package: the parameter, batch and cache
rules (``rules.py``), the activation context (``ctx.py``) and the wire's
backend list and mesh identity (``shard_map.py``)."""
from .ctx import activation_sharding, constrain_act
from .rules import (P, batch_specs, cache_specs, fit_spec, params_specs,
                    shard_friendly_config, slot_cache_specs, to_shardings)
from .shard_map import (SHARD_MAP_WIRE_BACKENDS, mesh_fingerprint,
                        partial_auto_ok)

__all__ = ["P", "params_specs", "cache_specs", "batch_specs", "fit_spec",
           "shard_friendly_config", "slot_cache_specs", "to_shardings",
           "activation_sharding", "constrain_act", "partial_auto_ok",
           "mesh_fingerprint", "SHARD_MAP_WIRE_BACKENDS"]
