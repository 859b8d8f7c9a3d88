"""Serving: the batched engine over direct-cast weights and KV cache."""
from .engine import GenerationResult, ServeEngine, mask_chunk_emissions

__all__ = ["ServeEngine", "GenerationResult", "mask_chunk_emissions"]
