"""Dense-family model (Llama-style GQA) on torch."""
from .common import ModelConfig
from .lm import (decode_loop, decode_step, init_cache, init_lane,
                 init_paged_cache, init_params, prefill, prefill_chunk,
                 prefill_into_slot, read_cache_slot, reset_slot,
                 write_cache_slot)

__all__ = ["ModelConfig", "init_params", "prefill", "decode_step",
           "decode_loop", "init_cache", "init_lane", "init_paged_cache",
           "prefill_chunk",
           "prefill_into_slot", "read_cache_slot", "reset_slot",
           "write_cache_slot"]
