"""The dense (Llama-style GQA), MoE, SSM (Mamba-1), hybrid, vision
(cross attention to patch embeddings) and audio (encoder-decoder)
families on torch: served, and trained (``forward_train``, ``loss_fn``)."""
from .common import ModelConfig
from .lm import (commit_verify, decode_loop, decode_step, draft_loop,
                 forward_train, init_cache, init_lane, init_paged_cache,
                 init_params, loss_fn, prefill, prefill_chunk,
                 prefill_into_slot, read_cache_slot, recurrent_state,
                 reset_slot, verify_step, write_cache_slot)

__all__ = ["ModelConfig", "init_params", "forward_train", "loss_fn",
           "prefill", "decode_step",
           "decode_loop", "init_cache", "init_lane", "init_paged_cache",
           "prefill_chunk",
           "prefill_into_slot", "read_cache_slot", "recurrent_state",
           "reset_slot", "write_cache_slot", "draft_loop", "verify_step",
           "commit_verify"]
