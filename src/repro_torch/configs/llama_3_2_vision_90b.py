"""Llama-3.2-Vision-90B backbone [hf:meta-llama/Llama-3.2-11B-Vision; vlm].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
is cross-attention to image patch embeddings. The vision tower is a stub:
the caller passes patch embeddings (B, n_vision_tokens, d_model) as the
batch's ``vision``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=500_000.0,
    cross_attn_every=5, n_vision_tokens=1601,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    cross_attn_every=2, n_vision_tokens=16,
)
