"""Phi-3.5-MoE-instruct (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct; moe].

32L d_model=4096 32H (GQA kv=8) d_ff=6400, vocab=32064, 16 experts top-2.
41.9B parameters: ~168 GB in f32, ~24 GB at nxfp4; the port builds it at
full size a layer at a time (``models.lm.init_params(policy=)``).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064,
    n_experts=16, n_experts_active=2,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    n_experts=4, n_experts_active=2,
)
