"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; moe].

24L d_model=2048 16H (GQA kv=16) routed-expert d_ff=1408, vocab=151936,
60 routed experts top-4 + 4 shared experts (fused shared MLP 4x1408=5632).
14.3B parameters: ~57 GB in f32, ~9 GB at nxfp4; the port builds it at
full size a layer at a time (``models.lm.init_params(policy=)``).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, n_experts_active=4,
    n_shared_experts=4, shared_d_ff=5632,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=256,
    n_experts=8, n_experts_active=2,
    n_shared_experts=2, shared_d_ff=128,
)
