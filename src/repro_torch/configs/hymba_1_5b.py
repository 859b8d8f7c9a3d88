"""Hymba-1.5B [arXiv:2411.13676; hybrid parallel attn+mamba heads].

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 ssm_state=16
vocab=32001. Every layer runs windowed attention (a 1024-row ring cache)
and a Mamba head in parallel and averages them: the Mamba path carries
the context past the window.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    ssm_state=16, d_inner=3200, sliding_window=1024,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    ssm_state=8, d_inner=128, sliding_window=32, ssm_chunk=16,
)
