"""H2O-Danube3-4B [arXiv:2401.16818; dense llama+mistral mix with SWA].

24L d_model=3840 32H (GQA kv=8, head_dim 120) d_ff=10240 vocab=32000,
sliding window 4096: the KV cache is a window-sized ring (row pos % 4096),
so decode costs the window and not the context.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    sliding_window=4096, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, sliding_window=32,
)
