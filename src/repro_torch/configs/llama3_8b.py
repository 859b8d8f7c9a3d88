"""Llama-3-8B — the paper's main illustrative model (Table 1, Figs 8-12)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
)
