"""Llama-2-7B — one of the paper's own evaluation models (Table 1)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000,
)

SMOKE = ModelConfig(
    name="llama2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
)
