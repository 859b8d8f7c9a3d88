"""Llama-3-405B [arXiv:2407.21783; dense GQA].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256. Its weights
do not fit one 80 GB card, even at nxfp4; the port serves its smoke
config and takes the full config for shapes and parameter counts.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=384, vocab=256,
)
