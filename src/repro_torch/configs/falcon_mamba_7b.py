"""Falcon-Mamba-7B [arXiv:2410.05355; ssm, mamba-1, attention-free].

64L d_model=4096 d_inner=8192 ssm_state=16 conv_width=4 vocab=65024.
No KV cache: a slot's serving state is its recurrent state (``h`` and the
conv tail), constant in the context length.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm_state=16, d_inner=8192, conv_width=4,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256,
    ssm_state=8, d_inner=128, conv_width=4, ssm_chunk=16,
)
