"""DeepSeek-67B [arXiv:2401.02954; dense llama-arch GQA].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400. At nxfp4 its
projections take ~38 GB; its f32 weights (~268 GB) do not fit one 80 GB
card, so the port builds and casts it a layer at a time
(``models.lm.init_params(policy=)``) and serves it at full size.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=256,
)
