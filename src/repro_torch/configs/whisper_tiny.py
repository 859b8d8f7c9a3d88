"""Whisper-tiny [arXiv:2212.04356; audio enc-dec].

4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865. The conv frontend
is a stub: the caller passes precomputed frame embeddings (B,
n_audio_frames, d_model) as the batch's ``frames``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, n_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, n_audio_frames=64,
)
