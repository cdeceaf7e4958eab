"""whisper-base — encoder-decoder; conv audio frontend is a STUB
(precomputed frame embeddings via input_specs) [arXiv:2212.04356;
unverified]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, qkv_bias=True,
    mlp_type="gelu",
    encoder_layers=6, encoder_frames=1500,
    source="arXiv:2212.04356",
)

SMOKE = replace(
    CONFIG, name="whisper-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    encoder_layers=2, encoder_frames=32,
)
