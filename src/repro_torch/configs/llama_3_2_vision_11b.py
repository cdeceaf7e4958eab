"""llama-3.2-vision-11b — decoder w/ gated cross-attention image layers
every 5th layer; vision frontend is a STUB (precomputed patch embeddings
via input_specs) [hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, qkv_bias=False,
    rope_theta=500_000.0, mlp_type="swiglu",
    cross_attn_every=5, vision_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = replace(
    CONFIG, name="llama-vision-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    cross_attn_every=2, vision_tokens=16,
)
