"""hymba-1.5b — hybrid: parallel attention + Mamba heads per layer
[arXiv:2411.13676; hf].  Attention is sliding-window (long_500k-capable);
the SSM branch carries the global context (ssm_state=16)."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, qkv_bias=False,
    rope_theta=10_000.0, mlp_type="swiglu",
    ssm_state=16, attn_window=1024,
    source="arXiv:2411.13676",
)

SMOKE = replace(
    CONFIG, name="hymba-1.5b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    ssm_state=8, attn_window=32,
)
