"""starcoder2-7b — dense GQA w/ RoPE, GELU MLP [arXiv:2402.19173; hf]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, qkv_bias=True,
    rope_theta=1_000_000.0, mlp_type="gelu",
    source="arXiv:2402.19173",
)

SMOKE = replace(
    CONFIG, name="starcoder2-7b-smoke",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=144, vocab=256,
)
