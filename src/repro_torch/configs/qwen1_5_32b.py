"""qwen1.5-32b — dense MHA-ish (kv=40) w/ QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, mlp_type="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B family scaled per assignment",
)

SMOKE = replace(
    CONFIG, name="qwen1.5-32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
)
