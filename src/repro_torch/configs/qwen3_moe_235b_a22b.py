"""qwen3-moe-235b-a22b — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, qkv_bias=False, head_dim=128,
    rope_theta=1_000_000.0, mlp_type="swiglu",
    n_experts=128, top_k=8, moe_d_ff=1536,
    source="hf:Qwen/Qwen3-30B-A3B family scaled per assignment",
)

SMOKE = replace(
    CONFIG, name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, moe_d_ff=64, vocab=256, n_experts=8, top_k=2,
)
