"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, qkv_bias=False,
    rope_theta=10_000.0, mlp_type="swiglu",
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    source="arXiv:2401.06066",
)

SMOKE = replace(
    CONFIG, name="deepseek-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, moe_d_ff=64, vocab=256, n_experts=8, top_k=2, n_shared_experts=1,
)
