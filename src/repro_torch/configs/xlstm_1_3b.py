"""xlstm-1.3b — sLSTM + mLSTM blocks (d_ff=0: recurrent blocks carry the
MLP capacity) [arXiv:2405.04517; unverified]."""
from dataclasses import replace
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, qkv_bias=False,
    mlp_type="gelu", slstm_every=8,
    source="arXiv:2405.04517",
)

SMOKE = replace(
    CONFIG, name="xlstm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=256, slstm_every=2,
)
