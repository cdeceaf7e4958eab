"""Architecture configuration schema + registry.

One module per assigned architecture lives next to this file; each
exposes ``CONFIG`` (the exact published configuration) and ``SMOKE``
(a reduced same-family configuration for CPU smoke tests).  The
registry maps public ids (``--arch qwen2.5-32b``) to both.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace

__all__ = ["ArchConfig", "register", "get_config", "get_smoke", "list_archs",
           "SHAPES", "shape_for"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    qkv_bias: bool = False
    head_dim: int | None = None          # default d_model // n_heads
    rope_theta: float = 1_000_000.0
    attn_window: int = 0                 # sliding-window size; 0 = full attn
    mlp_type: str = "swiglu"             # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # per-(routed/shared)-expert hidden
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 0                 # xLSTM: every k-th block is sLSTM
    # VLM
    cross_attn_every: int = 0            # every k-th layer gets cross-attn
    vision_tokens: int = 0
    # audio (enc-dec)
    encoder_layers: int = 0
    encoder_frames: int = 0
    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    attn_impl: str = "full"              # full | chunked (online-softmax)
    loss_chunk: int = 512                # sequence chunk for the CE loss
    moe_dispatch_sharding: str = "auto"  # auto | ep (explicit (tp,dp) buffer)
    mamba_impl: str = "scan"             # scan | assoc (associative scan)
    remat_policy: str = "full"           # full | save_attn (selective recompute)
    attn_probs_dtype: str = ""           # "" | bfloat16 (score-chain dtype)
    mlstm_impl: str = "scan"             # scan | chunked (chunkwise parallel)
    mlstm_chunk: int = 64
    source: str = ""                     # provenance note

    @property
    def d_head(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, dh = self.d_model, self.d_head
        qkv = d * dh * (self.n_heads + 2 * self.n_kv_heads) + dh * self.n_heads * d
        if self.qkv_bias:
            qkv += dh * (self.n_heads + 2 * self.n_kv_heads)
        if self.family == "ssm":
            per_layer = 8 * d * d  # mLSTM q,k,v,o + gates approx
        else:
            if self.mlp_type == "swiglu":
                ffn = 3 * d * self.d_ff
            else:
                ffn = 2 * d * self.d_ff
            if self.n_experts:
                ffn = (
                    3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
                    + d * self.n_experts
                )
            per_layer = qkv + ffn + 2 * d
            if self.family == "hybrid":
                per_layer += 6 * d * d // 2  # mamba branch approx
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
            per_layer += 2 * d * d + dh * 0  # decoder cross-attn kv+o approx
        return self.n_layers * per_layer + emb + enc

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        expert_p = 3 * self.d_model * self.moe_d_ff
        inactive = (self.n_experts - self.top_k) * expert_p * self.n_layers
        return full - inactive


# ---------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSpec:
    return SHAPES[name]


# -------------------------------------------------------------- registry
_REGISTRY: dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "granite-3-8b": "granite_3_8b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-base": "whisper_base",
}


def register(arch_id: str, module: str) -> None:
    _REGISTRY[arch_id] = module


def _load(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _load(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _load(arch_id).SMOKE


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
