"""Prefill and serve steps, and the input shapes of each (arch × shape) cell.

Port of ``repro/models/steps.py`` for inference.  ``make_prefill_step``
returns ``(model, batch) -> metrics`` (the forward-only loss at prefill
shape) and ``make_serve_step`` returns ``(model, state, batch) ->
(logits, state)``; both run under ``torch.inference_mode``.
``input_specs`` gives the shape and dtype of every model input of a
cell.  The train step waits for ROADMAP A13b.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from . import lm
from .common import Dtype

__all__ = ["TensorSpec", "input_specs", "supports_shape", "make_prefill_step",
           "make_serve_step"]


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def supports_shape(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: which (arch × shape) cells are defined."""
    if shape.name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN §5)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, TensorSpec]:
    """Shape and dtype of every model input of this cell."""
    dt = Dtype(cfg.dtype).param
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = dict(tokens=TensorSpec((b, s), torch.int32), labels=TensorSpec((b, s), torch.int32))
        if cfg.family == "vlm":
            out["vision"] = TensorSpec((b, cfg.vision_tokens, cfg.d_model), dt)
        if cfg.is_encdec:
            out["frames"] = TensorSpec((b, cfg.encoder_frames, cfg.d_model), dt)
        return out
    # decode: one new token against a seq_len-deep cache
    out = dict(tokens=TensorSpec((b,), torch.int32))
    if cfg.family == "vlm":
        out["vision"] = TensorSpec((b, cfg.vision_tokens, cfg.d_model), dt)
    if cfg.is_encdec:
        out["memory"] = TensorSpec((b, cfg.encoder_frames, cfg.d_model), dt)
    return out


def make_prefill_step(cfg: ArchConfig, *, use_kernel=False):
    """Forward-only loss eval at prefill shape (inference-prefill cell)."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        _, metrics = lm.forward_loss(cfg, model, batch, use_kernel=use_kernel)
        return metrics

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    @torch.inference_mode()
    def serve_step(model, state, batch):
        return lm.decode_step(cfg, model, state, batch["tokens"])

    return serve_step
