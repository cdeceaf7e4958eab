"""Train, prefill and serve steps, and the input shapes of each (arch ×
shape) cell.

Port of ``repro/models/steps.py``.  ``make_train_step`` returns
``(model, opt_state, batch, step) -> (opt_state, metrics)``: loss →
gradients → AdamW, the model's parameters and ``opt_state`` updated in
place (the reference's jitted step returns new trees instead; there is no
jit or donation to port).  ``make_prefill_step`` returns ``(model, batch)
-> metrics`` (the forward-only loss at prefill shape) and
``make_serve_step`` returns ``(model, state, batch) -> (logits, state)``;
both run under ``torch.inference_mode``.  ``input_specs`` gives the shape
and dtype of every model input of a cell.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..optim import adamw_update, cosine_schedule
from . import lm
from .common import Dtype

__all__ = ["TensorSpec", "input_specs", "supports_shape", "make_train_step",
           "make_prefill_step", "make_serve_step"]


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


def _on(model: lm.LM, batch) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(model.device) for k, v in batch.items()}


def _grads(loss, params: dict) -> tuple:
    """d loss / d each of ``params``; zeros for a parameter the loss does not
    reach (the ssm family's branch a layer does not run), as ``jax.grad``
    gives through ``lax.cond``, so that AdamW still decays it."""
    return torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                               materialize_grads=True)


def make_train_step(cfg: ArchConfig, *, base_lr=3e-4, total_steps=10_000, warmup_steps=200,
                    use_kernel=False, grad_compress=False, microbatch: int = 0):
    """``(model, opt_state, batch, step) -> (opt_state, metrics)``: one AdamW
    step on the mean NLL of ``batch`` (tokens, labels (B,S), and ``vision``
    or ``frames`` for the vlm and audio families; tensors or numpy),
    learning rate ``cosine_schedule(base_lr, warmup_steps,
    total_steps)(step)``.  ``metrics`` holds ``loss``, ``nll`` and
    ``grad_norm`` (0-d tensors on the model's device) and ``lr``.

    With ``microbatch > 1`` the batch is cut into that many consecutive
    slices (the reference's reshape), their gradients summed in float32
    and divided by their count, as the reference's scan does.
    ``use_kernel`` runs the attention through the hand-written
    ``flash_attention`` forward and backward where the reference's guard
    allows (``use_pallas``).  A parameter the loss does not reach gets a
    zero gradient."""
    if grad_compress:
        raise NotImplementedError(
            "grad_compress (int8 compressed_psum over a data-parallel mesh) is not ported "
            "yet (ROADMAP A13b, second half)")
    sched = cosine_schedule(base_lr, warmup_steps, total_steps)

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        batch = _on(model, batch)
        if microbatch and microbatch > 1:
            b = batch["tokens"].shape[0]
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of microbatch {microbatch}")
            m = b // microbatch
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatch):
                loss, _ = lm.forward_loss(cfg, model, {k: v[i * m:(i + 1) * m]
                                                       for k, v in batch.items()},
                                          use_kernel=use_kernel)
                for acc, g in zip(grads.values(), _grads(loss, params)):
                    acc.add_(g)
                lsum += loss.detach()
            for acc in grads.values():
                acc.div_(microbatch)
            loss = lsum / microbatch
            metrics = dict(loss=loss, nll=loss)
        else:
            loss, metrics = lm.forward_loss(cfg, model, batch, use_kernel=use_kernel)
            grads = dict(zip(params, _grads(loss, params)))
            metrics = {k: v.detach() for k, v in metrics.items()}
        lr = sched(step)
        _, opt_state, gnorm = adamw_update(params, grads, opt_state, lr=lr)
        return opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(cfg: ArchConfig, *, use_kernel=False):
    """Forward-only loss eval at prefill shape (inference-prefill cell)."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        _, metrics = lm.forward_loss(cfg, model, batch, use_kernel=use_kernel)
        return metrics

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``(model, state, batch) -> (logits, state)``: one decode step of
    ``batch["tokens"]``, with ``batch["vision"]`` (vlm) or
    ``batch["memory"]`` (audio: the encoder's output) where present."""

    @torch.inference_mode()
    def serve_step(model, state, batch):
        return lm.decode_step(cfg, model, state, batch["tokens"], memory=batch.get("memory"),
                              vision=batch.get("vision"))

    return serve_step
