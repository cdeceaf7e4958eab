"""AdamW and momentum SGD on a dict of parameter tensors.

Port of ``repro/optim/adamw.py``.  Parameters are a mapping name →
tensor (``dict(model.named_parameters())``; an ``nn.Module`` is taken as
its named parameters), and the state mirrors it by name.  Moments are
float32 whatever the parameter dtype (bf16 parameters, float32
optimizer state), as in the reference; ``torch.optim.AdamW`` would keep
bf16 moments for bf16 parameters and does not clip.

The update is the reference's arithmetic in float32, cast back to each
parameter's dtype, but written in place under ``torch.no_grad()``: the
parameters and the moments are updated where they lie, one parameter at
a time, so the float32 temporaries never exceed one parameter's size.
The step count stays on the parameters' device, so an update waits for
nothing on the host.  Returns the reference's tuple, holding the same
(updated) dicts.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

__all__ = ["adamw_init", "adamw_update", "sgdm_init", "sgdm_update"]


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _zeros(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _count(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params) -> dict:
    params = _named(params)
    return dict(mu=_zeros(params), nu=_zeros(params), count=_count(params))


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, torch.Tensor], state: dict, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step with global-norm clipping.  Returns
    ``(params, state, gnorm)``: ``params`` and ``state`` updated in place,
    ``gnorm`` the float32 global norm of ``grads`` before clipping (a 0-d
    tensor on the parameters' device)."""
    params = _named(params)
    count = state["count"] + 1
    gnorm = torch.stack([torch.linalg.vector_norm(grads[k], dtype=torch.float32)
                         for k in params]).square().sum().sqrt()
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    c = count.float()
    bc1 = 1 - torch.full_like(c, b1) ** c
    bc2 = 1 - torch.full_like(c, b2) ** c
    for k, p in params.items():
        g = grads[k].float() * scale
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
        p32 = p.float()
        step.add_(p32, alpha=weight_decay)
        p.copy_(p32 - lr * step)
    state["count"] = count
    return params, state, gnorm


def sgdm_init(params) -> dict:
    params = _named(params)
    return dict(mom=_zeros(params), count=_count(params))


@torch.no_grad()
def sgdm_update(params, grads: Mapping[str, torch.Tensor], state: dict, *, lr: float,
                momentum: float = 0.9, weight_decay: float = 0.0):
    """One momentum-SGD step.  Returns ``(params, state)``, both updated
    in place."""
    params = _named(params)
    for k, p in params.items():
        p32 = p.float()
        g = grads[k].float() + weight_decay * p32
        m = state["mom"][k]
        m.mul_(momentum).add_(g)
        p.copy_(p32 - lr * m)
    state["count"] = state["count"] + 1
    return params, state
