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

Sharded parameters (DTensors, ``models.steps.shard_model``) get moments
with their placements, as the reference's moments carry the parameters'
shardings; the update runs on each rank's local shards, and the clipping
norm is the whole gradient's: each rank's sum of squares, divided by the
number of ranks that hold the same values, summed over the mesh.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = ["adamw_init", "adamw_update", "sgdm_init", "sgdm_update", "global_norm"]


def _named(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _zeros(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """float32 zeros like each parameter (a DTensor with its placements)."""
    return {k: torch.zeros_like(p, dtype=torch.float32, requires_grad=False).detach()
            for k, p in params.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads) -> torch.Tensor:
    """The float32 norm of all of ``grads`` (a 0-d tensor).  For DTensors,
    each rank adds its shards' squares divided by how many ranks hold the
    same shard, then the sums are reduced over each mesh."""
    grads = list(grads)
    if not any(isinstance(g, DTensor) for g in grads):
        return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                            for g in grads]).square().sum().sqrt()
    by_mesh: dict = {}
    for g in grads:
        mesh = g.device_mesh if isinstance(g, DTensor) else None
        copies = 1
        if mesh is not None:
            for i, pl in enumerate(g.placements):
                copies *= mesh.size(i) if pl.is_replicate() else 1
        sq = torch.linalg.vector_norm(_local(g), dtype=torch.float32).square() / copies
        by_mesh[mesh] = by_mesh.get(mesh, 0) + sq
    total = 0
    for mesh, sq in by_mesh.items():
        if mesh is not None:
            for i in range(mesh.ndim):
                dist.all_reduce(sq, group=mesh.get_group(i))
        total = total + sq
    return total.sqrt()


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
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    c = count.float()
    bc1 = 1 - torch.full_like(c, b1) ** c
    bc2 = 1 - torch.full_like(c, b2) ** c
    for k, p in params.items():
        p, g = _local(p), _local(grads[k])
        g = g.float() * scale
        mu, nu = _local(state["mu"][k]), _local(state["nu"][k])
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
