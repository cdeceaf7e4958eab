"""int8 gradient compression with error feedback (a smaller DP all-reduce).

Port of ``repro/optim/compress.py``.  Per-tensor symmetric quantisation:
g ≈ scale · q with q in int8.  The quantisation error is fed back into the
next step's gradient (error feedback keeps SGD converging).
``compressed_psum`` is the collective for a data-parallel loop over a
``torch.distributed`` process group: quantise, all-reduce, dequantise; on
the wire that is 8 bits and one float32 scale a tensor, a quarter of
float32's bytes.  As in the reference, each rank quantises with its own
scale, so the sum is taken over the dequantised float32 values (what an
int8 all-reduce with per-rank scales comes to); the all-reduce here moves
those float32 values.  Rounding is half to even in both packages
(``torch.round``, ``jnp.round``), so ``compress_int8`` gives the
reference's bits.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

__all__ = ["compress_int8", "decompress_int8", "compressed_psum", "error_feedback_init"]


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g (float32 or bf16) → (int8 q, 0-d float32 scale)."""
    g = g.float()
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_init(params):
    """float32 zeros shaped like each of ``params`` (a mapping or a
    sequence of tensors)."""
    if isinstance(params, Mapping):
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def compressed_psum(grads, residuals, group=None):
    """Quantise each gradient plus its residual, all-reduce the dequantised
    values over ``group`` (default: the whole world) and divide by its
    size.  ``grads`` and ``residuals`` are mappings with the same keys or
    sequences of the same length.  Returns (mean gradients, new
    residuals) in the same form."""
    n = dist.get_world_size(group)

    def one(g, r):
        g = g.float() + r
        q, scale = compress_int8(g)
        approx = decompress_int8(q, scale)
        new_r = g - approx        # error feedback: what quantisation lost
        dist.all_reduce(approx, group=group)
        return approx / n, new_r

    if isinstance(grads, Mapping):
        outs = {k: one(g, residuals[k]) for k, g in grads.items()}
        return {k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()}
    outs = [one(g, r) for g, r in zip(grads, residuals)]
    return [o[0] for o in outs], [o[1] for o in outs]
