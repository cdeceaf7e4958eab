"""Common neural building blocks, as plain functions on tensors.

Port of ``repro/models/common.py``.  The cast order of each function is
the reference's: normalisations compute in float32 and cast back to the
input dtype before the weight multiplies; rotary tables come from
float32 numpy frequencies; ``apply_rope`` rotates the two halves of the
head (not interleaved pairs).

Under tensor parallelism a weight is a ``DTensor`` over the mesh's
``model`` dim (``models.steps.shard_model``) while the activations
between blocks stay plain tensors, the same on every ``model`` rank.
:func:`tp_in` enters a block (its backward all-reduces the input's
gradient), :func:`tp_out` leaves it (all-reduces a partial sum), and
:func:`replicated` gives the whole of a weight that the block needs
whole (a norm's scale).  On plain tensors the three do nothing.
:class:`DataRanks` is what a sharded step hands its layers of the
mesh's data ranks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

__all__ = [
    "rms_norm", "layer_norm", "rope", "apply_rope", "dense_init", "swiglu", "gelu_mlp",
    "Dtype", "DTYPES", "tp_in", "tp_out", "replicated", "DataRanks",
]

#: config dtype names → torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class DataRanks(NamedTuple):
    """The data ranks of the mesh a model is sharded over, as a sharded
    step hands them to the layers that read them (``models.steps.
    data_ranks``): ``group``, the process group of the ranks the batch in
    hand is split over, in the batch's order, where ``split``; else of
    every ``pod`` × ``data`` rank, each of which holds the whole batch."""

    group: object
    split: bool


def tp_in(x: torch.Tensor, like) -> torch.Tensor:
    """``x`` (the same on every ``model`` rank) as a replicated DTensor on
    ``like``'s mesh when ``like`` is a DTensor, else ``x``.  The backward
    sums the ranks' partial input gradients."""
    if not isinstance(like, DTensor):
        return x
    return DTensor.from_local(x, like.device_mesh, [Replicate()], run_check=False)


def tp_out(y: torch.Tensor) -> torch.Tensor:
    """A DTensor block output (a partial sum or a shard) as the plain
    tensor of its whole value; a plain tensor as it is."""
    if not isinstance(y, DTensor):
        return y
    return y.redistribute(y.device_mesh, [Replicate()] * y.device_mesh.ndim).to_local()


def replicated(w: torch.Tensor) -> torch.Tensor:
    """The whole of weight ``w`` as a plain tensor (gathered when ``w`` is
    a sharded DTensor); its gradient is taken to be the same on every
    rank, as it is for a weight applied to the replicated activations."""
    return tp_out(w)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    w = replicated(w)
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    w, b = replicated(w), replicated(b)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def rope(positions: torch.Tensor, d_head: int, theta: float):
    """Rotary tables (cos, sin) for ``positions``: float32, (..., d_head/2)."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (S, D/2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(shape, dtype: torch.dtype, *, generator: torch.Generator | None = None,
               device=None, scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale²) in float32, cast to ``dtype``; scale defaults to
    fan_in^-½ with fan_in = shape[0].  Drawn from ``generator`` on its
    device (a different stream of numbers than ``jax.random``)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    x = tp_in(x, w_gate)
    return tp_out((F.silu(x @ w_gate) * (x @ w_up)) @ w_down)


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    # jax.nn.gelu defaults to the tanh approximation
    x = tp_in(x, w_up)
    return tp_out(F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down) + replicated(b_down)


class Dtype:
    """Compute/param dtype policy."""

    def __init__(self, name: str):
        self.param = DTYPES[name]
        self.compute = self.param
        self.accum = torch.float32
