"""Mixture-of-Experts FFN with capacity-based sort-free dispatch.

Port of ``repro/models/moe.py`` as it computes on one device.  Top-k
routing with a static per-expert capacity ``C = round(T·K/E · cf)``
(Python's ``round``, half to even): each (token, k) slot takes its
position within its expert from a cumulative count over the k-major slot
order and is scattered into an ``(E·C + 1, d)`` buffer whose last row is
the sentinel of dropped slots; the experts' SwiGLU runs as batched
products over the whole buffer; results gather back through a zero
sentinel row, weighted by the renormalised gates.  Overflowing slots drop
(the residual stream carries them).  The Switch load-balance term and the
router z-loss come back for the train step.

The dispatch modes behave as the reference's do without a mesh:
``"ep"`` rounds the capacity up to a multiple of 256 once it exceeds 256;
``"grouped"`` has one group, ``"manual"`` falls back to ``"auto"`` and
``"tokens_dp"`` only adds a sharding constraint, so all three compute
what ``"auto"`` does.  Every expert's product runs on its whole capacity
buffer, empty rows included, as in the reference.

On a mesh whose batch is split over the data ranks (``group``, passed
down from the sharded steps) each rank routes its own tokens and
computes what the reference's global path computes under ``jit`` over
the whole batch (:func:`global_slots`): the capacity from the global
token count, each slot's position in the global k-major order, and the
load-balance and z-loss terms from means over the global batch
(all-reduced; their backward sums the ranks' gradients, so that FSDP's
mean over the ranks gives the global term's gradient).

The routing, the scatter, the products and the gather are plain torch
(``sort``, ``cumsum``, ``index_add``, ``bmm``, indexing): the reference
computes them with XLA einsums and ``.at[].add``, not a Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .common import dense_init, swiglu

__all__ = ["MoE", "moe_ffn", "route", "capacity", "slots", "global_slots", "DISPATCH_MODES"]

DISPATCH_MODES = ("auto", "ep", "grouped", "manual", "tokens_dp")


class MoE(nn.Module):
    """The reference's ``init_moe`` tree: ``router (d, E)`` in float32
    whatever ``dtype``; ``w_gate``, ``w_up (E, d, f)`` and ``w_down (E, f,
    d)``; with shared experts ``sh_gate``, ``sh_up (d, f·n_shared)`` and
    ``sh_down (f·n_shared, d)``.  Each is drawn as ``dense_init`` draws
    (scale ``shape[0]^-½``, so the expert stacks' scale is ``E^-½``, as
    the reference's)."""

    def __init__(self, d_model: int, n_experts: int, moe_d_ff: int, n_shared: int, dtype,
                 *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d, e, f = d_model, n_experts, moe_d_ff
        self.router = nn.Parameter(dense_init((d, e), torch.float32, **kw))
        self.w_gate = nn.Parameter(dense_init((e, d, f), dtype, **kw))
        self.w_up = nn.Parameter(dense_init((e, d, f), dtype, **kw))
        self.w_down = nn.Parameter(dense_init((e, f, d), dtype, **kw))
        self.shared = bool(n_shared)
        if self.shared:
            fs = f * n_shared
            self.sh_gate = nn.Parameter(dense_init((d, fs), dtype, **kw))
            self.sh_up = nn.Parameter(dense_init((d, fs), dtype, **kw))
            self.sh_down = nn.Parameter(dense_init((fs, d), dtype, **kw))


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int):
    """xf (T, d) → (logits, probs (T, E) float32, gates (T, K)
    renormalised, idx (T, K)).  A stable descending sort puts the lower
    expert first among equal probabilities, as ``jax.lax.top_k`` does."""
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], order[:, :top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gates, idx


def capacity(t: int, top_k: int, n_experts: int, capacity_factor: float,
             dispatch_sharding: str = "auto") -> int:
    """Slots per expert for T tokens: ``max(1, round(T·K/E·cf))`` with
    Python's half-to-even ``round``; ``"ep"`` rounds a capacity above 256
    up to a multiple of 256."""
    cap = int(max(1, round(t * top_k / n_experts * capacity_factor)))
    if dispatch_sharding == "ep" and cap > 256:
        cap = ((cap + 255) // 256) * 256
    return cap


def slots(idx: torch.Tensor, n_experts: int, cap: int):
    """idx (T, K) → (keep, slot), both (K*T,) in k-major slot order: a
    slot's position inside its expert is the count of earlier slots bound
    for the same expert; one at a position ≥ ``cap`` is dropped
    (``keep`` False) and sent to the sentinel row ``E·cap``.

    The one-hot counts lie expert-major, ``(E, K*T)``, so that the count
    runs along the contiguous axis: a scan along the outer axis of ``(K*T,
    E)`` keeps one thread per expert and took 64 % of a 2 × 4096 prefill's
    device time on the card."""
    flat_e = idx.T.reshape(-1)
    experts = torch.arange(n_experts, device=idx.device)
    onehot = (experts[:, None] == flat_e[None, :]).to(torch.int32)
    pos = onehot.cumsum(1, dtype=torch.int32) - onehot
    my_pos = pos.gather(0, flat_e[None, :])[0]
    keep = my_pos < cap
    return keep, torch.where(keep, flat_e * cap + my_pos, n_experts * cap)


def global_slots(idx: torch.Tensor, n_experts: int, cap: int, group):
    """:func:`slots` of this rank's tokens in the global batch's order.

    The reference counts down ``idx.T.reshape(-1)`` of the whole batch:
    slot j = k·T + t, the global token t = r·T_r + t_r for rank r's t_r-th
    token (the data ranks hold consecutive slices of the batch).  A slot
    (k, r, t_r) bound for expert e therefore comes after every slot of
    every rank for the choices k' < k, then the slots of choice k on the
    ranks before r, then this rank's earlier tokens of choice k.  The
    first two counts come from each rank's (E, K) counts, all-gathered
    over ``group``."""
    t, k = idx.shape
    flat_e = idx.T.reshape(-1)
    experts = torch.arange(n_experts, device=idx.device)
    onehot = (experts[:, None] == flat_e[None, :]).to(torch.int32).reshape(n_experts, k, t)
    within = (onehot.cumsum(2, dtype=torch.int32) - onehot).reshape(n_experts, k * t)
    counts = onehot.sum(2, dtype=torch.int64)                   # (E, K) this rank's
    every = [torch.empty_like(counts) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, counts, group=group)
    every = torch.stack(every)                                  # (R, E, K)
    total = every.sum(0)
    offset = total.cumsum(1) - total + every[:dist.get_rank(group)].sum(0)
    choice = torch.arange(k, device=idx.device).repeat_interleave(t)
    my_pos = within.gather(0, flat_e[None, :])[0] + offset[flat_e, choice]
    keep = my_pos < cap
    return keep, torch.where(keep, flat_e * cap + my_pos, n_experts * cap)


class _SumOver(torch.autograd.Function):
    """The sum of a tensor over ``group``'s ranks; its gradient on each rank
    is the sum of the ranks' gradients of the result."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def moe_ffn(moe: MoE, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            dispatch_sharding: str = "auto", group=None):
    """x (B, S, d) → (y (B, S, d), dict(load_balance, z_loss)).  ``x`` is
    this rank's slice of a batch split over ``group`` (the data ranks, in
    the batch's order) when one is given, else the whole batch."""
    if dispatch_sharding not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch_sharding {dispatch_sharding!r}; "
                         f"expected one of {DISPATCH_MODES}")
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e = moe.router.shape[1]
    logits, probs, gates, idx = route(xf, moe.router, top_k)
    n = t * (dist.get_world_size(group) if group is not None else 1)   # the global tokens
    cap = capacity(n, top_k, e, capacity_factor, dispatch_sharding)

    keep, slot = slots(idx, e, cap) if group is None else global_slots(idx, e, cap, group)
    xk = xf.repeat(top_k, 1)                                    # (K*T, d)
    buf = xf.new_zeros((e * cap + 1, d)).index_add(0, slot, xk)
    buf = buf[:-1].reshape(e, cap, d)
    g = torch.bmm(buf, moe.w_gate)
    u = torch.bmm(buf, moe.w_up)
    y = torch.bmm(F.silu(g) * u, moe.w_down)

    yf = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])  # sentinel row
    w = (gates.T.reshape(-1) * keep).to(x.dtype)                # (K*T,)
    out = (yf[slot] * w[:, None]).reshape(top_k, t, d).sum(0)
    if moe.shared:
        out = out + swiglu(xf, moe.sh_gate, moe.sh_up, moe.sh_down)

    # Switch load-balance term and router z-loss
    if group is None:
        frac_tokens = F.one_hot(idx[:, 0], e).float().mean(0)
        lb = e * torch.sum(frac_tokens * probs.mean(0))
        z = torch.mean(torch.logsumexp(logits, -1) ** 2)
        return out.reshape(b, s, d), dict(load_balance=lb, z_loss=z)
    frac_tokens = F.one_hot(idx[:, 0], e).float().sum(0)
    dist.all_reduce(frac_tokens, group=group)
    frac_probs = _SumOver.apply(probs.sum(0), group)
    lb = e * torch.sum((frac_tokens / n) * (frac_probs / n))
    z = _SumOver.apply((torch.logsumexp(logits, -1) ** 2).sum(), group) / n
    return out.reshape(b, s, d), dict(load_balance=lb, z_loss=z)
