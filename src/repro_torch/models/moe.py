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

Without a mesh the dispatch modes behave as the reference's do without
one: ``"ep"`` rounds the capacity up to a multiple of 256 once it exceeds
256; ``"grouped"`` has one group, ``"manual"`` falls back to ``"auto"``,
and ``"tokens_dp"`` and ``"auto_ep"`` only change the reference's
sharding constraints or rules, so all four compute what ``"auto"`` does.
Every expert's product runs on its whole capacity buffer, empty rows
included, as in the reference.

On a mesh (the model sharded by ``models.steps.shard_model``, the mesh's
data ranks handed down by the sharded steps as ``dp``, a
``models.common.DataRanks``) each mode computes what the reference's
computes under its mesh:

* **Experts over ``model``.**  Every ``model`` rank routes the same
  tokens with the whole router (gathered) and runs its local shards of
  the expert stacks, as their DTensor placements say.  Split on E (the
  EP-only rules of the grouped, manual and auto_ep dispatches: ``E/M``
  experts a rank) each slot maps to the rank's own rows (expert ``e``
  lies on rank ``e // (E/M)``, every other slot goes to the sentinel);
  split on the hidden f (the reference's default rules, whose generic
  ``w_gate``/``w_up``/``w_down`` patterns come before its ``/moe/`` one)
  every rank runs every expert on its ``f/M``.  Either way the gather
  goes through the zero sentinel row and one all-reduce over ``model``
  sums the ranks' partial outputs.
* **``"auto"``, ``"ep"``, ``"tokens_dp"``, ``"auto_ep"``** route over the
  global batch: where the batch is split over the data ranks
  (``dp.split``) the capacity comes from the global
  token count, each slot's position is its place in the global k-major
  order (:func:`global_slots`), and the load-balance and z-loss terms are
  formed from means over the global batch (all-reduced; their backward
  sums the ranks' gradients, so that FSDP's mean over the ranks gives the
  global term's gradient).
* **``"manual"``** (the reference's ``_manual_moe``): each data rank routes
  its own ``t/D`` tokens alone, capacity from them; the load-balance and
  z-loss terms are each rank's, averaged over the data ranks.  Where the
  batch is whole on every rank (it does not divide), rank r routes the
  r-th of D consecutive slices of the flattened tokens and the slices'
  outputs are gathered.  It falls back to ``"auto"`` where the
  reference's returns None: one data rank, ``E % M != 0`` or
  ``t % D != 0``.
* **``"grouped"``** (the reference's ``_grouped_moe``): ``D`` routing
  groups (one where ``t % D``), each a consecutive slice of the flattened
  tokens with its own capacity and positions; the two terms come from
  global means.  A batch split over the data ranks gives each rank its
  group; a whole batch gives every rank all D groups (:func:`slots`).

The routing, the scatter, the products and the gather are plain torch
(``sort``, ``cumsum``, ``index_add``, ``bmm``, indexing): the reference
computes them with XLA einsums and ``.at[].add``, not a Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .common import DataRanks, dense_init, replicated, swiglu, tp_out

__all__ = ["MoE", "moe_ffn", "route", "capacity", "slots", "global_slots", "DISPATCH_MODES"]

DISPATCH_MODES = ("auto", "ep", "grouped", "manual", "tokens_dp", "auto_ep")


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


def slots(idx: torch.Tensor, n_experts: int, cap: int, groups: int = 1):
    """idx (T, K) → (keep, slot), both (K*T,) in k-major slot order, the T
    tokens cut into ``groups`` consecutive slices, each counted alone (one
    group: the reference's ``moe_ffn``; more: its ``_grouped_moe``).  A
    slot's position inside its expert is the count of earlier slots of its
    group, in the group's k-major order, bound for the same expert; one at
    a position ≥ ``cap`` is dropped (``keep`` False) and sent to the
    sentinel row ``E·G·cap``.  ``slot = e·G·cap + g·cap + position``, so
    that each expert's rows stay consecutive.

    The one-hot counts lie expert-major, ``(E, G, K*T/G)``, so that the
    count runs along the contiguous axis: a scan along the outer axis of
    ``(K*T, E)`` keeps one thread per expert and took 64 % of a 2 × 4096
    prefill's device time on the card."""
    t, k = idx.shape
    tg = t // groups
    by_group = idx.T.reshape(k, groups, tg).transpose(0, 1).reshape(groups, k * tg)  # (G, K·Tg)
    experts = torch.arange(n_experts, device=idx.device)
    onehot = (experts[:, None, None] == by_group[None]).to(torch.int32)           # (E, G, K·Tg)
    pos = onehot.cumsum(2, dtype=torch.int32) - onehot
    my_pos = pos.gather(0, by_group[None])[0]                                     # (G, K·Tg)
    group = torch.arange(groups, device=idx.device)[:, None]
    slot = by_group * (groups * cap) + group * cap + my_pos
    keep = my_pos < cap
    slot = torch.where(keep, slot, n_experts * groups * cap)
    back = lambda a: a.reshape(groups, k, tg).transpose(0, 1).reshape(-1)  # noqa: E731
    return back(keep), back(slot)


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


class _GatherOver(torch.autograd.Function):
    """This rank's slice, concatenated on dim 0 with every rank's of
    ``group`` (in rank order); the gradient of the slice is the sum of the
    ranks' gradients of its rows, as for :class:`_SumOver`."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.n
        return grad[lo:lo + ctx.n], None


def _local_experts(moe: MoE):
    """(first expert, expert count, the ``model`` ranks, the expert stacks'
    local tensors, the DTensor mesh and dims over which the ranks' outputs
    are partial sums, or None) of this rank.  Stacks split on E over a
    mesh dim (the EP-only rules) give each rank its consecutive ``E/M``
    experts; split on the hidden f (the reference's default rules:
    ``w_gate``/``w_up`` on their last dim, ``w_down`` on its middle one)
    every expert's SwiGLU on ``f/M``; either way the outputs are summed
    over those dims."""
    e = moe.router.shape[1]
    w = moe.w_gate
    stacks = [t.to_local() if isinstance(t, DTensor) else t
              for t in (moe.w_gate, moe.w_up, moe.w_down)]
    if not isinstance(w, DTensor):
        return 0, e, 1, stacks, None
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    m = mesh.size(names.index("model")) if "model" in names else 1
    dims = [i for i, pl in enumerate(w.placements) if isinstance(pl, Shard) and mesh.size(i) > 1]
    lo, n = 0, e
    for i in dims:
        if w.placements[i].dim == 0:
            n = e // mesh.size(i)
            lo = mesh.get_local_rank(i) * n
    return lo, n, m, stacks, ((mesh, dims) if dims else None)


def _aux(logits, probs, idx, e: int, group=None, n: int = 0):
    """The Switch load-balance term and the router z-loss over this rank's
    tokens, or, with ``group``, over the ``n`` tokens of every rank of it
    (sums all-reduced; their backward sums the ranks' gradients)."""
    if group is None:
        frac_tokens = F.one_hot(idx[:, 0], e).float().mean(0)
        lb = e * torch.sum(frac_tokens * probs.mean(0))
        return lb, torch.mean(torch.logsumexp(logits, -1) ** 2)
    frac_tokens = F.one_hot(idx[:, 0], e).float().sum(0)
    dist.all_reduce(frac_tokens, group=group)
    frac_probs = _SumOver.apply(probs.sum(0), group)
    lb = e * torch.sum((frac_tokens / n) * (frac_probs / n))
    return lb, _SumOver.apply((torch.logsumexp(logits, -1) ** 2).sum(), group) / n


def moe_ffn(moe: MoE, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            dispatch_sharding: str = "auto", dp: DataRanks | None = None):
    """x (B, S, d) → (y (B, S, d), dict(load_balance, z_loss)).  ``dp``:
    the data ranks of the mesh the model is sharded over, as the sharded
    steps hand them down (``models.steps.data_ranks``); ``x`` is this
    rank's slice of a batch split over ``dp.group`` (in the batch's order)
    where ``dp.split``, else the whole batch.  On a mesh ``x`` is the same
    on every ``model`` rank, and so is ``y``."""
    if dispatch_sharding not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch_sharding {dispatch_sharding!r}; "
                         f"expected one of {DISPATCH_MODES}")
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e = moe.router.shape[1]
    lo, n_local, m, stacks, combine = _local_experts(moe)
    group = dp.group if dp is not None and dp.split else None   # the batch is split over it
    n = t * (dist.get_world_size(group) if group is not None else 1)   # the global tokens
    mode, groups, gather, ranks = dispatch_sharding, 1, None, 1
    if mode in ("manual", "grouped"):
        ranks = dist.get_world_size(dp.group) if dp is not None else 1
        if ranks == 1 or (mode == "manual" and (e % m or n % ranks)):
            mode = "auto"        # one data rank, or where the reference's _manual_moe gives None
        elif group is None and n % ranks == 0:
            if mode == "manual":                   # rank r routes the r-th slice of the tokens
                tl, r = t // ranks, dist.get_rank(dp.group)
                xf, gather = xf[r * tl:(r + 1) * tl], dp.group
            else:                                  # every rank forms all the groups
                groups = ranks
    tokens = xf.shape[0]
    logits, probs, gates, idx = route(xf, replicated(moe.router), top_k)
    if mode in ("manual", "grouped"):              # this rank's tokens, or all the groups
        cap = capacity(tokens // groups, top_k, e, capacity_factor)
        keep, slot = slots(idx, e, cap, groups)
    else:
        cap = capacity(n, top_k, e, capacity_factor, mode)
        keep, slot = slots(idx, e, cap) if group is None else global_slots(idx, e, cap, group)

    rows = n_local * groups * cap                  # this rank's experts' rows of the buffer
    if n_local < e:                                # other ranks' slots go to the sentinel
        first = lo * groups * cap
        mine = keep & (slot >= first) & (slot < first + rows)
        slot = torch.where(mine, slot - first, rows)
    xk = xf.repeat(top_k, 1)                                    # (K*T, d)
    buf = xf.new_zeros((rows + 1, d)).index_add(0, slot, xk)
    buf = buf[:-1].reshape(n_local, groups * cap, d)
    w_gate, w_up, w_down = stacks
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    y = torch.bmm(F.silu(g) * u, w_down)

    yf = torch.cat([y.reshape(rows, d), y.new_zeros((1, d))])   # sentinel row
    w = (gates.T.reshape(-1) * keep).to(x.dtype)                # (K*T,)
    out = (yf[slot] * w[:, None]).reshape(top_k, tokens, d).sum(0)
    if combine is not None:                        # one all-reduce over the expert ranks
        mesh, dims = combine
        placements = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
        out = tp_out(DTensor.from_local(out, mesh, placements, run_check=False))

    # Switch load-balance term and router z-loss
    if mode == "manual":                           # each rank's terms, averaged over the ranks
        lb, z = (_SumOver.apply(v, dp.group) / ranks for v in _aux(logits, probs, idx, e))
        if gather is not None:
            out = _GatherOver.apply(out, gather)
    elif group is not None:                        # means over the global batch
        lb, z = _aux(logits, probs, idx, e, group, n)
    else:
        lb, z = _aux(logits, probs, idx, e)
    if moe.shared:
        out = out + swiglu(x.reshape(t, d), moe.sh_gate, moe.sh_up, moe.sh_down)
    return out.reshape(b, s, d), dict(load_balance=lb, z_loss=z)
