"""Sharding rules: FSDP over ``data``, tensor parallelism over ``model``.

Port of ``repro/models/sharding.py``.  Mesh axes: ``("data", "model")``
on one pod, ``("pod", "data", "model")`` across pods.  Policy, as the
reference's:

* **Parameters**: tensor-parallel over ``model`` (attention heads, FFN
  hidden, MoE experts, vocab) and FSDP over ``data`` (the remaining large
  dim); replicated across ``pod``.
* **Batches**: split over (``pod``, ``data``), replicated over ``model``.
* **Decode caches**: batch over ``data`` when the batch divides, else the
  KV sequence dim (sequence-parallel decode).  :func:`decode_state_specs`
  gives each leaf of a decode state its spec, as the reference's dry run
  places decode states (``_decode_state_shardings``), and
  :func:`local_zeros` builds one rank's shard of a leaf without the whole.

A spec is a tuple with one entry a tensor dim: ``None``, a mesh axis
name, or a tuple of axis names (the reference's ``PartitionSpec``, whose
entries it compares equal to).  The rules are pure functions of shapes:
:class:`MeshCtx` takes a ``DeviceMesh`` or, for the dry run, only the
axes' sizes.  :func:`to_placements` turns a spec into the
``Shard``/``Replicate`` placements of each mesh dim, which is how the
sharded step (``models.steps.shard_model``) places each parameter.

The port's parameters are per layer (``layers.<i>.attn.wq``) where the
reference stacks them (``layers/attn/wq`` with a leading ``L``, the vlm's
``layers`` with ``(n_groups, g)``).  :func:`param_specs` applies the rule
to the reference's stacked path and shape and drops the stack dims, so a
port spec is the reference's without its leading stack entries: the
fallback rule (largest dim over ``tp``, the next over ``fsdp``) sees the
stack dims as the reference's does.
"""
from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np

__all__ = [
    "MeshCtx", "logical_spec", "spec_for_param", "param_specs", "batch_spec", "cache_spec",
    "to_placements", "constrain", "place", "reference_path", "EP_ONLY_EXPERT_RULES",
    "decode_state_specs", "local_extent", "local_zeros",
]


class MeshCtx:
    """The mesh axes the rules read: a ``DeviceMesh`` (its
    ``mesh_dim_names`` and sizes) or a mapping axis name → size."""

    def __init__(self, mesh):
        if isinstance(mesh, Mapping):
            self.mesh = None
            self.shape = dict(mesh)
        else:
            self.mesh = mesh
            self.shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        names = tuple(self.shape)
        self.axis_names = names
        self.tp = "model" if "model" in names else None
        self.fsdp = tuple(a for a in ("data",) if a in names)
        self.dp = tuple(a for a in ("pod", "data") if a in names)

    def size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return int(self.shape[axis])


def _logical_to_axis(ctx: MeshCtx, name):
    if name is None:
        return None
    if name == "dp":
        return ctx.dp if len(ctx.dp) > 1 else (ctx.dp[0] if ctx.dp else None)
    if name == "fsdp":
        return ctx.fsdp if len(ctx.fsdp) > 1 else (ctx.fsdp[0] if ctx.fsdp else None)
    if name == "tp":
        return ctx.tp
    if name == "dp+tp":
        return tuple(a for a in (*ctx.dp, ctx.tp) if a)
    raise ValueError(name)


def _fits(ctx: MeshCtx, dim: int, axis) -> bool:
    return axis is not None and dim % ctx.size(axis) == 0


def logical_spec(ctx: MeshCtx, shape, logical) -> tuple:
    """Map logical axis names to mesh axes, dropping non-divisible ones."""
    out = []
    for dim, name in zip(shape, logical):
        ax = _logical_to_axis(ctx, name)
        out.append(ax if _fits(ctx, dim, ax) else None)
    return tuple(out)


# (regex on the reference's flattened path, logical spec of the trailing
# dims).  Paths look like "layers/attn/wq", "encoder/layers/mlp/w_up",
# "embed"; leading stack dims (layer / group) are unsharded.  A rule of
# None falls through to the fallback, as in the reference.
_RULES: list[tuple[str, tuple | None]] = [
    (r"(^|/)embed$", ("tp", "fsdp")),              # (V, d)
    (r"(^|/)lm_head$", ("fsdp", "tp")),            # (d, V)
    (r"(^|/)pos_embed$", (None, "fsdp")),          # (S, d)
    (r"/(wq|wk|wv|w_gate|w_up|wz|in_proj|x_proj|ogate|wo_gate|sh_gate|sh_up)$",
     ("fsdp", "tp")),                              # (d, h)
    (r"/(wo|w_down|out_proj|dt_proj|sh_down)$", ("tp", "fsdp")),  # (h, d)
    (r"/router$", ("fsdp", "tp")),                 # (d, E)
    (r"/moe/(w_gate|w_up|w_down)$", ("tp", "fsdp", None)),  # (E, d, f) EP
    (r"/(bq|bk|bv|b_up|ln.*|.*norm.*|gate|dt_bias|d_skip|bf|bi)$", None),
    (r"/(conv_w|a_log)$", None),
    (r"/(wi|wf)$", (None, None)),
    (r"/rz$", (None, None, None)),
]

EP_ONLY_EXPERT_RULES = [
    # grouped MoE: expert weights are EP-sharded only (E over model),
    # replicated across data, so the expert products need no collective
    (r"/moe/(w_gate|w_up|w_down)$", ("tp", None, None)),
]


def spec_for_param(ctx: MeshCtx, path: str, shape, extra_rules=None) -> tuple:
    """The spec of one leaf at the reference's ``path`` and ``shape``."""
    logical = None
    for pat, rule in list(extra_rules or []) + _RULES:
        if re.search(pat, path):
            logical = rule
            break
    if logical is None:
        # fallback: shard the largest divisible dim over tp, next over fsdp
        if len(shape) == 0:
            return ()
        order = np.argsort(shape)[::-1]
        axes = [None] * len(shape)
        for cand, name in zip(order, ("tp", "fsdp")):
            ax = _logical_to_axis(ctx, name)
            if _fits(ctx, shape[cand], ax):
                axes[cand] = ax
        return tuple(axes)
    if len(shape) > len(logical):  # leading stack dims
        logical = (None,) * (len(shape) - len(logical)) + tuple(logical)
    else:
        logical = tuple(logical[-len(shape):]) if len(shape) else ()
    return logical_spec(ctx, shape, logical)


#: module lists of the port's ``LM`` that the reference stacks on leading dims
_STACKS = ("layers", "xattn", "encoder", "dec_xattn")


def _stack_dims(cfg, stack: str) -> tuple:
    if stack == "layers":
        if cfg.family == "vlm":
            g = cfg.cross_attn_every
            return (cfg.n_layers // g, g)
        return (cfg.n_layers,)
    if stack == "xattn":
        return (cfg.n_layers // cfg.cross_attn_every,)
    if stack == "encoder":
        return (cfg.encoder_layers,)
    return (cfg.n_layers,)                          # dec_xattn


def reference_path(cfg, name: str) -> tuple[str, tuple]:
    """A parameter name of the port's ``LM`` (``layers.3.attn.wq``, or
    prefixed ``mu.``/``nu.`` for a moment) as the reference's flattened
    path (``layers/attn/wq``) and the leading stack dims it has there
    (``(n_layers,)``; the vlm's ``layers`` ``(n_groups, g)``; ``()`` for
    an unstacked leaf)."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in _STACKS and parts[i + 1].isdigit():
            return "/".join(parts[:i + 1] + parts[i + 2:]), _stack_dims(cfg, part)
    return "/".join(parts), ()


def param_specs(ctx: MeshCtx, cfg, params, extra_rules=None) -> dict[str, tuple]:
    """Spec of each parameter (or optimizer moment) by name.  ``params``
    maps the port's names to tensors or shapes (an ``nn.Module`` is taken
    as its named parameters).  Each spec is the reference's for the
    stacked leaf, without the stack dims."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    out = {}
    for name, leaf in params.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        path, stack = reference_path(cfg, name)
        spec = spec_for_param(ctx, path, stack + shape, extra_rules)
        out[name] = spec[len(stack):]
    return out


# ---------------------------------------------------------------- inputs


def batch_spec(ctx: MeshCtx, shape) -> tuple:
    """Token batches (B, S) or embedding stubs (B, T, d): batch over dp."""
    ax = _logical_to_axis(ctx, "dp")
    if not _fits(ctx, shape[0], ax):
        # small-batch fallback: data only, else replicate
        ax = ctx.fsdp[0] if ctx.fsdp and shape[0] % ctx.size(ctx.fsdp[0]) == 0 else None
    return tuple([ax] + [None] * (len(shape) - 1))


def cache_spec(ctx: MeshCtx, shape, *, seq_axis: int | None, batch_axis: int = 1) -> tuple:
    """KV caches (L, B, T, H, D) or recurrent states (L, B, ...).

    Batch over dp when it divides, else the sequence axis (sequence-
    parallel decode); heads (dim -2) over tp when they divide, else the
    sequence axis takes tp too."""
    axes: list = [None] * len(shape)
    dp_ax = _logical_to_axis(ctx, "dp")
    used_tp = False
    if _fits(ctx, shape[batch_axis], dp_ax):
        axes[batch_axis] = dp_ax
    elif seq_axis is not None and _fits(ctx, shape[seq_axis], dp_ax):
        axes[seq_axis] = dp_ax
    if len(shape) >= 2 and ctx.tp and shape[-2] % ctx.size(ctx.tp) == 0:
        axes[-2] = ctx.tp
        used_tp = True
    if not used_tp and seq_axis is not None and axes[seq_axis] is None and _fits(
            ctx, shape[seq_axis], ctx.tp):
        axes[seq_axis] = ctx.tp
    elif not used_tp and seq_axis is not None and axes[seq_axis] == dp_ax:
        both = _logical_to_axis(ctx, "dp+tp")
        if _fits(ctx, shape[seq_axis], both):
            axes[seq_axis] = both
    return tuple(axes)


def decode_state_specs(ctx: MeshCtx, state, prefix: str = "") -> dict:
    """The spec of every leaf of a decode state (a nested dict of tensors
    or shapes, ``lm.init_decode_state``'s tree), as the reference's
    ``_decode_state_shardings`` gives it: a 0-d leaf replicated, a KV
    cache ``.../k`` or ``.../v`` (L, B, T, H, D) by :func:`cache_spec` with
    its sequence on axis 2, a recurrent state (L, B, ...) with none."""
    out = {}
    for key, leaf in state.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(leaf, Mapping):
            out[key] = decode_state_specs(ctx, leaf, name)
            continue
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape:
            out[key] = ()
        elif name.endswith("/k") or name.endswith("/v"):
            out[key] = cache_spec(ctx, shape, seq_axis=2)
        else:
            out[key] = cache_spec(ctx, shape, seq_axis=None)
    return out


# ------------------------------------------------------------ placements


def to_placements(spec, mesh) -> list:
    """The DTensor placements on ``mesh`` (a ``DeviceMesh``, or its dim
    names) that say what ``spec`` says: ``Shard(d)`` on each mesh dim whose
    axis names an entry of tensor dim d, ``Replicate()`` on the others.
    An entry of several axes shards its dim over each, in their order."""
    from torch.distributed.tensor import Replicate, Shard

    names = getattr(mesh, "mesh_dim_names", mesh)
    where = {}
    for dim, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                where[ax] = dim
    return [Shard(where[n]) if n in where else Replicate() for n in names]


def local_extent(shape, mesh, placements) -> tuple[tuple, tuple]:
    """This rank's shard of a tensor of ``shape`` placed on ``mesh`` by
    ``placements`` (``Shard``/``Replicate``, each sharded dim divisible):
    (its shape, the global index of its first element).  A dim sharded
    over several mesh dims is split in their order, the first outermost,
    as DTensor and the reference's ``PartitionSpec`` both split it."""
    size, start = list(shape), [0] * len(shape)
    for i, pl in enumerate(placements):
        if not hasattr(pl, "dim"):
            continue
        n, r = mesh.size(i), mesh.get_local_rank(i)
        if size[pl.dim] % n:
            raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not divide over {n} ranks")
        size[pl.dim] //= n
        start[pl.dim] += r * size[pl.dim]
    return tuple(size), tuple(start)


def local_zeros(shape, dtype, mesh, placements, *, device, fill: float = 0.0):
    """A DTensor of ``shape`` on ``mesh`` with ``placements``, every element
    ``fill``, built from this rank's shard alone (the whole is never
    made)."""
    import torch
    from torch.distributed.tensor import DTensor

    local, _ = local_extent(shape, mesh, placements)
    t = torch.full(local, fill, dtype=dtype, device=device)
    stride = tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=stride)


def place(t, mesh, placements):
    """The whole tensor ``t`` (the same on every rank) as a DTensor on
    ``mesh`` with ``placements``: each rank keeps its own shard, no
    collective (FSDP's ``_StridedShard`` placements included).  A shard
    that is a view of the whole is copied, so the whole is not kept."""
    from torch.distributed.tensor import DTensor, Replicate

    t = t.to(mesh.device_type)
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out = full.redistribute(mesh, placements)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        out = DTensor.from_local(local.clone(), mesh, out.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def constrain(x, logical, ctx: MeshCtx | None = None):
    """``x`` redistributed to the placements of ``logical`` on its own
    mesh; a no-op without a mesh context and on a plain tensor."""
    from torch.distributed.tensor import DTensor

    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = logical_spec(ctx, x.shape, logical)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))

