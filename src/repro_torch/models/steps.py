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

**On a mesh** (``make_train_step(cfg, mesh=...)``, a ``DeviceMesh`` with
axes ``("data", "model")`` or ``("pod", "data", "model")``, and a model
sharded by :func:`shard_model`) the step takes the global batch and each
rank trains on its slice of it (``sharding.batch_spec``: over ``pod`` and
``data``, the same on every ``model`` rank).  FSDP2 reduces the
gradients of the parameters it shards (a mean over the data ranks); the
ones it leaves alone, replicated over ``data`` by their spec, are
averaged here.  ``loss`` and ``nll`` are the global batch's mean and
``grad_norm`` the whole gradient's norm.  The families other than dense
train on a mesh whose ``model`` dim is 1 (FSDP alone); with ``model >
1`` they raise until their tensor or expert parallelism is ported, and
the moe family's ``"manual"`` and ``"grouped"`` dispatches, whose
gradients on a mesh are not yet checked against the reference's, raise
on any mesh.  The MoE routes over the mesh's data ranks
(:func:`data_ranks`), which reach ``moe_ffn`` as an argument.

The moe family also serves (``make_prefill_step`` and
``make_serve_step`` with ``mesh``) at ``model > 1``: its attention is
tensor-parallel as the dense family's, its experts split over ``model``
(``moe_ffn``), in each of the reference's dispatch modes.

``make_serve_step(cfg, mesh=...)`` decodes on a sharded model against a
state from ``lm.init_decode_state(..., mesh=)`` (the reference's dry run
places the same state by ``_decode_state_shardings``): each rank's rows
of the batch, the logits back as ``batch_spec`` places them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..configs.base import ArchConfig, ShapeSpec
from ..optim import adamw_update, cosine_schedule
from . import lm
from .common import DataRanks, Dtype
from .sharding import EP_ONLY_EXPERT_RULES, MeshCtx, batch_spec, param_specs, to_placements

__all__ = ["TensorSpec", "input_specs", "supports_shape", "make_train_step",
           "make_prefill_step", "make_serve_step", "shard_model", "expert_rules",
           "local_batch", "data_ranks"]


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


def expert_rules(cfg: ArchConfig):
    """The extra sharding rules of ``cfg``, as the reference's dry run
    picks them: the MoE's grouped dispatch keeps its experts EP-only."""
    if cfg.moe_dispatch_sharding in ("grouped", "auto_ep", "manual"):
        return EP_ONLY_EXPERT_RULES
    return None


def _owner(model: nn.Module, name: str):
    *path, attr = name.split(".")
    mod = model
    for part in path:
        mod = getattr(mod, part)
    return mod, attr


def _has_axis(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def shard_model(model: lm.LM, mesh) -> lm.LM:
    """Shard ``model`` in place over ``mesh`` by the reference's rules
    (``sharding.param_specs``) and return it.

    Tensor parallelism over ``model``: each parameter becomes a DTensor
    over ``mesh["model"]``, ``Shard(d)`` where its spec names ``model`` on
    dim d, else ``Replicate()`` (the dense and moe families; the others
    need ``model == 1``), the specs' rules extended by ``expert_rules(cfg)``
    (EP-only expert stacks, E over ``model`` and whole over ``data``, under
    the grouped, manual and auto_ep dispatches, as the reference's dry run
    places them).  FSDP over ``data`` (and
    replicated over ``pod``, as HSDP): FSDP2's ``fully_shard`` on each
    decoder layer and on the root, ``shard_placement_fn`` giving the dim
    the spec names ``data`` on.  A parameter whose spec names no ``data``
    dim is left out of FSDP
    (``ignored_params``), replicated over the data ranks as the spec
    says; the step averages its gradient.  So is a parameter whose dtype
    is not the model's (the MoE's float32 router in a bf16 model): FSDP2
    gathers a unit in one dtype.  The rules never put ``data``
    and ``model`` on one dim, so each placement is the spec's own
    ``Shard``/``Replicate`` (FSDP's ``_StridedShard`` does not arise).
    Every rank must hold the same full weights when this is called."""
    from torch.distributed.fsdp import fully_shard

    cfg = model.cfg
    ctx = MeshCtx(mesh)
    tp = _refuse_tp(cfg, ctx)
    specs = param_specs(ctx, cfg, model, expert_rules(cfg))
    if tp > 1:
        tp_mesh = mesh["model"]
        for name, p in list(model.named_parameters()):
            mod, attr = _owner(model, name)
            d = distribute_tensor(p.detach(), tp_mesh, to_placements(specs[name], ["model"]),
                                  src_data_rank=None)
            setattr(mod, attr, nn.Parameter(d, requires_grad=p.requires_grad))
    dp = tuple(a for a in ("pod", "data") if a in ctx.shape)
    fsdp_dim, ignored = {}, set()
    dtype = Dtype(cfg.dtype).param
    for name, p in model.named_parameters():
        dims = [i for i, e in enumerate(specs[name]) if _has_axis(e, "data")]
        # FSDP2 gathers a unit's parameters in one dtype: one kept in another (the MoE's
        # float32 router in a bf16 model) stays whole over the data ranks
        if dims and p.dtype == dtype:
            fsdp_dim[id(p)] = Shard(dims[0])
        else:
            ignored.add(p)
    kw = dict(mesh=mesh[dp], shard_placement_fn=lambda p: fsdp_dim[id(p)],
              ignored_params=ignored)
    for layer in model.layers:
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    return model


#: the families whose tensor parallelism is ported: for serving, for training
TP_SERVE, TP_TRAIN = ("dense", "moe"), ("dense",)


def _refuse_tp(cfg: ArchConfig, ctx: MeshCtx, train: bool = False) -> int:
    """The ``model`` dim's size; raises where it is > 1 for a family whose
    tensor parallelism is not ported (for training, with ``train``)."""
    tp = ctx.size("model") if "model" in ctx.shape else 1
    if tp > 1 and cfg.family not in (TP_TRAIN if train else TP_SERVE):
        what = "training with tensor parallelism" if train else "tensor parallelism"
        raise NotImplementedError(
            f"{cfg.name}: {what} for the {cfg.family} family is not ported "
            "(ROADMAP A2: TP/EP for the moe training, hybrid, ssm, vlm and audio families); "
            "run it on a mesh with model=1")
    return tp


def data_ranks(cfg: ArchConfig, mesh, batch_size: int) -> DataRanks | None:
    """The mesh's data ranks as a model that reads them sees a batch of
    ``batch_size`` rows (the MoE routes over them; the ssm family's (L, B,
    H) decode states hold every row): where ``sharding.batch_spec`` splits
    the batch, the ranks it is split over, in the batch's order; else
    every ``pod`` × ``data`` rank, each holding the whole batch.  None
    where they are one rank or the model does not read them."""
    if not (cfg.n_experts or cfg.family == "ssm"):
        return None
    ctx = MeshCtx(mesh)
    every = tuple(a for a in ("pod", "data") if a in ctx.shape)
    entry = batch_spec(ctx, (batch_size,))[0]
    split = entry is not None and ctx.size(entry) > 1
    axes = (entry if isinstance(entry, tuple) else (entry,)) if split else every
    if not axes or ctx.size(axes) == 1:
        return None
    if split and axes != every and cfg.moe_dispatch_sharding in ("manual", "grouped"):
        raise NotImplementedError(
            f"{cfg.name}: a MoE batch split over some of the data ranks only (it divides the "
            "data but not the pod and data ranks) under 'manual' or 'grouped' is not ported "
            "(ROADMAP A2)")
    group = mesh[axes]._flatten().get_group() if len(axes) > 1 else mesh.get_group(axes[0])
    return DataRanks(group, split)


def local_batch(batch: dict, mesh) -> dict:
    """This rank's slice of a global batch: dim 0 split over the
    (``pod``, ``data``) ranks as ``sharding.batch_spec`` says (whole where
    it does not divide)."""
    ctx = MeshCtx(mesh)
    out = {}
    for k, v in batch.items():
        entry = batch_spec(ctx, tuple(v.shape))[0]
        if entry is None:
            out[k] = v
            continue
        idx = 0
        for ax in entry if isinstance(entry, tuple) else (entry,):
            idx = idx * ctx.size(ax) + mesh.get_local_rank(ax)
        n = v.shape[0] // ctx.size(entry)
        out[k] = v[idx * n:(idx + 1) * n]
    return out


def _dp_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` averaged over the (``pod``, ``data``) ranks, in place."""
    n = 1
    for ax in ("pod", "data"):
        if ax in mesh.mesh_dim_names:
            dist.all_reduce(t, group=mesh.get_group(ax))
            n *= mesh.size(mesh.mesh_dim_names.index(ax))
    return t.div_(n)


def _fsdp_managed(p) -> bool:
    return isinstance(p, DTensor) and "data" in (p.device_mesh.mesh_dim_names or ())


def _make_sharded_step(cfg: ArchConfig, sched, mesh, use_kernel, microbatch):
    """The train step on ``mesh``: each rank's slice of the batch, FSDP's
    backward and gradient reduction, the ignored parameters' gradients
    averaged here, the loss averaged over the data ranks.  With
    microbatches, microbatch i is the reference's (rows [i·B/n, (i+1)·B/n)
    of the global batch) split over the data ranks; each one's reduced
    gradient is added into float32 zeros with the parameter's placements
    and divided by their count, as the reference sums its microbatches'
    gradients."""

    def reduced(p):
        """``p``'s gradient from the last backward, in ``p``'s placements
        (zeros where the loss did not reach it); not yet averaged over the
        data ranks where FSDP does not manage ``p``."""
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        return g

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        batch = _on(model, batch)
        n = microbatch if microbatch and microbatch > 1 else 1
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of microbatch {n}")
        m = b // n
        dp = data_ranks(cfg, mesh, m)
        model.zero_grad(set_to_none=True)
        sums: dict = {}
        grads = None
        for i in range(n):
            # microbatch i is the reference's, rows [i·m, (i+1)·m) of the global batch, split
            # over the data ranks: the MoE routes over exactly those rows
            mb = local_batch({k: v[i * m:(i + 1) * m] for k, v in batch.items()}, mesh)
            loss, metrics = model(mb, cfg, use_kernel, dp)
            loss.backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0) + v.detach()
            if n > 1:
                if grads is None:
                    grads = {k: torch.zeros_like(p, dtype=torch.float32).detach()
                             for k, p in params.items()}
                for k, p in params.items():
                    grads[k].add_(reduced(p))
                model.zero_grad(set_to_none=True)
        if grads is None:
            grads = {k: reduced(p) for k, p in params.items()}
        else:
            for g in grads.values():
                g.div_(n)
        for k, p in params.items():
            if not _fsdp_managed(p):
                g = grads[k]
                _dp_mean(g.to_local() if isinstance(g, DTensor) else g, mesh)
        metrics = {k: _dp_mean(v / n, mesh) for k, v in sums.items()}
        if n > 1:   # the mean loss, also as nll, as the reference and one device report it
            metrics = dict(loss=metrics["loss"], nll=metrics["loss"])
        lr = sched(step)
        _, opt_state, gnorm = adamw_update(params, grads, opt_state, lr=lr)
        model.zero_grad(set_to_none=True)
        return opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_train_step(cfg: ArchConfig, *, base_lr=3e-4, total_steps=10_000, warmup_steps=200,
                    use_kernel=False, grad_compress=False, microbatch: int = 0, mesh=None):
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
    zero gradient.

    With ``mesh`` the step runs on a model sharded by :func:`shard_model`
    over that mesh (see the module's docstring); each microbatch, the
    same rows as on one device, is split over the data ranks, and its
    gradient is reduced over them and summed in float32, as on one device;
    every family but dense needs ``model == 1``, and the moe family's
    ``"manual"`` and ``"grouped"`` dispatches are refused on any mesh
    (``NotImplementedError``).  ``grad_compress`` is taken and not read, as in the reference
    (``repro/models/steps.py``): the int8 all-reduce is
    ``optim.compressed_psum``, for a data-parallel loop of one's own."""
    del grad_compress
    sched = cosine_schedule(base_lr, warmup_steps, total_steps)
    if mesh is not None:
        _refuse_tp(cfg, MeshCtx(mesh), train=True)
        if cfg.n_experts and cfg.moe_dispatch_sharding in ("manual", "grouped"):
            raise NotImplementedError(
                f"{cfg.name}: training the MoE's {cfg.moe_dispatch_sharding!r} dispatch on a "
                "mesh is not ported (ROADMAP A2): its routing and gradients there are not "
                "checked against the reference's; use 'auto'")
        return _make_sharded_step(cfg, sched, mesh, use_kernel, microbatch)

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


def make_prefill_step(cfg: ArchConfig, *, use_kernel=False, mesh=None):
    """Forward-only loss eval at prefill shape (inference-prefill cell).
    With ``mesh``, on a model sharded by :func:`shard_model` (the dense and
    moe families at any ``model``, the others at ``model == 1``): each
    rank's slice of the batch, the metrics averaged over the data ranks."""
    if mesh is not None:
        _refuse_tp(cfg, MeshCtx(mesh))
        @torch.no_grad()
        def sharded_prefill_step(model, batch):
            dp = data_ranks(cfg, mesh, batch["tokens"].shape[0])
            _, metrics = model(local_batch(_on(model, batch), mesh), cfg, use_kernel, dp)
            return {k: _dp_mean(v.detach().clone(), mesh) for k, v in metrics.items()}

        return sharded_prefill_step

    @torch.inference_mode()
    def prefill_step(model, batch):
        _, metrics = lm.forward_loss(cfg, model, batch, use_kernel=use_kernel)
        return metrics

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, mesh=None):
    """``(model, state, batch) -> (logits, state)``: one decode step of
    ``batch["tokens"]``, with ``batch["vision"]`` (vlm) or
    ``batch["memory"]`` (audio: the encoder's output) where present.

    With ``mesh``, on a model sharded by :func:`shard_model` and a state
    from ``lm.init_decode_state(..., mesh=mesh)`` for the same global
    batch: each rank decodes its rows of ``tokens`` (the same on every
    rank), and the logits come back as a DTensor placed as
    ``sharding.batch_spec`` says, the state's caches still sharded.  The
    dense and moe families decode at any ``model`` (the MoE routes the
    decode batch as its dispatch mode says, capacity from the batch); the
    hybrid and ssm families need ``model = 1``; the vlm and audio families
    are refused (their cross-attention on a mesh is not ported)."""
    if mesh is None:
        @torch.inference_mode()
        def serve_step(model, state, batch):
            return lm.decode_step(cfg, model, state, batch["tokens"],
                                  memory=batch.get("memory"), vision=batch.get("vision"))

        return serve_step
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: decode of the {cfg.family} family on a mesh is not ported "
            "(ROADMAP A2: TP/EP for the moe, hybrid, ssm, vlm and audio families)")
    ctx = MeshCtx(mesh)
    _refuse_tp(cfg, ctx)

    @torch.no_grad()
    def sharded_serve_step(model, state, batch):
        tokens = _on(model, dict(tokens=batch["tokens"]))["tokens"]
        b = tokens.shape[0]
        logits, state = lm.decode_step(cfg, model, state,
                                       local_batch(dict(tokens=tokens), mesh)["tokens"],
                                       dp=data_ranks(cfg, mesh, b))
        logits = DTensor.from_local(logits, mesh, to_placements(batch_spec(ctx, (b, cfg.vocab)),
                                                                mesh),
                                    run_check=False, shape=(b, cfg.vocab), stride=(cfg.vocab, 1))
        return logits, state

    return sharded_serve_step
