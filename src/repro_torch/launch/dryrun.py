"""Production-mesh dry run: trace one sharded step of an (arch × shape)
cell on a fake world of 256 or 512 ranks, without a card and without
materialising the model.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step on 512 fake XLA host devices and reads the compiled program's
``memory_analysis()``, ``cost_analysis()`` and HLO.  Here:

* a ``"fake"`` process group (``torch.testing._internal.distributed.
  fake_pg``) of 256 ranks (16 × 16, ``("data", "model")``) or 512 (2 × 16
  × 16 with ``"pod"``), whose collectives do nothing;
* the model built on ``meta``, sharded by ``models.steps.shard_model``
  (tensor parallelism and FSDP2) outside fake mode, then ``to_empty`` on
  the CPU, which allocates rank 0's shards only;
* one step traced under ``FakeTensorMode`` with
  :class:`~repro_torch.roofline.op_cost.OpCost` (per-device FLOPs, bytes,
  peak bytes, collectives) and ``CommDebugMode`` (collective counts by
  op) around it: nothing is computed or allocated on the fake tensors.

The result follows the reference's JSON: ``status``, ``chips``,
``memory`` (per-device parameter, gradient, optimizer and, for a decode
cell, cache bytes from the placements; ``temp_bytes``, the most bytes the
traced step held at once),
``roofline`` (the three terms with H100 constants, ``dominant``),
``model_flops``, ``useful_flops_ratio``, ``collectives`` and ``params``.
``train``, ``prefill`` and ``decode`` cells run for the dense family, and
``prefill`` and ``decode`` cells for the moe family, its expert stacks
placed by ``steps.expert_rules`` (a decode cell traces
``make_serve_step(mesh=...)`` against a state made by
``init_decode_state(..., mesh=...)`` under fake mode, placed as the
reference's ``_decode_state_shardings`` places it); the moe family's ``train`` cells and every cell of the hybrid, ssm,
vlm and audio families return ``"skipped"`` with the reason (their
tensor parallelism is ROADMAP A2's open item), and a cell that fails
``"error"`` with the traceback, as the reference's sweep does.  Nothing
here imports jax or sets ``XLA_FLAGS``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes \\
      --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import replace

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, get_config, list_archs
from ..models.steps import (input_specs, make_prefill_step, make_serve_step, make_train_step,
                            shard_model, supports_shape)
from ..roofline import collective_bytes, model_flops, roofline_terms
from .mesh import make_production_mesh

__all__ = ["dryrun_cell", "fake_world", "shard_bytes", "main"]


def fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def shard_bytes(t: torch.Tensor, itemsize: int | None = None) -> int:
    """Bytes of this rank's shard of ``t`` (all of a plain tensor)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * (itemsize or local.element_size())


def _skip(arch, shape_name, mesh_name, why):
    return dict(arch=arch, shape=shape_name, mesh=mesh_name, status="skipped", reason=why)


def _mesh_cut(cfg, shape) -> str:
    """Why the port does not trace this cell, or ''."""
    if cfg.family == "moe" and shape.kind == "train":
        return ("training the moe family with tensor parallelism is not ported "
                "(ROADMAP A2); the production mesh has model=16")
    if cfg.family not in ("dense", "moe"):
        return (f"tensor parallelism for the {cfg.family} family is not ported "
                "(ROADMAP A2); the production mesh has model=16")
    return ""


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
                overrides: dict | None = None, mesh: dict | None = None,
                global_batch: int | None = None, seq_len: int | None = None) -> dict:
    """Trace one sharded step of ``arch`` × ``shape_name`` on the
    production mesh (2 × 16 × 16 with ``multi_pod``), or on ``mesh``
    (axis name → size, e.g. ``{"data": 4, "model": 1}``: the prediction
    for a run on that many cards), with the shape's global batch and
    sequence or ``global_batch`` and ``seq_len``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from ..models.lm import LM, init_decode_state
    from ..optim import adamw_init
    from ..roofline.op_cost import OpCost

    sizes = mesh or (dict(pod=2, data=16, model=16) if multi_pod else dict(data=16, model=16))
    mesh_name = "x".join(str(n) for n in sizes.values())
    cfg = get_config(arch)
    if overrides:
        cfg = replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    shape = replace(shape, global_batch=global_batch or shape.global_batch,
                    seq_len=seq_len or shape.seq_len)
    ok, why = supports_shape(cfg, shape)
    if ok:
        why = _mesh_cut(cfg, shape)
    if why:
        return _skip(arch, shape_name, mesh_name, why)
    chips = math.prod(sizes.values())
    t0 = time.perf_counter()
    try:
        fake_world(chips)
        if mesh is None:
            dmesh = make_production_mesh(multi_pod=multi_pod)
        else:
            dmesh = init_device_mesh("cpu", tuple(sizes.values()),
                                     mesh_dim_names=tuple(sizes))
        model = shard_model(LM(cfg, device="meta"), dmesh)
        model.to_empty(device="cpu")
        params = dict(model.named_parameters())
        n_params = sum(p.numel() for p in params.values())
        param_bytes = sum(shard_bytes(p) for p in params.values())
        t_shard = time.perf_counter() - t0
        cost = OpCost()
        cache_bytes = 0
        with FakeTensorMode(allow_non_fake_inputs=True):
            batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                     for k, s in input_specs(cfg, shape).items()}
            if shape.kind == "train":
                opt = adamw_init(model)
                step = make_train_step(cfg, mesh=dmesh)
                with CommDebugMode() as comm, cost:
                    step(model, opt, batch, 0)
            elif shape.kind == "prefill":
                step = make_prefill_step(cfg, mesh=dmesh)
                with CommDebugMode() as comm, cost:
                    step(model, batch)
            else:
                state = init_decode_state(cfg, shape.global_batch, shape.seq_len, device="cpu",
                                          mesh=dmesh)
                cache_bytes = sum(shard_bytes(t) for t in tree_leaves(state["cache"]))
                step = make_serve_step(cfg, mesh=dmesh)
                with CommDebugMode() as comm, cost:
                    step(model, state, batch)
        t_trace = time.perf_counter() - t0 - t_shard
        train = shape.kind == "train"
        grad_bytes = param_bytes if train else 0
        opt_bytes = sum(shard_bytes(p, 8) for p in params.values()) + 4 if train else 0
        coll = collective_bytes(cost.records)
        coll["comm_debug_counts"] = {str(k): v for k, v in comm.get_comm_counts().items()}
        terms = roofline_terms({"flops": cost.flops, "bytes accessed": cost.bytes}, coll,
                               chips=chips)
        mf = model_flops(cfg, shape)
        total_flops = terms["hlo_flops_per_chip"] * chips
        result = dict(
            arch=arch, shape=shape_name, mesh=mesh_name, status="ok", chips=chips,
            seconds_shard=round(t_shard, 2), seconds_trace=round(t_trace, 2),
            memory=dict(param_bytes=param_bytes, grad_bytes=grad_bytes,
                        optimizer_bytes=opt_bytes, cache_bytes=cache_bytes,
                        argument_bytes=param_bytes + opt_bytes + cache_bytes,
                        temp_bytes=cost.peak_bytes,
                        total_bytes=param_bytes + opt_bytes + cache_bytes + cost.peak_bytes),
            roofline=terms, model_flops=mf,
            useful_flops_ratio=mf / total_flops if total_flops else None,
            collectives=coll, ops=cost.ops, params=n_params,
            global_batch=shape.global_batch)
        if verbose:
            gb = 1e9
            print(f"== {arch} × {shape_name} × {mesh_name} ==")
            print(f"memory per device: params {param_bytes / gb:.3f} GB, grads "
                  f"{grad_bytes / gb:.3f}, optimizer {opt_bytes / gb:.3f}, cache "
                  f"{cache_bytes / gb:.3f}, step peak {cost.peak_bytes / gb:.3f}")
            print(f"flops/chip {cost.flops:.4e}, bytes/chip {cost.bytes:.4e}")
            print("collectives:", json.dumps(coll["per_kind"]), json.dumps(coll["counts"]))
            print("roofline s: compute={t_compute:.4f} memory={t_memory:.4f} "
                  "collective={t_collective:.4f} dominant={dominant}".format(**terms))
        return result
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        return dict(arch=arch, shape=shape_name, mesh=mesh_name, status="error",
                    error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false", "True", "False"):
        return k, v.lower() == "true"
    return k, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="ArchConfig override(s), e.g. --set n_layers=2")
    ap.add_argument("--tag", default="", help="suffix for result filenames")
    ap.add_argument("--mesh", default=None, metavar="data=D,model=M",
                    help="trace on this mesh instead of the production one")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None, help="sequence (default: the shape's)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        mesh = {k: int(v) for k, v in (part.split("=", 1) for part in args.mesh.split(","))}

    overrides = dict(_parse_override(kv) for kv in getattr(args, "set"))
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                res = dryrun_cell(arch, shape, multi_pod=mp, overrides=overrides, mesh=mesh,
                                  global_batch=args.batch, seq_len=args.seq)
                if overrides:
                    res["overrides"] = overrides
                if res["status"] == "error":
                    failures += 1
                    print(f"!! {arch} × {shape} × {res['mesh']}: {res['error']}",
                          file=sys.stderr)
                elif res["status"] == "skipped":
                    print(f"-- {arch} × {shape}: skipped ({res['reason']})")
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    tag = f"__{args.tag}" if args.tag else ""
                    fn = f"{arch}__{shape}__{res['mesh']}{tag}.json".replace("/", "_")
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(res, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
