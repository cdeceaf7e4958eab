"""Device meshes for the sharded training step.

Port of ``repro/launch/mesh.py``.  Functions, not module-level meshes, so
that importing this module starts no process group.

* :func:`make_production_mesh`: the reference's production layout, 16 ×
  16 ranks as ``("data", "model")``, or 2 × 16 × 16 with ``"pod"`` in
  front.  Only the dry run builds it, over a fake process group of 256 or
  512 ranks (``launch.dryrun``).
* :func:`make_local_mesh`: whatever world ``torch.distributed`` has, as
  ``(data, model)``: NCCL on the cards, gloo on the CPU.  Without a
  process group it starts the default one from the environment that
  ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...),
  and on the cards it first makes ``LOCAL_RANK``'s card the current one.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """16 × 16 = 256 ranks per pod; 2 pods = 512 ranks, on the CPU: the
    process group (the dry run's fake one) must exist and have that many
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_local_mesh(data: int | None = None, model: int = 1, *, device: str = "cuda"):
    """A ``(data, model)`` mesh over every rank of the default process
    group (started from the environment when there is none: ``nccl`` for
    ``device="cuda"``, ``gloo`` for ``"cpu"``); ``data`` defaults to the
    world size over ``model``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    n = dist.get_world_size()
    data = data or n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the world "
                         f"has {n}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
