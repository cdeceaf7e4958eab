"""Rank functions for ``tests/test_torch_sharding.py``.

Each runs in a process that :func:`spawn` starts: one rank of a gloo
world whose process group meets through a file store (no socket, no
port).  They import the port only, so that a rank does not load jax;
rank 0 writes what the test compares into a folder.
"""
from __future__ import annotations

import datetime
import json
import os
import tempfile
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEP = "/"


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks."""
    folder = tempfile.mkdtemp(prefix="torch_mesh_pg_")
    mp.spawn(_entry, args=(fn, world, os.path.join(folder, "store"), args), nprocs=world,
             join=True)


def _entry(rank: int, fn, world: int, store: str, args) -> None:
    torch.set_num_threads(1)
    # a collective that waits this long raises, so a stuck rank ends the spawn
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def save_tree(path: str, tree) -> None:
    """A nested dict of arrays as one npz, keys joined with '/'."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[SEP.join(prefix + (k,))] = np.asarray(v)
    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parts, leaf = key.split(SEP)
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))


def _cfg(arch: str, changes: dict):
    from repro_torch.configs import get_smoke

    return replace(get_smoke(arch), dtype="float32", **changes)


def step_on_mesh(rank, world, shape, arch, changes, folder, steps, batch, seq, kw) -> None:
    """The reference's weights (``folder``/params.npz) sharded over a
    ``shape`` mesh, ``steps`` sharded train steps on ``synthetic_batch``;
    rank 0 writes the metrics, the placements against the specs', and the
    gathered parameters.  On a mesh with ``model > 1``, also whether the
    moe family's tensor parallelism is refused."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import interop
    from repro_torch.data import synthetic_batch
    from repro_torch.models import lm
    from repro_torch.models.sharding import MeshCtx, param_specs, to_placements
    from repro_torch.models.steps import make_train_step, shard_model
    from repro_torch.optim import adamw_init

    cfg = _cfg(arch, changes)
    mesh = _mesh(shape)
    model = interop.lm_params_from_numpy(cfg, load_tree(os.path.join(folder, "params.npz")),
                                         device="cpu")
    specs = param_specs(MeshCtx(mesh), cfg, model)
    shard_model(model, mesh)
    wrong = []
    for name, p in model.named_parameters():
        want = to_placements(specs[name], mesh)
        # a mesh dim a parameter's DTensor does not span holds it whole
        on = dict(zip(p.device_mesh.mesh_dim_names, p.placements)) if isinstance(
            p, DTensor) else {}
        got = [on.get(n, Replicate()) for n in mesh.mesh_dim_names]
        # on a dim of one rank every placement holds the whole
        got, want = ([Replicate() if mesh.size(i) == 1 else x for i, x in enumerate(pl)]
                     for pl in (got, want))
        if got != want:
            wrong.append([name, str(got), str(want)])
    opt = adamw_init(model)
    step = make_train_step(cfg, mesh=mesh, **kw)
    history = []
    for i in range(steps):
        b = synthetic_batch(0, i, batch, seq, cfg.vocab)
        opt, m = step(model, opt, b, i)
        history.append({k: float(v) for k, v in m.items()})
    params = interop.lm_params_to_numpy(cfg, model)
    moments = interop.opt_state_to_numpy(cfg, opt)
    refused = None
    if shape[1] > 1:
        try:
            shard_model(lm.LM(_cfg("deepseek-moe-16b", {}), device="cpu"), mesh)
        except NotImplementedError as e:
            refused = str(e)
    if rank == 0:
        save_tree(os.path.join(folder, "got.npz"), params)
        save_tree(os.path.join(folder, "mu.npz"), moments["mu"])
        with open(os.path.join(folder, "got.json"), "w") as f:
            json.dump(dict(history=history, wrong=wrong, refused=refused,
                           count=int(moments["count"])), f)


def loop_on_mesh(rank, world, shape, arch, tc_kw, folder) -> None:
    """``TrainLoop`` on a ``shape`` mesh as ``tc_kw`` says (resuming from
    its checkpoints if any); rank 0 writes the final parameters and the
    logged steps."""
    from repro_torch import interop
    from repro_torch.train import TrainConfig, TrainLoop

    cfg = _cfg(arch, {})
    out = TrainLoop(cfg, TrainConfig(**tc_kw), mesh=_mesh(shape)).run()
    params = interop.lm_params_to_numpy(cfg, out["model"])
    if rank == 0:
        save_tree(os.path.join(folder, "final.npz"), params)
        with open(os.path.join(folder, "steps.json"), "w") as f:
            json.dump([m["step"] for m in out["history"]], f)


def compress_loop(rank, world, folder, steps, lr) -> None:
    """The reference's data-parallel quadratic loop with int8
    ``compressed_psum``: rank r's gradient from its slice of x; the
    residual carried is rank 0's, as the reference's shard_map returns one
    replicated residual (``out_specs=P()``)."""
    from repro_torch.optim import compressed_psum

    with np.load(os.path.join(folder, "data.npz")) as z:
        x, w_true = torch.from_numpy(z["x"][rank, 0]), torch.from_numpy(z["w_true"])
    w = torch.zeros(w_true.shape, dtype=torch.float32)
    resid = torch.zeros_like(w)
    for _ in range(steps):
        err = x @ (w - w_true)
        g = 2 * x.T @ err / x.shape[0]
        g, r = compressed_psum(dict(w=g), dict(w=resid), None)
        dist.broadcast(r["w"], src=0)
        resid = r["w"]
        w = w - lr * g["w"]
    if rank == 0:
        np.save(os.path.join(folder, "w.npy"), w.numpy())


def launch_train(rank, world, argv) -> None:
    """``python -m repro_torch.launch.train`` on this rank (the process
    group is up, as ``torchrun``'s environment would start it)."""
    from repro_torch.launch import train

    train.main(list(argv))


def run_all(rank, world, plan) -> None:
    """The rank functions of ``plan`` (pairs of a name of this module and
    its arguments), one after another on the same world: one start of the
    ranks for every mesh run of the test module."""
    for name, args in plan:
        globals()[name](rank, world, *args)
