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
    moe family's sharded training step is refused."""
    from repro_torch import interop
    from repro_torch.data import synthetic_batch
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = _cfg(arch, changes)
    mesh = _mesh(shape)
    model = interop.lm_params_from_numpy(cfg, load_tree(os.path.join(folder, "params.npz")),
                                         device="cpu")
    wrong = _sharded(model, mesh)
    opt = adamw_init(model)
    step = make_train_step(cfg, mesh=mesh, **kw)
    history = []
    with _counted_drops() as drops:
        for i in range(steps):
            b = synthetic_batch(0, i, batch, seq, cfg.vocab)
            opt, m = step(model, opt, b, i)
            history.append({k: float(v) for k, v in m.items()})
    params = interop.lm_params_to_numpy(cfg, model)
    moments = interop.opt_state_to_numpy(cfg, opt)
    refused = None
    if shape[1] > 1:
        try:
            make_train_step(_cfg("deepseek-moe-16b", {}), mesh=mesh)
        except NotImplementedError as e:
            refused = str(e)
    if rank == 0:
        save_tree(os.path.join(folder, "got.npz"), params)
        save_tree(os.path.join(folder, "mu.npz"), moments["mu"])
        with open(os.path.join(folder, "got.json"), "w") as f:
            json.dump(dict(history=history, wrong=wrong, refused=refused,
                           count=int(moments["count"]), drops=drops), f)


def _sharded(model, mesh) -> list:
    """Shard ``model`` over ``mesh`` (``shard_model``, the expert stacks by
    ``expert_rules``) and return each parameter whose placements are not
    its spec's, as [name, got, want]."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.sharding import MeshCtx, param_specs, to_placements
    from repro_torch.models.steps import expert_rules, shard_model

    specs = param_specs(MeshCtx(mesh), model.cfg, model, expert_rules(model.cfg))
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
    return wrong


class _counted_drops:
    """Counts the slots the MoE's global routing drops on this rank (its
    ``moe.global_slots``, looked up by ``moe_ffn`` at call time) while
    entered: a list of one count per call."""

    def __enter__(self):
        from repro_torch.models import moe

        self.counts, self._orig = [], moe.global_slots

        def counted(*args, **kwargs):
            keep, slot = self._orig(*args, **kwargs)
            self.counts.append(int((~keep).sum()))
            return keep, slot
        moe.global_slots = counted
        return self.counts

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.global_slots = self._orig


def _leaves(tree, prefix=""):
    """(path "a/b", leaf) for each leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}{SEP}")
        else:
            yield f"{prefix}{k}", v


def decode_on_mesh(rank, world, shape, arch, batch, seq, folder, changes=None) -> None:
    """The reference's weights (``folder``/params.npz) sharded over a
    ``shape`` mesh, the decode state placed by ``init_decode_state(mesh=)``,
    then ``make_serve_step(mesh=)`` over the tokens of ``folder``/
    tokens.npy (steps, batch); rank 0 writes each step's logits, every
    cache and state leaf gathered whole (keys "k", "mlstm/c", ...), each
    leaf's placements and local shape, and the parameters placed otherwise
    than their specs say."""
    from repro_torch import interop
    from repro_torch.models import lm
    from repro_torch.models.steps import make_serve_step

    cfg = _cfg(arch, changes or {})
    mesh = _mesh(shape)
    model = interop.lm_params_from_numpy(cfg, load_tree(os.path.join(folder, "params.npz")),
                                         device="cpu")
    wrong = _sharded(model, mesh)
    tokens = torch.from_numpy(np.load(os.path.join(folder, "tokens.npy")))
    state = lm.init_decode_state(cfg, batch, seq, device="cpu", mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh)
    logits = []
    for t in tokens:
        out, state = step(model, state, dict(tokens=t))
        logits.append(out.full_tensor().numpy())
    leaves = dict(_leaves(state["cache"]))
    cache = {k: v.full_tensor().numpy() for k, v in leaves.items()}
    local = {k: list(v.to_local().shape) for k, v in leaves.items()}
    placements = {k: [str(p) for p in v.placements] for k, v in leaves.items()}
    if rank == 0:
        np.savez(os.path.join(folder, "got.npz"), logits=np.stack(logits), **cache)
        with open(os.path.join(folder, "got.json"), "w") as f:
            json.dump(dict(placements=placements, local=local, pos=int(state["pos"]),
                           wrong=wrong), f)


def prefill_on_mesh(rank, world, shape, arch, changes, folder, batch, seq) -> None:
    """The reference's weights (``folder``/params.npz) sharded over a
    ``shape`` mesh, ``make_prefill_step(mesh=)`` on ``synthetic_batch(0, 0,
    batch, seq)``; rank 0 writes the metrics and the parameters placed
    otherwise than their specs say."""
    from repro_torch import interop
    from repro_torch.data import synthetic_batch
    from repro_torch.models.steps import make_prefill_step

    cfg = _cfg(arch, changes)
    mesh = _mesh(shape)
    model = interop.lm_params_from_numpy(cfg, load_tree(os.path.join(folder, "params.npz")),
                                         device="cpu")
    wrong = _sharded(model, mesh)
    metrics = make_prefill_step(cfg, mesh=mesh)(model, synthetic_batch(0, 0, batch, seq,
                                                                       cfg.vocab))
    if rank == 0:
        with open(os.path.join(folder, "got.json"), "w") as f:
            json.dump(dict(metrics={k: float(v) for k, v in metrics.items()}, wrong=wrong), f)


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


def mesh_refusals(rank, world, folder) -> None:
    """What the steps on a mesh refuse, each refusal's message (None where
    nothing was raised): decode of hymba-smoke at batch 1 on (8, 1), whose
    ring cache the rules split on its positions, of the hybrid family at
    model > 1 and of the vlm family on any mesh; training deepseek-moe's
    "manual" and "grouped" dispatches on (8, 1)."""
    from repro_torch.models import lm
    from repro_torch.models.steps import make_serve_step, make_train_step

    def refused(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None

    out = dict(ring=refused(lambda: lm.init_decode_state(_cfg("hymba-1.5b", {}), 1, 64,
                                                         device="cpu", mesh=_mesh((8, 1)))),
               hybrid=refused(lambda: make_serve_step(_cfg("hymba-1.5b", {}),
                                                      mesh=_mesh((4, 2)))),
               vlm=refused(lambda: make_serve_step(_cfg("llama-3.2-vision-11b", {}),
                                                   mesh=_mesh((8, 1)))))
    for mode in ("manual", "grouped"):
        cfg = _cfg("deepseek-moe-16b", dict(moe_dispatch_sharding=mode))
        out[f"train-{mode}"] = refused(lambda: make_train_step(cfg, mesh=_mesh((8, 1))))
    if rank == 0:
        with open(os.path.join(folder, "refusals.json"), "w") as f:
            json.dump(out, f)


def moe_ffn_on_mesh(rank, world, folder, cases) -> None:
    """``moe_ffn`` of ``folder``/params.npz on each case's mesh: the
    expert stacks split over ``model`` (``E/M`` experts a rank), the router
    and the shared experts placed by their specs, the case's x
    (``folder``/<x>.npy) split over the data ranks as ``batch_spec`` says
    and the data ranks handed down as the steps hand them
    (``data_ranks``); rank 0 writes the output
    gathered whole and the two aux terms (``folder``/got_<case>.npz)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.models.sharding import MeshCtx, spec_for_param, to_placements
    from repro_torch.models.steps import data_ranks, expert_rules, local_batch

    cfg = _cfg("deepseek-moe-16b", {})
    with np.load(os.path.join(folder, "params.npz")) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    for case, (shape, mode, xname, cf, k) in cases.items():
        mesh = _mesh(shape)
        e, d, f = params["w_gate"].shape
        m = moe.MoE(d, e, f, int("sh_gate" in params), torch.float32, device="cpu")
        rules = expert_rules(replace(cfg, moe_dispatch_sharding=mode))
        with torch.no_grad():
            for name, v in params.items():
                spec = spec_for_param(MeshCtx(mesh), f"layers/moe/{name}", tuple(v.shape), rules)
                w = distribute_tensor(v.clone(), mesh["model"], to_placements(spec, ["model"]),
                                      src_data_rank=None)
                setattr(m, name, torch.nn.Parameter(w, requires_grad=False))
        x = torch.from_numpy(np.load(os.path.join(folder, f"{xname}.npy")))
        dp = data_ranks(cfg, mesh, x.shape[0])
        with torch.no_grad():
            y, aux = moe.moe_ffn(m, local_batch(dict(x=x), mesh)["x"], top_k=k,
                                 capacity_factor=cf, dispatch_sharding=mode, dp=dp)
        if dp.split:
            parts = [torch.empty_like(y) for _ in range(dist.get_world_size(dp.group))]
            dist.all_gather(parts, y.contiguous(), group=dp.group)
            y = torch.cat(parts)
        if rank == 0:
            np.savez(os.path.join(folder, f"got_{case}.npz"), y=y.numpy(),
                     local_experts=m.w_gate.to_local().shape[0],
                     **{key: float(v) for key, v in aux.items()})


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
