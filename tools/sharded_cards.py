#!/usr/bin/env python3
"""granite-3-8b trained whole, sharded over four cards.

One process a card (``torch.multiprocessing.spawn``, an NCCL process
group through a file store), the model sharded by
``repro_torch.models.steps.shard_model`` and trained by
``make_train_step(mesh=...)`` with the hand-written ``flash_attention``
forward and backward on each rank's local heads:

1. depth cut to 8 layers, bf16: one step on a ``(4, 1)`` mesh against one
   step of the unsharded model on one card from the same seeded weights
   and batch, in two cases (EXACT_CASES): 4 × 4096, whole on each rank
   (one card: 4 microbatches of 1 × 4096), and 8 × 2048 in 2
   microbatches a rank (one card: 8 microbatches), where the mesh sums
   each microbatch's reduced gradient in float32.  Loss within
   EXACT_TOL["loss"] relative, grad_norm within EXACT_TOL["grad_norm"]
   (bf16 gradients: FSDP's reduce-scatter sums four ranks' bf16
   gradients where one card sums its microbatches in float32), and a
   sample of the updated parameters gathered whole (SAMPLE) held to
   ``same_params``;
2. the whole model (40 layers, 8.17 B parameters, bf16, remat "full")
   on ``(4, 1)`` (FSDP alone) and on ``(2, 2)`` (FSDP over 2, tensor
   parallelism over 2), global batch 4 × 4096, from the same seeded
   weights and batch: a first step whose loss and grad_norm on ``(2,
   2)`` must be within MESH_TOL (relative) of ``(4, 1)``'s and whose
   updated SAMPLE is held to ``same_params`` against ``(4, 1)``'s
   (SAME_SHARE_TP; TP32 holds tensor parallelism in float32, where the
   forward's rounding does not hide a wrong gradient); timed
   steps (ms a step, tokens/s, the model-FLOPs share of 4 × 989
   TFLOP/s), a profiled step on rank 0 (the card's busy time as the
   union of its kernels' intervals, the idle share, the NCCL kernels'
   time), a counted step under ``OpCost`` and ``CommDebugMode``
   (collective bytes by kind on rank 0, counted at dispatch), a step
   profiled with its collectives' sizes as the process group records
   them for NCCL (rank 0), the kernels' launches a step and each card's
   peak memory; beside each, ``launch.dryrun``'s prediction for the same
   mesh and shape over a fake process group (per-device bytes and
   collective bytes, counted at dispatch by the same ``OpCost``),
   traced in child processes while the kernels build.

Every number is printed beside ``nvidia-smi``'s card name and power
limit; the last line is the results as JSON.  Run from the repository
root on a machine with four cards::

    python tools/sharded_cards.py

``--device cpu`` rehearses the same flow on four gloo processes at a
small width (d_model 128, 4 heads, 2 layers, 4 × 128 tokens; the
attention takes its plain versions, so no launch is counted; the
limits, set by the cards' run, are printed and not held).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
WORLD = 4
#: the meshes of the whole model: (data, model)
MESHES = ((4, 1), (2, 2))
#: the whole model's run: global batch x sequence, timed steps
FULL = dict(batch=4, seq=4096, timed=3)
#: the 8-layer comparison with one card: (global batch, seq, microbatches a rank)
EXACT = dict(n_layers=8)
EXACT_CASES = ((4, 4096, 0), (8, 2048, 2))
#: relative limits against one card: a few times the 8-layer check's
#: readings on four H100s (loss equal, grad_norm 6.3e-6 apart)
EXACT_TOL = dict(loss=1e-6, grad_norm=3e-5)
#: relative limits of (2, 2)'s first step against (4, 1)'s: about five times
#: their gaps on four H100s (loss 4.1e-5, grad_norm 3.2e-5)
MESH_TOL = dict(loss=2e-4, grad_norm=2e-4)
#: the learning rate of every step (lr(0) = base_lr: the first update is
#: ±base_lr an element, which bf16 weights show)
STEP_KW = dict(base_lr=3e-4, warmup_steps=1, use_kernel=True)
#: parameters compared after a step: the first SAMPLE_ROWS rows of each
SAMPLE = ("embed", "lm_head", "final_norm", "layers.0.ln1", "layers.0.attn.wq",
          "layers.0.attn.wk", "layers.0.mlp.w_down", "layers.-1.mlp.w_up")
SAMPLE_ROWS = 512
#: share of the sample that must be bit-equal against one card (the same
#: forward, bf16 gradients reduced in another order); no element may differ
#: by more than 2 · base_lr and one bf16 spacing (an update of the other sign)
SAME_SHARE = 0.99
#: the same for (2, 2) against (4, 1) in bf16, where tensor parallelism
#: also rounds the forward's partial sums: set from its first reading on
#: four H100s (0.9746), the sharp check of tensor parallelism being TP32
SAME_SHARE_TP = 0.95
#: tensor parallelism held sharply: granite-3-8b at full width, 2 layers,
#: float32, (2, 2) against (4, 1), one step from the same weights and batch:
#: loss and grad_norm relative, the first moments' sample (the clipped
#: gradient) as a relative norm, and the share of the parameter sample
#: that took an update of the other sign
TP32 = dict(n_layers=2, dtype="float32", batch=4, seq=4096)
TP32_TOL = dict(loss=1e-6, grad_norm=1e-5, mu=1e-4, flipped=1e-3)
#: --device cpu: the same flow at a small width
SMALL = dict(d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, n_layers=2)
SMALL_RUN = dict(batch=4, seq=128, timed=1)


def say(*parts) -> None:
    print(*parts, flush=True)


def config(small: bool, **changes):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config(ARCH), **(dict(SMALL, **changes) if small else changes))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _union_ms(intervals) -> float:
    """Milliseconds covered by (start, end) microsecond intervals, each
    instant counted once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def sample_params(model, n_layers: int, named=None) -> dict:
    """SAMPLE's first SAMPLE_ROWS rows of each of the model's parameters
    (or of ``named``, tensors keyed by parameter name), gathered whole, as
    float32 on the host (every rank of a mesh must call this)."""
    from torch.distributed.tensor import DTensor

    params = dict(model.named_parameters()) if named is None else named
    out = {}
    for name in SAMPLE:
        key = name.replace("layers.-1.", f"layers.{n_layers - 1}.")
        p = params[key].detach()
        if isinstance(p, DTensor):
            p = p.full_tensor()
        out[key] = p[:SAMPLE_ROWS].float().cpu()
    return out


def same_params(got: dict, want: dict) -> dict:
    """``got`` against ``want`` after one step: the bit-equal share (also
    per parameter), the largest gap, how many elements differ by more
    than 2 · base_lr and one bf16 spacing of the larger of the two, and
    the share that took an update of the other sign (apart by more than
    base_lr: the first AdamW step moves an element by about ±base_lr)."""
    import torch

    lr = STEP_KW["base_lr"]
    equal = total = over = flips = 0
    worst = 0.0
    per = {}
    for k, w in want.items():
        d = (got[k] - w).abs()
        top = torch.maximum(got[k].abs(), w.abs()).clamp(min=2.0 ** -126)
        spacing = torch.exp2(torch.floor(torch.log2(top)) - 7)
        equal += int((d == 0).sum())
        per[k] = round(float((d == 0).float().mean()), 5)
        total += d.numel()
        over += int((d > 2 * lr + spacing).sum())
        flips += int((d > lr).sum())
        worst = max(worst, float(d.max()))
    return dict(share_equal=equal / total, share_flipped=flips / total, max_abs=worst,
                over=over, elements=total, per_param=per)


def relative_gap(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over all of the sample."""
    num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    den = sum(float(w.square().sum()) for w in want.values())
    return (num / den) ** 0.5


def nccl_bytes(trace_path: str) -> dict:
    """Collective sizes from a profiler trace: every event whose args name
    a ``Collective name`` (the process group's own record of what it
    asked NCCL to move), grouped by event name and category, each group's
    result bytes by kind with the ring factors of
    ``analysis.collective_bytes``."""
    from repro_torch.roofline import collective_bytes

    sizes = {"BFloat16": 2, "Half": 2, "Float": 4, "Double": 8, "Int": 4, "Long": 8,
             "Byte": 1, "Char": 1, "Bool": 1}
    kinds = (("allgather", "all-gather"), ("all_gather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"), ("reducescatter", "reduce-scatter"),
             ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
             ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"))
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    groups: dict = {}
    for e in events:
        a = e.get("args") or {}
        name = str(a.get("Collective name", "")).lower()
        kind = next((k for s, k in kinds if s in name), None)
        if kind is None or a.get("dtype") not in sizes or "Out msg nelems" not in a:
            continue
        groups.setdefault(f"{e.get('name')}|{e.get('cat')}", []).append(
            dict(collective=kind, bytes=int(a["Out msg nelems"]) * sizes[a["dtype"]]))
    return {g: collective_bytes(r) for g, r in groups.items()}


def profile_step(run, ops=()):
    """``run()`` under torch.profiler on this rank's card: (result, wall ms,
    busy ms, NCCL ms, busiest kernels) and, with ``ops``, a dict of the
    device ms of the kernels each of those CPU ops (e.g. ``"aten::bmm"``)
    launched.  Busy is the union of the card's
    kernel intervals: NCCL runs on a stream of its own beside the compute
    and the profiler also reports each collective as a device-side range,
    so a plain sum would count those instants twice.  Where the profiler
    fails, busy is None and the last item says why."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        events = prof.events()
        evs = [e for e in events if e.device_type == DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
        op_ms = {op: sum(e.self_device_time_total for e in events if e.name == op) / 1e3
                 for op in ops}
    except Exception as e:  # the profiler's own failure
        return (out, wall, None, None, f"{type(e).__name__}: {e}") + (({},) if ops else ())
    spans = [(e.time_range.start, e.time_range.end) for e in evs]
    nccl = [(e.time_range.start, e.time_range.end) for e in evs if "nccl" in e.name.lower()]
    by_name: dict = {}
    for e in evs:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (e.time_range.end
                                                                  - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (out, wall, _union_ms(spans), _union_ms(nccl), top) + ((op_ms,) if ops else ())


def one_cell(cfg, mesh, dev, batch, run, rank) -> dict:
    """The whole model on ``mesh``: warm-up, timed, profiled and counted
    steps; rank 0's numbers and every rank's peak memory."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step, shard_model
    from repro_torch.optim import adamw_init
    from repro_torch.roofline import HW, collective_bytes, model_flops
    from repro_torch.roofline.op_cost import OpCost

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    shard_model(model, mesh)
    opt = adamw_init(model)
    sync(dev)
    out = dict(mesh=tuple(mesh.mesh.shape), build_s=time.perf_counter() - t0)
    step = make_train_step(cfg, mesh=mesh, **STEP_KW)
    registry.reset_launch_counts()
    opt, m = step(model, opt, batch, 0)
    out["launches"] = registry.launch_counts()
    out["loss0"], out["grad_norm0"] = float(m["loss"]), float(m["grad_norm"])
    sample = sample_params(model, cfg.n_layers)
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(1, run["timed"] + 1):
        opt, m = step(model, opt, batch, i)
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / run["timed"]
    out["loss"] = float(m["loss"])
    tokens = run["batch"] * run["seq"]
    flops = model_flops(cfg, ShapeSpec("train_cut", run["seq"], run["batch"], "train"))
    out["tokens_per_s"] = tokens / out["step_s"]
    out["mfu"] = flops / out["step_s"] / (WORLD * HW().peak_flops)
    i = run["timed"] + 1
    if cuda and rank == 0:
        (opt, m), wall, busy, nccl, top = profile_step(lambda: step(model, opt, batch, i))
        out["profile"] = dict(wall_ms=wall, busy_ms=busy, nccl_ms=nccl, top=top)
        if busy is not None:
            out["profile"]["idle"] = 1 - busy / wall
    else:
        opt, m = step(model, opt, batch, i)
    cost = OpCost()
    with CommDebugMode() as comm, cost:
        opt, m = step(model, opt, batch, i + 1)
    sync(dev)
    out["collectives"] = collective_bytes(cost.records)
    out["comm_counts"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["flops_counted"] = cost.flops
    if cuda and rank == 0:
        out["nccl"] = recorded_collectives(lambda: step(model, opt, batch, i + 2))
    else:
        step(model, opt, batch, i + 2)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    out["peak_gb"] = [p / 1e9 for p in peaks]
    del model, opt, m
    return out, sample


def recorded_collectives(run) -> dict:
    """``run()`` profiled with its ops' shapes, the trace read by
    ``nccl_bytes``; where the profiler fails, why."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="sharded_cards_trace_") as d:
        path = os.path.join(d, "trace.json")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                run()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            return nccl_bytes(path)
        except Exception as e:  # the profiler's own failure
            return dict(error=f"{type(e).__name__}: {e}")


def exact(cfg, mesh, dev, rank, small: bool) -> list:
    """The 8-layer model, each of EXACT_CASES: one step unsharded on rank
    0's card (one microbatch a sequence), then one step sharded over
    ``mesh``; their metrics and ``same_params`` of the sample."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step, shard_model
    from repro_torch.optim import adamw_init

    results = []
    for batch_n, seq, micro in EXACT_CASES:
        if small:
            batch_n, seq = batch_n, SMALL_RUN["seq"]
        batch = make_batch(cfg, dev, batch_n, seq)
        out = dict(batch=batch_n, seq=seq, microbatch=micro)
        one = None
        if rank == 0:
            model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
            opt = adamw_init(model)
            _, m = make_train_step(cfg, microbatch=batch_n, **STEP_KW)(model, opt, batch, 0)
            out["one_card"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            one = sample_params(model, cfg.n_layers)
            del model, opt, m
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
        model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        shard_model(model, mesh)
        opt = adamw_init(model)
        _, m = make_train_step(cfg, mesh=mesh, microbatch=micro, **STEP_KW)(model, opt, batch,
                                                                             0)
        out["mesh"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        got = sample_params(model, cfg.n_layers)
        if rank == 0:
            out["params"] = same_params(got, one)
        del model, opt, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        results.append(out)
    return results


def tp_exact(cfg, dev, rank, world, small: bool) -> dict:
    """TP32: one step on each of MESHES; on rank 0, (2, 2) against (4, 1)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import lm
    from repro_torch.models.steps import make_train_step, shard_model
    from repro_torch.optim import adamw_init

    batch = make_batch(cfg, dev, TP32["batch"], SMALL_RUN["seq"] if small else TP32["seq"])
    got = {}
    for shape in MESHES:
        mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
        model = lm.LM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        shard_model(model, mesh)
        opt = adamw_init(model)
        _, m = make_train_step(cfg, mesh=mesh, **STEP_KW)(model, opt, batch, 0)
        got[shape] = (dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])),
                      sample_params(model, cfg.n_layers),
                      sample_params(model, cfg.n_layers, opt["mu"]))
        del model, opt, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rank:
        return {}
    (ma, pa, mua), (mb, pb, mub) = got[MESHES[0]], got[MESHES[1]]
    rel = {k: abs(mb[k] - ma[k]) / abs(ma[k]) for k in ("loss", "grad_norm")}
    return {str(MESHES[0]): ma, str(MESHES[1]): mb, "relative": rel,
            "mu": relative_gap(mub, mua), "params": same_params(pb, pa)}


def make_batch(cfg, dev, batch_n: int, seq: int) -> dict:
    """A seeded batch of token ids, the labels its shift (the same on
    every rank)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch_n, seq), generator=gen, device=dev)
    return dict(tokens=tokens, labels=tokens.roll(-1, dims=1))


def worker(rank: int, world: int, init_file: str, tmp: str, small: bool) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if small:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(2)
    else:
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank, **({} if small else dict(device_id=dev)))
    try:
        run = SMALL_RUN if small else FULL
        cfg = config(small)
        batch = make_batch(cfg, dev, run["batch"], run["seq"])
        results = dict(exact=exact(config(small, **({} if small else EXACT)),
                                   init_device_mesh(dev.type, (world, 1),
                                                    mesh_dim_names=("data", "model")),
                                   dev, rank, small))
        tp = {k: v for k, v in TP32.items() if k in ("n_layers", "dtype")}
        results["tp32"] = tp_exact(config(small, **tp), dev, rank, world, small)
        samples = {}
        for shape in MESHES:
            mesh = init_device_mesh(dev.type, shape, mesh_dim_names=("data", "model"))
            results[str(shape)], samples[shape] = one_cell(cfg, mesh, dev, batch, run, rank)
        if rank == 0:
            results["params_vs_4x1"] = same_params(samples[MESHES[1]], samples[MESHES[0]])
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def dryruns(small: bool, tmp: str) -> list:
    """``launch.dryrun`` of each mesh at the run's shape, in child processes."""
    run = SMALL_RUN if small else FULL
    procs = []
    for data, model in MESHES:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--shape",
               "train_4k", "--mesh", f"data={data},model={model}", "--batch", str(run["batch"]),
               "--seq", str(run["seq"]),
               "--out", os.path.join(tmp, "dryrun")]
        if small:
            cmd += [x for k, v in SMALL.items() for x in ("--set", f"{k}={v}")]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
    return procs


def check_params(what: str, p: dict, share: float = SAME_SHARE) -> list:
    if p["share_equal"] >= share and p["over"] == 0:
        return []
    return [f"{what}: parameters {p} (bit-equal share {share} needed, none over)"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    small = args.device == "cpu"
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.multiprocessing as mp

    if small:
        card = "cpu rehearsal (gloo), not a card"
    else:
        if torch.cuda.device_count() < WORLD:
            print(f"sharded_cards: needs {WORLD} CUDA devices", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    say(card)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sharded_cards_") as tmp:
        procs = dryruns(small, tmp)
        try:
            if not small:
                from repro_torch.kernels import _build

                t0 = time.perf_counter()
                _build.build_all(["flash_attention", "flash_attention_bwd"])
                say(f"build: flash_attention and its backward in {time.perf_counter() - t0:.1f} s")
            mp.spawn(worker, args=(WORLD, os.path.join(tmp, "pg"), tmp, small), nprocs=WORLD,
                     join=True)
            for p in procs:
                _, err = p.communicate(timeout=900)
                if p.returncode:
                    raise SystemExit(f"FAILED: dry run exited {p.returncode}: {err[-2000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
        dry = {}
        for data, model in MESHES:
            name = f"{ARCH}__train_4k__{data}x{model}.json"
            with open(os.path.join(tmp, "dryrun", name)) as f:
                dry[str((data, model))] = json.load(f)

    run = SMALL_RUN if small else FULL
    failed = []
    for ex in res["exact"]:
        one, mesh = ex["one_card"], ex["mesh"]
        rel = {k: abs(mesh[k] - one[k]) / abs(one[k]) for k in ("loss", "grad_norm")}
        ex["relative"] = rel
        say(f"exact: {ARCH} {EXACT['n_layers'] if not small else SMALL['n_layers']} layers "
            f"bf16, {ex['batch']} x {ex['seq']}, microbatches a rank {ex['microbatch']}: (4, 1) "
            f"mesh loss {mesh['loss']:.6f} grad_norm {mesh['grad_norm']:.6f}; one card loss "
            f"{one['loss']:.6f} grad_norm {one['grad_norm']:.6f}; relative differences {rel} "
            f"(limits {EXACT_TOL}); parameters after the step {ex['params']} [{card}]")
        failed += [f"exact {ex['batch']} x {ex['seq']}: {k}" for k in rel
                   if not rel[k] <= EXACT_TOL[k]]
        failed += check_params(f"exact {ex['batch']} x {ex['seq']}", ex["params"])
    a, b = res[str(MESHES[0])], res[str(MESHES[1])]
    rel = {k: abs(b[f"{k}0"] - a[f"{k}0"]) / abs(a[f"{k}0"]) for k in ("loss", "grad_norm")}
    res["rel_vs_4x1"] = rel
    say(f"{MESHES[1]} against {MESHES[0]}, the first step: loss {b['loss0']:.6f} vs "
        f"{a['loss0']:.6f}, grad_norm {b['grad_norm0']:.6f} vs {a['grad_norm0']:.6f}, relative "
        f"{rel} (limits {MESH_TOL}); parameters after it {res['params_vs_4x1']} [{card}]")
    failed += [f"{MESHES[1]} vs {MESHES[0]}: {k}" for k in rel if not rel[k] <= MESH_TOL[k]]
    failed += check_params(f"{MESHES[1]} vs {MESHES[0]}", res["params_vs_4x1"], SAME_SHARE_TP)
    tp = res["tp32"]
    seen = dict(tp["relative"], mu=tp["mu"], flipped=tp["params"]["share_flipped"])
    say(f"tensor parallelism in float32 ({TP32['n_layers']} layers, full width, "
        f"{TP32['batch']} x {TP32['seq'] if not small else SMALL_RUN['seq']}): {MESHES[1]} "
        f"{tp[str(MESHES[1])]} against {MESHES[0]} {tp[str(MESHES[0])]}; gaps {seen} (limits "
        f"{TP32_TOL}); parameters {tp['params']} [{card}]")
    failed += [f"tp32: {k} {seen[k]}" for k in TP32_TOL if not seen[k] <= TP32_TOL[k]]
    for shape in MESHES:
        r, d = res[str(shape)], dry[str(shape)]
        if d["status"] != "ok":
            failed.append(f"dry run {shape}: {d.get('error')}")
            continue
        pred = d["memory"]["total_bytes"] / 1e9
        say(f"{ARCH} whole ({'small' if small else '40 layers'}) on a {shape} mesh, "
            f"{run['batch']} x {run['seq']}: {r['step_s'] * 1e3:.1f} ms a step, "
            f"{r['tokens_per_s']:.0f} tokens/s, model-FLOPs share {r['mfu']:.3f} of "
            f"{WORLD} x 989 TFLOP/s; loss {r['loss0']:.4f} -> {r['loss']:.4f}; launches a step "
            f"{r['launches']}; model on the cards in {r['build_s']:.1f} s [{card}]")
        prof = r.get("profile", {})
        if prof.get("busy_ms") is not None:
            say(f"  profiled step (rank 0): {prof['wall_ms']:.1f} ms wall, the card busy "
                f"{prof['busy_ms']:.1f} ms (idle share {prof['idle']:.3f}), NCCL "
                f"{prof['nccl_ms']:.1f} ms of it; busiest (summed) {prof['top']}")
        elif prof:
            say(f"  profiled step (rank 0): {prof['wall_ms']:.1f} ms wall, device time not "
                f"measured ({prof['top']})")
        say(f"  peak memory per card {[round(x, 2) for x in r['peak_gb']]} GB; dry run's "
            f"per-device prediction {pred:.2f} GB (parameters "
            f"{d['memory']['param_bytes'] / 1e9:.2f}, gradients {d['memory']['grad_bytes'] / 1e9:.2f}"
            f", optimizer {d['memory']['optimizer_bytes'] / 1e9:.2f}, step peak "
            f"{d['memory']['temp_bytes'] / 1e9:.2f})")
        say(f"  collective bytes a step (rank 0, OpCost): {json.dumps(r['collectives']['per_kind'])} "
            f"counts {json.dumps(r['collectives']['counts'])}; CommDebugMode counts "
            f"{json.dumps(r['comm_counts'])}; dry run {json.dumps(d['collectives']['per_kind'])} "
            f"counts {json.dumps(d['collectives']['counts'])} (both counted at dispatch by "
            f"OpCost); FLOPs counted on rank 0 {r['flops_counted']:.4e}, dry run "
            f"{d['roofline']['hlo_flops_per_chip']:.4e}")
        if "nccl" in r:
            say(f"  collectives as the process group recorded them for NCCL (rank 0, by event): "
                f"{json.dumps(r['nccl'])}")
        if not small and not (r["launches"]["flash_attention"] > 0
                              and r["launches"]["flash_attention_bwd"] > 0):
            failed.append(f"{shape}: no kernel launch {r['launches']}")
    say(f"sharded_cards: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(dict(card=card, cells=res, dryrun={
        k: dict(memory=v.get("memory"), collectives=v.get("collectives"),
                roofline=v.get("roofline")) for k, v in dry.items()})))
    if failed and small:
        say(f"cpu rehearsal: the limits are set by the cards' run at full width and are not "
            f"held here: {failed}")
    elif failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
