#!/usr/bin/env python3
"""Where a streamed PageRank iteration's time goes: one device against the mesh.

On ``chip_smoke.py``'s PageRank store (rmat scale 20, p=512, tile_dim 512,
full width) under phase stream's quarter budget (per shard under the
mesh), PageRank hybrid is planned twice: on cuda:0 alone, and under
``DeviceMesh.cuda(n)`` over every card (two shards on cuda:0 when there is
one card).  Each plan runs once to calibrate, then once more, traced, with
every iteration overlapped.  For each plan the script prints:

* **host assembly**: every wave's slab rebuilt on the main thread by
  ``_assemble_runtime`` (the staging worker's body: under the mesh one
  call gathers every shard's slab), ms per wave and per iteration and the
  gather rate in GB/s;
* **the traced iterations**, per iteration: the plan's own spans
  (``repro_torch.obs``; ``assemble`` on the staging lane, ``device_put``,
  ``compute`` and ``collective`` on the main thread, ``iteration``) summed
  on the host clock, the staging stall, and from ``torch.profiler`` each
  card's device time (kernels and copies) under each span: host-to-device
  copies under ``device_put``, the shards' kernels under ``compute``, the
  fold's kernels and peer copies under ``collective``.

The last line is one JSON object with every number printed; it is also
written to ``chiprun_out/mesh_trace.json``.  Run from the repository root::

    python tools/mesh_trace.py                 # the cards (needs one or more)
    python tools/mesh_trace.py --device cpu --scale 12 --p 32 --tile-dim 128
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPANS = ("assemble", "device_put", "compute", "collective")
ITERS = 3


def say(*parts) -> None:
    print(*parts, flush=True)


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def host_assembly(plan) -> dict:
    """Every wave's slab rebuilt once on this thread, buffers returned."""
    per_wave, nbytes = [], 0
    for r in plan._slabs:
        t0 = time.perf_counter()
        slab = plan._assemble_runtime(r)
        per_wave.append((time.perf_counter() - t0) * 1e3)
        nbytes += r.staged_bytes
        plan._arena.give(*slab.arena_arrays)
    total = sum(per_wave)
    return dict(ms_per_wave=per_wave, ms_per_iteration=total, gb=nbytes / 1e9,
                gb_per_s=nbytes / 1e9 / (total / 1e3) if total else float("nan"))


def device_split(prof) -> dict:
    """{device index: {span: device ms}} for the kernels and copies issued
    under each span (``other`` for the rest), from the profiler's events."""
    out: dict = defaultdict(lambda: defaultdict(float))
    seen = set()

    def add(ev, label):
        for i, k in enumerate(ev.kernels):
            if (id(ev), i) not in seen:
                seen.add((id(ev), i))
                out[k.device][label] += k.duration / 1e3

    def walk(ev, label):
        add(ev, label)
        for c in ev.cpu_children:
            walk(c, label)

    events = prof.events()
    for ev in events:
        if ev.name in SPANS:
            walk(ev, ev.name)
    for ev in events:
        add(ev, "other")
    return {int(d): dict(v) for d, v in out.items()}


def traced_run(plan, devices) -> tuple:
    """One calibrated run under the tracer and the profiler:
    (result, host spans {name: ms}, device split or the profiler's error)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    with obs.tracing(torch_annotations=True) as tr:
        try:
            prof.start()
        except Exception as e:  # the profiler's own failure: spans only
            prof, why = None, f"{type(e).__name__}: {e}"
        res = plan.run()
        sync(devices)
        spans = defaultdict(float)
        for ev in tr.events():
            spans[ev.name] += ev.dur_ns / 1e6
    if prof is None:
        return res, dict(spans), why
    try:
        prof.stop()
        split = device_split(prof)
    except Exception as e:  # the profiler's own failure
        return res, dict(spans), f"{type(e).__name__}: {e}"
    return res, dict(spans), split


def one(name, store, budget, kw, mesh, dev, card) -> dict:
    import torch

    from repro_torch.algorithms import pagerank_algorithm
    from repro_torch.core import compile_plan

    devices = list(mesh.distinct) if mesh is not None else [dev]
    t0 = time.perf_counter()
    where = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    plan = compile_plan(pagerank_algorithm(max_iters=ITERS), store, memory_budget=budget,
                        share=False, host_fraction=None, **where, **kw)
    planning = time.perf_counter() - t0
    plan.run()                      # calibration, then overlapped iterations
    asm = host_assembly(plan)
    res, spans, split = traced_run(plan, devices)
    st = res.schedule_stats["streaming"]
    n = res.iterations
    per_it = {k: v / n for k, v in spans.items()}
    shards = mesh.size if mesh is not None else 1
    say(f"{name}: {shards} shard(s) on {len(devices)} card(s), {plan.num_waves} waves "
        f"(planning {planning:.1f} s), {sum(st["bytes_per_wave"]) / 1e9:.3f} GB staged per "
        f"iteration [{card}]")
    say(f"{name} host assembly (main thread, every shard of a wave in one call): "
        f"{asm['ms_per_iteration']:.1f} ms per iteration for {asm['gb']:.3f} GB "
        f"({asm['gb_per_s']:.2f} GB/s), waves {[round(x, 1) for x in asm['ms_per_wave']]} ms")
    say(f"{name} traced: {n} iterations in {res.seconds * 1e3:.1f} ms "
        f"({res.seconds * 1e3 / n:.1f} ms per iteration, all overlapped: "
        f"{st['overlapped_iterations']}); per iteration on the host clock: "
        + ", ".join(f"{k} {per_it.get(k, 0.0):.1f} ms" for k in (*SPANS, "iteration"))
        + f"; staging stall {st['stall_seconds'] * 1e3 / n:.1f} ms")
    if isinstance(split, str):
        say(f"{name} device split: the profiler failed ({split})")
    else:
        for d, v in sorted(split.items()):
            say(f"{name} device {d} per iteration: "
                + ", ".join(f"{k} {ms / n:.2f} ms" for k, ms in sorted(v.items()))
                + f"; busy {sum(v.values()) / n:.2f} ms")
    out = dict(shards=shards, cards=len(devices), waves=plan.num_waves, planning_s=planning,
               staged_gb_per_iteration=sum(st["bytes_per_wave"]) / 1e9,
               host_assembly=asm, iterations=n, ms_per_iteration=res.seconds * 1e3 / n,
               spans_ms_per_iteration=per_it, stall_ms_per_iteration=st["stall_seconds"] * 1e3 / n,
               device_ms_per_iteration=(split if isinstance(split, str) else
                                        {d: {k: ms / n for k, ms in v.items()}
                                         for d, v in split.items()}),
               collective_folds=st.get("collective_folds", 0))
    plan.close()
    del plan
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--p", type=int, default=None)
    ap.add_argument("--tile-dim", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.algorithms import pagerank_algorithm
    from repro_torch.core import (DeviceMesh, build_block_store, build_schedule,
                                  degree_order, rmat)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_trace: no CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        card = "; ".join(smi.stdout.strip().splitlines())
        _build.build_all(["spmv_tiles"])
        dev = torch.device("cuda", 0)
        n = torch.cuda.device_count()
        mesh = DeviceMesh.cuda(n) if n >= 2 else DeviceMesh(["cuda:0"] * cs.MESH_SHARDS)
    else:
        card = "host CPU"
        dev = torch.device("cpu")
        mesh = DeviceMesh(["cpu"] * cs.MESH_SHARDS)
    say(card)
    cfg = dict(cs.PAGERANK)
    for k, v in (("scale", args.scale), ("p", args.p), ("tile_dim", args.tile_dim)):
        if v is not None:
            cfg[k] = v
    t0 = time.perf_counter()
    g, _ = degree_order(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]),
                        ascending=False)
    store = build_block_store(g, cfg["p"])
    kw = dict(tile_dim=cfg["tile_dim"], dense_density=cfg["dense_density"])
    schedule = build_schedule(pagerank_algorithm(), store, **kw)
    budget = cs.quarter_budget(pagerank_algorithm(), store, schedule, cs.STREAM_SPLIT)
    say(f"graph + store + schedule {time.perf_counter() - t0:.1f} s, n {g.n}, arcs {g.m}, "
        f"budget {budget / 1e9:.3f} GB (per shard under the mesh)")
    out = dict(card=card, config=cfg, budget_bytes=budget, mesh_devices=repr(mesh))
    out["single"] = one("single", store, budget, kw, None, dev, card)
    out["mesh"] = one("mesh", store, budget, kw, mesh, dev, card)
    text = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "mesh_trace.json").write_text(text)
    say(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
