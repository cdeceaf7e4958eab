#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Builds the three CUDA tile kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version, and drives the port's main path
through ``compile_plan(...).run()`` at full configuration:

1. kernels vs plain versions on the card, at the main path's shapes and
   at a ragged one (T=192, odd batch);
2. PageRank on ``degree_order(rmat(20, 16, seed=7), ascending=False)``
   (the Graph500 Kronecker generator, A=.57 B=.19 C=.19, edge factor
   16; scale cut from Graph500's ≥26 for host build time), p=512,
   tile_dim=512, dense_density=0.005, against a float64 scipy power
   iteration of the same formula;
3. BFS push, pull and auto on the same store from the vertex of highest
   degree, against ``scipy.sparse.csgraph`` distances;
4. triangle counting on ``orient_dag(rmat(16, 16, seed=7))``, p=256,
   tile_dim=512, dense_density=0.001, against an exact scipy count.

Each phase resets the kernels' launch counts just before it drives the
main path and reads them just after.  Then each kernel is timed on the
inputs that phase gave it (CUDA events), beside its plain version, a
one-call PyTorch yardstick where there is one, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its float32 operations
over 67 TFLOP/s (H100 SXM data sheet).  Any failed check exits non-zero.

Output: the card's name and power limit, the build time, one or more
lines per phase, a JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``.  Run from the repository root::

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM: 80 GB HBM3 at 3.35 TB/s
F32_FLOPS = 67e12              # H100 SXM: float32 outside the tensor cores
INT_MAX = 2**31 - 1

PAGERANK = dict(scale=20, edge_factor=16, seed=7, p=512, tile_dim=512, dense_density=0.005)
TC = dict(scale=16, edge_factor=16, seed=7, p=256, tile_dim=512, dense_density=0.001)
#: phase 1 shapes: PageRank's (nd, T), TC's (nd, B, T), and ragged ones
SPMV_SHAPES = ((4128, 512), (33, 192))
TC_SHAPES = ((3199, 9670, 512), (33, 77, 192))
PAGERANK_L1_TOL = 1e-5         # float32 ranks vs float64, same iteration count
SPMV_RTOL, SPMV_ATOL = 1e-5, 1e-6   # float32 sums in another order

SOURCES = {
    "spmv_tiles": ("src/repro_torch/csrc/spmv_tiles.cu", "src/repro/kernels/spmv_tile.py:32"),
    "frontier_tiles": ("src/repro_torch/csrc/frontier_tiles.cu",
                       "src/repro/kernels/frontier_tile.py:48"),
    "tc_tiles": ("src/repro_torch/csrc/tc_tiles.cu", "src/repro/kernels/tc_tile.py:48"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def record(name, launches, err, ms, plain_ms, nbytes, ops, library_ms):
    bound_ms, bound_by = bound(nbytes, ops)
    source, replaces = SOURCES[name]
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=int(launches), max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    say(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
        f"{bound_ms:.4f} ms ({bound_by}), launches {launches}, max_abs_err {err}")
    return rec


def device_profile(run):
    """Run ``run()`` under torch.profiler: (result, wall ms, device-busy
    ms, [(kernel, ms)] for the five busiest kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
    return out, wall, busy, [(e.key[:60], e.self_device_time_total / 1e3) for e in top]


def phase_kernels(dev, gen) -> None:
    """Each kernel against its plain version at the main path's shapes
    (PageRank's 4128 tiles, TC's 9670 triples over 3199 tiles) and at a
    ragged T=192 with an odd batch."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda
    from repro_torch.kernels.tc_tiles import tc_tiles_cuda

    def tiles_of(nd, t):
        return (torch.rand((nd, t, t), generator=gen, device=dev) < 0.01).float()

    for nd, t in SPMV_SHAPES:
        tiles = tiles_of(nd, t)
        xs = torch.rand((nd, t), generator=gen, device=dev)
        got, want = spmv_tiles_cuda(tiles, xs), ref.spmv_tiles_ref(tiles, xs)
        check(torch.allclose(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL),
              f"spmv_tiles ({nd},{t}) vs plain: max err {float((got - want).abs().max())}")
        f = torch.rand((nd, t), generator=gen, device=dev) < 0.3
        check(torch.equal(frontier_tiles_cuda(tiles, f), ref.frontier_tiles_ref(tiles, f)),
              f"frontier_tiles ({nd},{t}) vs plain")
        empty = frontier_tiles_cuda(tiles, torch.zeros_like(f))
        check(bool((empty == INT_MAX).all()), f"frontier_tiles ({nd},{t}) empty frontier")
        say(f"phase kernels: spmv_tiles, frontier_tiles ok at nd={nd} T={t}")
        del tiles, xs, f, got, want, empty
    for nd, nb, t in TC_SHAPES:
        tiles = tiles_of(nd, t)
        idx = torch.randint(0, nd, (nb, 3), generator=gen, device=dev, dtype=torch.int32)
        idx[::13] = -1                                  # masked padding triples
        got, want = int(tc_tiles_cuda(tiles, idx)), int(ref.tc_tiles_idx_ref(tiles, idx))
        check(got == want, f"tc_tiles ({nd},{nb},{t}): kernel {got} vs plain {want}")
        say(f"phase kernels: tc_tiles ok at nd={nd} B={nb} T={t} (count {got})")
        del tiles, idx
    torch.cuda.empty_cache()


def csr_matrix(g):
    import scipy.sparse as sp

    return sp.csr_matrix((np.ones(g.m, np.float64), g.indices, g.indptr), shape=(g.n, g.n))


def tile_fill(store) -> float:
    """Share of the materialized tiles' T² entries that lie inside their
    blocks (the rest is padding up to tile_dim)."""
    w = np.diff(store.layout.cuts)
    i, j = np.divmod(store.tile_block_ids.astype(np.int64), store.p)
    return float((w[i] * w[j]).sum() / (store.tile_block_ids.size * store.tile_dim ** 2))


def phase_pagerank(dev, store):
    import torch
    from repro_torch.algorithms import pagerank_algorithm
    from repro_torch.core import compile_plan
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.spmv_tiles import spmv_tiles_cuda

    cfg = PAGERANK
    t0 = time.perf_counter()
    plan = compile_plan(pagerank_algorithm(), store, device=dev, tile_dim=cfg["tile_dim"],
                        dense_density=cfg["dense_density"])
    st = plan.schedule.stats
    nd, t = plan.context.tiles.shape[0], cfg["tile_dim"]
    say(f"phase pagerank: schedule + device copy {time.perf_counter() - t0:.1f} s, "
        f"tasks {st['num_tasks']}, dense tasks {st['dense_tasks']}, tiles {nd} "
        f"({nd * t * t * 4 / 1e9:.2f} GB f32, {tile_fill(store):.3f} inside the blocks), "
        f"dense weight {st['dense_weight_frac']:.3f}")
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    check(launches["spmv_tiles"] == res.iterations,
          f"spmv_tiles launches {launches['spmv_tiles']} != iterations {res.iterations}")
    say(f"phase pagerank: {res.iterations} iterations in {res.seconds * 1e3:.1f} ms "
        f"({res.seconds * 1e3 / res.iterations:.2f} ms per iteration, host clock), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
        f"launches {launches}")

    # the same formula in float64 for the same number of iterations
    g = store.graph
    at = csr_matrix(g).T.tocsr()
    deg = g.degrees
    inv = 1.0 / np.maximum(deg, 1)
    dangling = deg == 0
    x = np.full(g.n, 1.0 / g.n)
    for _ in range(res.iterations):
        x = 0.15 / g.n + 0.85 * (at @ (x * inv) + x[dangling].sum() / g.n)
    l1 = float(np.abs(res.result.astype(np.float64) - x).sum())
    check(bool(np.isfinite(res.result).all()) and res.result.shape == (g.n,),
          "pagerank result shape/finite")
    check(l1 <= PAGERANK_L1_TOL, f"pagerank L1 distance to float64 {l1} > {PAGERANK_L1_TOL}")
    say(f"phase pagerank: L1 distance to float64 scipy {l1:.3e} (limit {PAGERANK_L1_TOL}), "
        f"rank sum {float(res.result.sum()):.6f}")

    try:
        _, wall, busy, top = device_profile(plan.run)
        say(f"phase pagerank: profiled run {wall:.1f} ms wall, device busy {busy:.1f} ms "
            f"({busy / res.iterations:.3f} ms per iteration, idle share "
            f"{1 - busy / wall:.3f}); busiest kernels {top}")
    except Exception as e:  # a measurement only; the checks above decide the phase
        say(f"phase pagerank: device time not measured ({type(e).__name__}: {e})")

    # time the kernel on the inputs the last iteration gave it
    ctx = plan.context
    contrib = res.state["rank"] * ctx.extras["inv_deg"]
    cols = torch.arange(t, device=dev)
    xs = torch.cat([contrib, contrib.new_zeros(t)])[ctx.tile_row_start[:, None] + cols]
    tiles = ctx.tiles
    got, want = spmv_tiles_cuda(tiles, xs), ref.spmv_tiles_ref(tiles, xs)
    check(torch.allclose(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL), "spmv_tiles main-path inputs")
    rec = record(
        "spmv_tiles", launches["spmv_tiles"], float((got - want).abs().max()),
        cuda_ms(lambda: spmv_tiles_cuda(tiles, xs), 20),
        cuda_ms(lambda: ref.spmv_tiles_ref(tiles, xs), 3),
        nd * t * t * 4 + 2 * nd * t * 4, 2.0 * nd * t * t,
        cuda_ms(lambda: torch.einsum("brc,br->bc", tiles, xs), 5))
    return plan, rec


def phase_bfs(dev, store, schedule):
    import scipy.sparse.csgraph as csgraph
    import torch
    from repro_torch.algorithms import bfs_algorithm
    from repro_torch.core import compile_plan
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.frontier_tiles import frontier_tiles_cuda

    g = store.graph
    src = int(np.argmax(store.degrees))
    registry.reset_launch_counts()
    plans = {d: compile_plan(bfs_algorithm(src), store, schedule, device=dev, direction=d)
             for d in ("push", "pull", "auto")}
    runs = {d: plan.run() for d, plan in plans.items()}
    launches = registry.launch_counts()
    for d, r in runs.items():
        say(f"phase bfs: {d} {r.iterations} levels in {r.seconds * 1e3:.1f} ms, "
            f"decisions {r.schedule_stats['direction']['decisions']}")
    check(launches["frontier_tiles"] > 0, "frontier_tiles never launched on the BFS path")
    decisions = runs["auto"].schedule_stats["direction"]["decisions"]
    check("pull" in decisions, "auto BFS took no pull iteration")

    dist, parent = runs["push"].result["dist"], runs["push"].result["parent"]
    for d in ("pull", "auto"):
        check(np.array_equal(runs[d].result["dist"], dist)
              and np.array_equal(runs[d].result["parent"], parent), f"bfs {d} != push")
    want = csgraph.shortest_path(csr_matrix(g), method="D", unweighted=True, indices=src)
    want = np.where(np.isinf(want), INT_MAX, want).astype(np.int64)
    check(np.array_equal(dist.astype(np.int64), want), "bfs dist != scipy distances")
    v = np.flatnonzero((dist > 0) & (dist != INT_MAX))
    pv = parent[v].astype(np.int64)
    keys = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees) * g.n + g.indices
    pos = np.searchsorted(keys, pv * g.n + v).clip(max=keys.size - 1)
    check(bool((keys[pos] == pv * g.n + v).all()), "a bfs parent is not a neighbour")
    check(bool((dist[pv] == dist[v] - 1).all()), "a bfs parent is not one level closer")
    say(f"phase bfs: dist equals scipy on {int((dist != INT_MAX).sum())} reached vertices, "
        f"parents valid, directions agree, launches {launches}")

    # time the kernel on the largest frontier a pull level probed
    pulls = [it for it, d in enumerate(decisions) if d == "pull"]
    level = max(pulls, key=lambda it: int((dist == it).sum()))
    ctx = plans["auto"].context
    t = ctx.tile_dim
    frontier = torch.from_numpy(dist == level).to(dev)
    cols = torch.arange(t, device=dev)
    fcols = torch.cat([frontier, frontier.new_zeros(t)])[ctx.tile_col_start[:, None] + cols]
    tiles = ctx.tiles
    got, want = frontier_tiles_cuda(tiles, fcols), ref.frontier_tiles_ref(tiles, fcols)
    check(torch.equal(got, want), "frontier_tiles main-path inputs")
    nd = tiles.shape[0]
    # elements this frontier needs: each row's frontier columns up to its
    # first hit, all of them when the row has none
    seen = fcols.long().cumsum(dim=1)
    needed = torch.where(want == INT_MAX, seen[:, -1:],
                         seen.gather(1, want.clamp_max(t - 1).long())).sum().item()
    rec = record(
        "frontier_tiles", launches["frontier_tiles"],
        float((got.long() - want.long()).abs().max()),
        cuda_ms(lambda: frontier_tiles_cuda(tiles, fcols), 20),
        cuda_ms(lambda: ref.frontier_tiles_ref(tiles, fcols), 3),
        needed * 4 + nd * t * (1 + 4), float(needed), None)
    say(f"  frontier_tiles timed on level {level}: frontier {int(frontier.sum())} vertices")
    return rec


def phase_tc(dev):
    import scipy.sparse as sp
    import torch
    from repro_torch.algorithms import tc_algorithm
    from repro_torch.algorithms.tc import orient_dag
    from repro_torch.core import build_block_store, compile_plan, rmat
    from repro_torch.kernels import ref, registry
    from repro_torch.kernels.tc_tiles import tc_tiles_cuda

    cfg = TC
    t0 = time.perf_counter()
    dag = orient_dag(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]))
    store = build_block_store(dag, cfg["p"])
    plan = compile_plan(tc_algorithm(), store, device=dev, tile_dim=cfg["tile_dim"],
                        dense_density=cfg["dense_density"])
    idx, tiles = plan.context.extras["tc_tiles_idx"], plan.context.tiles
    st = plan.schedule.stats
    say(f"phase tc: host build {time.perf_counter() - t0:.1f} s, n {dag.n}, arcs {dag.m}, "
        f"triples {st['num_tasks']}, dense triples {idx.shape[0]} over {tiles.shape[0]} tiles "
        f"({tile_fill(store):.3f} inside the blocks)")
    registry.reset_launch_counts()
    res = plan.run()
    launches = registry.launch_counts()
    check(launches["tc_tiles"] > 0, "tc_tiles never launched on the TC path")
    a = sp.csr_matrix((np.ones(dag.m, np.int64), dag.indices, dag.indptr), shape=(dag.n, dag.n))
    want = int((a @ a).multiply(a).sum())
    check(res.result == want, f"triangle count {res.result} != scipy {want}")
    say(f"phase tc: {res.result} triangles in {res.seconds * 1e3:.1f} ms (scipy {want}), "
        f"launches {launches}")

    got, plain = int(tc_tiles_cuda(tiles, idx)), int(ref.tc_tiles_idx_ref(tiles, idx))
    check(got == plain, f"tc_tiles main-path inputs: kernel {got} vs plain {plain}")
    nd, t = tiles.shape[0], tiles.shape[1]
    nnz_ij = float(tiles.sum(dim=(1, 2))[idx[:, 0].long()].sum())

    def library():
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(0, idx.shape[0], ref.CHUNK):
            rows = idx[s:s + ref.CHUNK].long()
            w = torch.einsum("brc,bsc->brs", tiles[rows[:, 1]], tiles[rows[:, 2]])
            total += (w * tiles[rows[:, 0]]).sum()
        return total

    rec = record(
        "tc_tiles", launches["tc_tiles"], abs(got - plain),
        cuda_ms(lambda: tc_tiles_cuda(tiles, idx), 5),
        cuda_ms(lambda: ref.tc_tiles_idx_ref(tiles, idx), 2),
        nd * t * t * 4 + idx.numel() * 4 + 8, 2.0 * t * nnz_ij,
        cuda_ms(library, 2))
    say(f"  tc_tiles: dense-path count {got} of {res.result}")
    return rec


def run(dev) -> list[dict]:
    """The four phases in order; returns the per-kernel records."""
    import torch
    from repro_torch.core import build_block_store, degree_order, rmat

    phase_kernels(dev, torch.Generator(device=dev).manual_seed(0))

    cfg = PAGERANK
    t0 = time.perf_counter()
    g, _ = degree_order(rmat(cfg["scale"], cfg["edge_factor"], seed=cfg["seed"]),
                        ascending=False)
    store = build_block_store(g, cfg["p"])
    say(f"phase pagerank: graph + store {time.perf_counter() - t0:.1f} s, n {g.n}, arcs {g.m}")
    plan, spmv = phase_pagerank(dev, store)
    frontier = phase_bfs(dev, store, plan.schedule)
    del plan, store, g
    torch.cuda.empty_cache()
    tc = phase_tc(dev)

    return [spmv, frontier, tc]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all(list(SOURCES))
    say(f"build: {len(SOURCES)} kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    kernels = run(dev)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
